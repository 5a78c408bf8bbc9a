r"""Weight conversion from the JAX package's v-diffusion backbones.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(module)` yields for a `VDMUNet`, a
`CC12M1Model` or one of their blocks, as numpy arrays, and returns the
state dict of the port's module, whose keys are the checkpoints': the
Fourier features' `weight` (`timestep_embed.weight`,
`mapping_timestep_embed.weight`, :math:`(C_o / 2, C_i)`) copied as it is,
GroupNorm `scale` -> `weight`, Linear and convolution weights to PyTorch's
layouts. A port state dict is therefore a checkpoint-layout state dict,
which the JAX package's `convert_state_dict` loads back.
"""

from __future__ import annotations

__all__ = [
    "from_jax_state_dict",
]

import numpy as np
import torch

from collections.abc import Mapping
from torch import nn

from ...nn.convert import check_state_dict
from ..utils import from_jax_arrays


def _fourier(key: str) -> bool:
    return key.endswith("timestep_embed.weight")


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts a JAX v-diffusion state dict to the port's layout.

    Arguments:
        sd: The JAX state dict, as numpy arrays.
        module: Optionally, the port's module, to hold the result to.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.
    """

    out = from_jax_arrays({k: v for k, v in sd.items() if not _fourier(k)})
    for key, value in sd.items():
        if _fourier(key):
            out[key] = torch.from_numpy(np.ascontiguousarray(value))

    if module is not None:
        check_state_dict(out, module)

    return out
