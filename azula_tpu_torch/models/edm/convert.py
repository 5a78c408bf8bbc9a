r"""Weight conversion from the JAX package's EDM backbones.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(module)` yields for a precond wrapper
(keys under `model.`) or a bare UNet, as numpy arrays, and returns the state
dict of the port's module, whose keys are the NVlabs checkpoints': each
convolution's normalized `filter`, :math:`(k_f, k_f)`, becomes its
`resample_filter` buffer, :math:`(1, 1, k_f, k_f)`; the Fourier embedding's
`freqs` is copied as it is; GroupNorm `scale` -> `weight`, Linear and
convolution weights to PyTorch's layouts. A port state dict is therefore a
checkpoint-layout state dict, which the JAX package's
`convert_edm_state_dict` loads back. Reading the NVlabs pickles
(`load_nvlabs_pickle`, `build_from_pickle`) waits with `load_model`.
"""

from __future__ import annotations

__all__ = [
    "from_jax_state_dict",
]

import numpy as np
import torch

from collections.abc import Mapping
from torch import nn

from ..utils import from_jax_arrays


def resample_filters(sd: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    r"""`sd` with each `<conv>.filter`, :math:`(k_f, k_f)`, renamed to the
    checkpoints' `<conv>.resample_filter`, :math:`(1, 1, k_f, k_f)`."""

    out = {}
    for key, value in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf == "filter":
            key, value = f"{prefix}.resample_filter", np.asarray(value)[None, None]
        out[key] = value
    return out


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts a JAX EDM state dict (a precond's, a UNet's or a block's) to
    the port's layout.

    Arguments:
        sd: The JAX state dict, as numpy arrays.
        module: Optionally, the port's module, to hold the result to.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.
    """

    return from_jax_arrays(resample_filters(sd), module, raw=("resample_filter", "freqs"))
