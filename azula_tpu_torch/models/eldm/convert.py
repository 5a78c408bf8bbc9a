r"""Weight conversion from the JAX package's EDM2 backbone.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(module)` yields for an `EDM2Precond`
(keys under `unet.`), a bare `EDM2UNet` or a block, as numpy arrays, and
returns the state dict of the port's module, whose keys are the NVlabs/edm2
checkpoints': `MPConv` weights from :math:`(*k, C_i, C_o)` (or
:math:`(C_i, C_o)`) to :math:`(C_o, C_i, *k)`, and the scalar gains
(`emb_gain`, `out_gain`) and the Fourier buffers (`freqs`, `phases`) copied
as they are. A port state dict is therefore a checkpoint-layout state dict,
which the JAX package's `convert_eldm_state_dict` loads back. Reading the
NVlabs pickles (`build_from_pickle`) waits with `load_model`.
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


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts a JAX EDM2 state dict to the port's layout.

    Arguments:
        sd: The JAX state dict, as numpy arrays.
        module: Optionally, the port's module, to hold the result to.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.
    """

    return from_jax_arrays(sd, module, raw=("emb_gain", "out_gain", "freqs", "phases"))
