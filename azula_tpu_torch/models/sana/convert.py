r"""Weight conversion from the JAX package's Sana transformer.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(transformer)` yields, as numpy arrays, and
returns the state dict of the port's :class:`SanaTransformer`, whose keys are
the diffusers names of the Sana checkpoints: the renames of
`azula_tpu/models/sana/convert.py` (`RENAMES`) run the other way
(`patch_embed` -> `patch_embed.proj`, `timestep_embedder` ->
`time_embed.emb.timestep_embedder`, `time_linear` -> `time_embed.linear`,
the attentions' `to_out` -> `to_out.0`), RMSNorm `scale` -> `weight`, the
scale-shift tables as they are, Linear and convolution weights to PyTorch's
layouts. A port state dict is therefore a checkpoint-layout state dict,
which the JAX package's `convert_sana_state_dict` loads back.
"""

from __future__ import annotations

__all__ = [
    "from_jax_state_dict",
]

import numpy as np
import re
import torch

from collections.abc import Mapping
from torch import nn

from ..utils import from_jax_arrays

# JAX path prefix -> diffusers prefix, the inverse of the JAX `RENAMES`
_PREFIXES = {
    "patch_embed.": "patch_embed.proj.",
    "timestep_embedder.": "time_embed.emb.timestep_embedder.",
    "time_linear.": "time_embed.linear.",
}


def _rename(key: str) -> str:
    for old, new in _PREFIXES.items():
        if key.startswith(old):
            return new + key.removeprefix(old)
    return re.sub(r"(^|\.)to_out\.", r"\1to_out.0.", key)


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], backbone: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts a JAX Sana transformer state dict to the port's layout.

    Arguments:
        sd: The JAX state dict, as numpy arrays.
        backbone: Optionally, the port's module, to hold the result to.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.
    """

    return from_jax_arrays(sd, backbone, rename=_rename, raw=("scale_shift_table",))
