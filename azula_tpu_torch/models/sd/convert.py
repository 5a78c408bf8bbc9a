r"""Weight conversion from the JAX package's SD UNet.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(unet)` yields, as numpy arrays (keys like
`down_blocks.0.attentions.0.transformer_blocks.0.ff.proj.weight`), and
returns the state dict of the port's :class:`SDUNet`, whose keys are the
diffusers names of the SD `unet/` checkpoints: the inverse of the renames of
`azula_tpu/models/sd/convert.py` (`time_embedding.0` / `.1` ->
`time_embedding.linear_1` / `linear_2`, `ff.proj` -> `ff.net.0.proj`,
`ff.out` -> `ff.net.2`, `to_out` -> `to_out.0`), LayerNorm and GroupNorm
`scale` -> `weight`, Linear and convolution weights to PyTorch's layouts. A
port state dict is therefore a checkpoint-layout state dict, which the JAX
package's `convert_unet_state_dict` loads back.
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

_RENAMES = (
    (re.compile(r"^time_embedding\.(\d)\."), lambda m: f"time_embedding.linear_{int(m[1]) + 1}."),
    (re.compile(r"(^|\.)ff\.proj\."), lambda m: f"{m[1]}ff.net.0.proj."),
    (re.compile(r"(^|\.)ff\.out\."), lambda m: f"{m[1]}ff.net.2."),
    (re.compile(r"(^|\.)to_out\."), lambda m: f"{m[1]}to_out.0."),
)


def _rename(key: str) -> str:
    for pattern, repl in _RENAMES:
        key = pattern.sub(repl, key)
    return key


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], backbone: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts a JAX SD UNet state dict (or one of its blocks') to the
    port's layout.

    Arguments:
        sd: The JAX state dict, as numpy arrays.
        backbone: Optionally, the port's module, to hold the result to.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.
    """

    return from_jax_arrays(sd, backbone, rename=_rename)
