r"""Weight conversion from the JAX package's Flux transformer.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(transformer)` yields, as numpy arrays (keys
like `transformer_blocks.0.ff.proj.weight`), and returns the state dict of the
port's :class:`FluxTransformer`, whose keys are the diffusers names of the
FLUX.1 checkpoints: the inverse of the renames of
`azula_tpu/models/flux/convert.py` (`norm_out_linear` -> `norm_out.linear`,
`ff.proj` -> `ff.net.0.proj`, `ff.out` -> `ff.net.2`, `attn.to_out` ->
`attn.to_out.0`), RMSNorm `scale` -> `weight`, and Linear weights from
:math:`(C_i, C_o)` to :math:`(C_o, C_i)`. A port state dict is therefore a
checkpoint-layout state dict, which the JAX package's
`convert_flux_state_dict` loads back.
"""

from __future__ import annotations

__all__ = [
    "from_jax_state_dict",
]

import numpy as np
import torch

from collections.abc import Mapping

from ..utils import from_jax_arrays

_FEED_FORWARDS = ("ff", "ff_context")


def _rename(key: str) -> str:
    *parts, leaf = key.split(".")
    out = []
    for i, part in enumerate(parts):
        parent = parts[i - 1] if i else None
        if part == "norm_out_linear":
            out += ["norm_out", "linear"]
        elif parent in _FEED_FORWARDS and part == "proj":
            out += ["net", "0", "proj"]
        elif parent in _FEED_FORWARDS and part == "out":
            out += ["net", "2"]
        elif part == "to_out":
            out += ["to_out", "0"]
        else:
            out.append(part)
    return ".".join([*out, leaf])


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], backbone: torch.nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts a JAX Flux transformer state dict (or one of its blocks') to
    the port's layout.

    Arguments:
        sd: The JAX state dict, as numpy arrays.
        backbone: Optionally, the port's module; when given, the result is
            held to it by :func:`~azula_tpu_torch.nn.convert.check_state_dict`.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.
    """

    return from_jax_arrays(sd, backbone, rename=_rename)
