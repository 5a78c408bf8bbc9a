r"""Weight conversion from the JAX package's ADM backbone.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(backbone)` yields, as numpy arrays (keys
like `input_blocks.1.0.in_norm.scale`), and returns the state dict of the
port's :class:`ADMUNet`: Linear weights go from :math:`(C_i, C_o)` to
:math:`(C_o, C_i)`, convolution kernels from HWIO to OIHW, and GroupNorm
`scale` becomes `weight`, the class embedding `label_emb` is copied as it
is: the rules of :func:`azula_tpu_torch.models.utils.from_jax_arrays`.

The port's keys are the JAX package's, not the guided-diffusion
checkpoints': :func:`canonicalize_adm_keys` renames them to the checkpoints'
(the space of the manifests), the renames of `azula_tpu/models/adm/convert.py`
run the other way; the layouts are already PyTorch's, the checkpoints'
`conv1d` QKV and output projections carrying a trailing 1.
"""

from __future__ import annotations

__all__ = [
    "canonicalize_adm_keys",
    "from_jax_state_dict",
]

import numpy as np
import re
import torch

from collections.abc import Mapping

from ..utils import from_jax_arrays

# port name -> guided-diffusion name: the residual blocks' sequential
# indices, the attention's output projection, the skip connection
_BLOCK_RENAMES = {
    "in_norm": "in_layers.0",
    "in_conv": "in_layers.2",
    "emb_lin": "emb_layers.1",
    "out_norm": "out_layers.0",
    "out_conv": "out_layers.3",
    "skip": "skip_connection",
    "proj": "proj_out",
}
_BLOCK = re.compile(r"^((?:input_blocks|output_blocks)\.\d+\.\d+|middle_block\.\d+)\.(\w+)\.")
_TOP = {"time_embed.1.": "time_embed.2.", "out_norm.": "out.0.", "out_conv.": "out.2."}


def canonicalize_adm_keys(sd: Mapping) -> dict:
    r"""Renames the port's :class:`ADMUNet` keys to the guided-diffusion
    checkpoints' (the manifests' space); the checkpoints' own keys pass
    through. Key-only; values pass through."""

    out = {}
    for key, value in sd.items():
        if key == "label_emb":
            key = "label_emb.weight"
        elif m := _BLOCK.match(key):
            key = f"{m[1]}.{_BLOCK_RENAMES.get(m[2], m[2])}.{key[m.end():]}"
        else:
            for old, new in _TOP.items():
                if key.startswith(old):
                    key = new + key[len(old):]
                    break
        out[key] = value

    return out


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], backbone: torch.nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts a JAX ADM backbone state dict to the port's layout.

    Arguments:
        sd: The JAX state dict, as numpy arrays.
        backbone: Optionally, the port's backbone. When given, every
            converted key must be one of its parameters with the same shape,
            and every parameter must be filled.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.

    Raises:
        KeyError: On a key the conversion does not know, a key the backbone
            lacks, or a backbone parameter the state dict leaves empty.
        ValueError: On a shape mismatch.
    """

    return from_jax_arrays(sd, backbone, raw=("label_emb",))
