r"""Weight conversion from the JAX package's JiT backbone.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(module)` yields for a `JiT`, as numpy
arrays, and returns the state dict of the port's module, whose keys are the
checkpoints': `t_embedder_mlp.{0,1}` -> `t_embedder.mlp.{0,2}`,
`y_embedding` -> `y_embedder.embedding_table.weight`, `proj{1,2}` ->
`x_embedder.proj{1,2}`, each block's `adaLN` -> `adaLN_modulation.1`,
`final_{norm,linear,adaLN}` -> `final_layer.{norm_final,linear,
adaLN_modulation.1}`, `pos_embed` and `in_context_posemb` with their
leading 1; Linear and convolution weights to PyTorch's layouts. The RoPE
tables (`rope.*`, `rope_incontext.*`) are left out: the port computes its
own. A port state dict is therefore a checkpoint-layout state dict, which
the JAX package's `convert_state_dict(backbone, sd)` loads back.
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

from ...nn.convert import check_state_dict
from ..utils import from_jax_arrays

_RENAMES = (
    (r"^t_embedder_mlp\.0\.", "t_embedder.mlp.0."),
    (r"^t_embedder_mlp\.1\.", "t_embedder.mlp.2."),
    (r"^proj([12])\.", r"x_embedder.proj\1."),
    (r"^(blocks\.\d+)\.adaLN\.", r"\1.adaLN_modulation.1."),
    (r"^final_norm\.", "final_layer.norm_final."),
    (r"^final_linear\.", "final_layer.linear."),
    (r"^final_adaLN\.", "final_layer.adaLN_modulation.1."),
)


def _rename(key: str) -> str:
    for pattern, repl in _RENAMES:
        key = re.sub(pattern, repl, key)
    return key


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts a JAX JiT state dict (a `JiT`'s, or a block's under its
    `blocks.i.` name) to the port's layout.

    Arguments:
        sd: The JAX state dict, as numpy arrays.
        module: Optionally, the port's module, to hold the result to.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.
    """

    sd = {k: np.asarray(v) for k, v in sd.items() if not k.startswith(("rope.", "rope_incontext."))}
    if "y_embedding" in sd:
        sd["y_embedder.embedding_table"] = sd.pop("y_embedding")
    for key in ("pos_embed", "in_context_posemb"):
        if key in sd:
            sd[key] = sd[key][None]

    # RMSNorm weights are the JAX package's `weight`s: 1-d, copied as they are
    norms = {k: v for k, v in sd.items() if k.endswith(".weight") and v.ndim == 1}
    out = from_jax_arrays(
        {k: v for k, v in sd.items() if k not in norms}, rename=_rename,
        tables=("embedding_table",), raw=("pos_embed", "in_context_posemb"),
    )
    out.update({_rename(k): torch.from_numpy(np.ascontiguousarray(v)) for k, v in norms.items()})

    if module is not None:
        check_state_dict(out, module)

    return out
