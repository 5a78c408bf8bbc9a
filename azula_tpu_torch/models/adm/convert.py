r"""Weight conversion from the JAX package's ADM backbone.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(backbone)` yields, as numpy arrays (keys
like `input_blocks.1.0.in_norm.scale`), and returns the state dict of the
port's :class:`ADMUNet`: Linear weights go from :math:`(C_i, C_o)` to
:math:`(C_o, C_i)`, convolution kernels from HWIO to OIHW, and GroupNorm
`scale` becomes `weight`, the class embedding `label_emb` is copied as it
is: the rules of :func:`azula_tpu_torch.models.utils.from_jax_arrays`.
"""

from __future__ import annotations

__all__ = [
    "from_jax_state_dict",
]

import numpy as np
import torch

from collections.abc import Mapping

from ..utils import from_jax_arrays


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
