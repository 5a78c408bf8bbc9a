r"""Weight conversion from the JAX package's `nn` modules.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(module)` yields, as numpy arrays (keys like
`backbone.blocks.3.msa.qkv_proj.weight` or `time_embedding.lin1.bias`), and
returns the state dict of the port's module of the same structure. Linear
weights go from :math:`(C_i, C_o)` to :math:`(C_o, C_i)` (`theta_proj`
included), N-d convolution kernels from :math:`(*k, C_i, C_o)` to
:math:`(C_o, C_i, *k)`; biases and the `param` of `DiTAdaZero` and the
UNet's `AdaZero` are copied as they are. The ADM converter
(`models/adm/convert.py`) shares these rules and the strict check.
"""

from __future__ import annotations

__all__ = [
    "check_state_dict",
    "convert_leaf",
    "from_jax_state_dict",
]

import numpy as np
import torch

from collections.abc import Mapping


def convert_leaf(key: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    r"""The port's key and array for one leaf of a JAX Linear, convolution,
    bias or `AdaZero.param`; raises :class:`KeyError` on any other leaf."""

    prefix, _, leaf = key.rpartition(".")

    if prefix and leaf == "weight" and value.ndim == 2:  # Linear (in, out) -> (out, in)
        return key, value.T
    if prefix and leaf == "weight" and value.ndim in (3, 4, 5):  # conv (*k, in, out) -> (out, in, *k)
        return key, np.moveaxis(value, (-1, -2), (0, 1))
    if prefix and leaf == "bias" and value.ndim == 1:
        return key, value
    if prefix and leaf == "param" and value.ndim == 2:  # AdaZero without modulation
        return key, value

    raise KeyError(f"unexpected key '{key}' of shape {value.shape} in the JAX state dict")


def check_state_dict(state: Mapping[str, torch.Tensor], module: torch.nn.Module) -> None:
    r"""Raises unless `state` fills every parameter of `module` with a tensor
    of its shape, and holds no other key.

    Raises:
        KeyError: On a key the module lacks, or a parameter left empty.
        ValueError: On a shape mismatch.
    """

    expected = module.state_dict()

    unexpected = sorted(set(state) - set(expected))
    missing = sorted(set(expected) - set(state))
    if unexpected:
        raise KeyError(f"keys the module lacks: {unexpected[:8]}")
    if missing:
        raise KeyError(f"module parameters left empty: {missing[:8]}")

    for key, value in state.items():
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"shape mismatch for '{key}': {tuple(value.shape)} != {tuple(expected[key].shape)}"
            )


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: torch.nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts the state dict of a JAX `nn` module (DiT, ViT, UNet,
    `Modulated`, `MultiheadSelfAttention`, ...) to the port's layout.

    Arguments:
        sd: The JAX state dict, as numpy arrays.
        module: Optionally, the port's module; when given, the result is held
            to it by :func:`check_state_dict`.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.
    """

    out = {}
    for key, value in sd.items():
        new, array = convert_leaf(key, np.asarray(value))
        out[new] = torch.from_numpy(np.ascontiguousarray(array))

    if module is not None:
        check_state_dict(out, module)

    return out
