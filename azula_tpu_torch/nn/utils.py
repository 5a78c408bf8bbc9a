r"""Module utilities."""

from __future__ import annotations

__all__ = [
    "get_module_dtype",
]

import torch

from torch import nn


def get_module_dtype(module: nn.Module) -> torch.dtype:
    r"""Returns the data type of a module's first floating-point parameter
    (float32 when it has none), used to run low-precision backbones inside
    full-precision sampling math."""

    for p in module.parameters():
        if p.is_floating_point():
            return p.dtype

    return torch.float32
