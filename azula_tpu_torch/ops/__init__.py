r"""Operators with hand-written CUDA kernels for the card and plain PyTorch
versions for the CPU."""

from .attention import dot_product_attention
from .norm import group_norm, group_norm_silu

__all__ = [
    "dot_product_attention",
    "group_norm",
    "group_norm_silu",
]
