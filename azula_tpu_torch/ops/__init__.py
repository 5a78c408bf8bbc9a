r"""Operators with hand-written CUDA kernels for the card and plain PyTorch
versions for the CPU."""

from .attention import dot_product_attention
from .conv import conv3x3
from .fused_msa import fused_msa_attention
from .norm import group_norm, group_norm_silu, group_stats
from .residual import residual_add

__all__ = [
    "conv3x3",
    "dot_product_attention",
    "fused_msa_attention",
    "group_norm",
    "group_norm_silu",
    "group_stats",
    "residual_add",
]
