r"""Common layers, channels-last.

Port of the ADM subset of :mod:`azula_tpu.nn.layers`. Tensors are
:math:`(B, *, C)`, as in the JAX package; weights are stored in PyTorch's
layouts (Linear :math:`(C_o, C_i)`, convolution :math:`(C_o, C_i, k_h, k_w)`)
so that `F.linear` and `F.conv2d` take them as they are. A channels-last image
permuted to (B, C, H, W) is already `channels_last` memory for cuDNN.
"""

from __future__ import annotations

__all__ = [
    "Conv",
    "Dropout",
    "GroupNorm",
    "Linear",
]

import math
import torch
import torch.nn.functional as F

from collections.abc import Sequence
from torch import Tensor, nn

from ..ops.norm import group_norm


def _uniform(shape, bound, device, dtype, generator) -> nn.Parameter:
    w = torch.empty(shape, device=device, dtype=dtype)
    w.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w)


class Linear(nn.Module):
    r"""Affine layer :math:`y = W x + b`, weight :math:`(C_o, C_i)`,
    initialized uniformly within :math:`\pm 1 / \sqrt{C_i}` as in JAX."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        bound = 1 / math.sqrt(in_features)
        self.weight = _uniform((out_features, in_features), bound, device, dtype, generator)
        self.bias = _uniform((out_features,), bound, device, dtype, generator) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv(nn.Module):
    r"""2-d convolution in channels-last layout with zero padding.

    Arguments:
        in_channels: The number of input channels :math:`C_i`.
        out_channels: The number of output channels :math:`C_o`.
        kernel_size: The kernel shape :math:`(k_h, k_w)`.
        stride: The stride per spatial dimension.
        padding: `(lo, hi)` zero padding per spatial dimension.
        bias: Whether to add a bias or not.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Sequence[int],
        stride: Sequence[int] | None = None,
        padding: Sequence[tuple[int, int]] | None = None,
        bias: bool = True,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        kernel_size = tuple(kernel_size)
        if len(kernel_size) != 2:
            raise NotImplementedError("only 2-d convolutions are ported")

        bound = 1 / math.sqrt(in_channels * math.prod(kernel_size))
        self.weight = _uniform(
            (out_channels, in_channels, *kernel_size), bound, device, dtype, generator
        )
        self.bias = _uniform((out_channels,), bound, device, dtype, generator) if bias else None

        self.stride = tuple(stride) if stride is not None else (1, 1)
        self.padding = tuple(tuple(p) for p in padding) if padding is not None else ((0, 0),) * 2

    def forward(self, x: Tensor) -> Tensor:
        h = x.permute(0, 3, 1, 2)  # (B, C, H, W) view of channels-last memory

        (top, bottom), (left, right) = self.padding
        if top == bottom and left == right:
            padding = (top, left)
        else:
            h = F.pad(h, (left, right, top, bottom))
            padding = (0, 0)

        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(h, self.weight.to(x.dtype), bias, stride=self.stride, padding=padding)

        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    r"""Channels-last group normalization with float32 statistics.

    The JAX package's `scale` is `weight` here. Parameter-free when
    :py:`affine=False`.
    """

    def __init__(
        self,
        groups: int,
        channels: int,
        eps: float = 1e-5,
        affine: bool = False,
        *,
        device=None,
        dtype=None,
    ) -> None:
        super().__init__()

        self.groups = min(groups, channels)
        self.eps = eps

        if affine:
            self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
            self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))
        else:
            self.weight = None
            self.bias = None

    def forward(self, x: Tensor) -> Tensor:
        return group_norm(x, self.groups, eps=self.eps, scale=self.weight, bias=self.bias)


class Dropout(nn.Module):
    r"""Dropout layer: the identity at inference (no generator). Training,
    which passes a generator, is not ported yet (ROADMAP A16)."""

    def __init__(self, rate: float) -> None:
        super().__init__()

        self.rate = rate

    def forward(self, x: Tensor, generator: torch.Generator | None = None) -> Tensor:
        if generator is None or self.rate <= 0:
            return x

        raise NotImplementedError("dropout in training is not ported yet (ROADMAP A16)")
