r"""Common layers, channels-last.

Port of :mod:`azula_tpu.nn.layers` (ADM, UNet and transformer layers).
Tensors are :math:`(B, *, C)`, as in the JAX package; weights are stored in
PyTorch's layouts (Linear :math:`(C_o, C_i)`, convolution
:math:`(C_o, C_i, *k)`) so that `F.linear` and `F.conv{1,2,3}d` take them as
they are. A channels-last image permuted to (B, C, H, W) is already
`channels_last` memory for cuDNN.
"""

from __future__ import annotations

__all__ = [
    "Conv",
    "ConvNd",
    "Dropout",
    "Embedding",
    "GroupNorm",
    "Identity",
    "LayerNorm",
    "Linear",
    "Patchify",
    "RMSNorm",
    "ReLU2",
    "SineEncoding",
    "SwiGLU",
    "Unpatchify",
    "Upsample",
    "layer_norm",
    "relu2",
    "rms_norm",
    "sine_encoding",
    "swiglu",
]

import math
import torch
import torch.nn.functional as F

from collections.abc import Sequence
from torch import Tensor, nn

from ..ops.norm import group_norm
from .utils import _linspace, promote_dtype


def _uniform(shape, bound, device, dtype, generator) -> nn.Parameter:
    w = torch.empty(shape, device=device, dtype=dtype)
    w.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w)


class Embedding(nn.Module):
    r"""A table of `num` vectors of `dim` features, looked up by integer ids,
    drawn from :math:`\mathcal{N}(0, 0.02^2)` as the JAX model zoo draws its
    tables. The table is `weight`, as in PyTorch's `nn.Embedding`."""

    def __init__(self, num: int, dim: int, *, device=None, dtype=None, generator=None) -> None:
        super().__init__()

        w = torch.empty((num, dim), device=device, dtype=dtype)
        w.normal_(0.0, 0.02, generator=generator)
        self.weight = nn.Parameter(w)

    def forward(self, ids: Tensor) -> Tensor:
        return F.embedding(ids, self.weight)


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


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class Conv(nn.Module):
    r"""N-dimensional convolution in channels-last layout.

    Arguments:
        in_channels: The number of input channels :math:`C_i`.
        out_channels: The number of output channels :math:`C_o`.
        kernel_size: The kernel shape, one entry per spatial dimension (1 to 3).
        stride: The stride per spatial dimension.
        padding: `(lo, hi)` padding per spatial dimension.
        periodic: Whether padding wraps around (circular) or zero-fills.
        bias: Whether to add a bias or not.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Sequence[int],
        stride: Sequence[int] | None = None,
        padding: Sequence[tuple[int, int]] | None = None,
        periodic: bool = False,
        bias: bool = True,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        kernel_size = tuple(kernel_size)
        spatial = len(kernel_size)
        if spatial not in _CONV:
            raise NotImplementedError(f"{spatial}-d convolutions are not supported")

        bound = 1 / math.sqrt(in_channels * math.prod(kernel_size))
        self.weight = _uniform(
            (out_channels, in_channels, *kernel_size), bound, device, dtype, generator
        )
        self.bias = _uniform((out_channels,), bound, device, dtype, generator) if bias else None

        self.stride = tuple(stride) if stride is not None else (1,) * spatial
        self.padding = tuple(tuple(p) for p in padding) if padding is not None else ((0, 0),) * spatial
        self.periodic = periodic

    @torch.no_grad()
    def identity_init_(self) -> None:
        r"""Re-initializes the convolution as a (pseudo-)identity: the first
        :math:`C_i` output filters are scaled by :math:`10^{-2}` and a
        center-tap identity is added."""

        out_channels, in_channels, *kernel_size = self.weight.shape
        center = tuple(k // 2 for k in kernel_size)

        self.weight[:in_channels].mul_(1e-2)
        for i in range(min(in_channels, out_channels)):
            self.weight[(i, i, *center)] += 1.0

    def forward(self, x: Tensor, defer_bias: bool = False) -> Tensor | tuple[Tensor, Tensor | None]:
        r"""
        Arguments:
            x: The input, with shape :math:`(B, *, C_i)`.
            defer_bias: Whether to return the convolution without its bias
                and, beside it, the bias in the dtype of `x` (or `None`), for
                a caller that adds it in a later pass of its own
                (`ops.residual_add`). Through the module's call, so that hooks
                on it (the parallel layer's parameter gathers) see both.
        """

        h = x.movedim(-1, 1)  # (B, C, *spatial) view of channels-last memory

        # F.pad takes (lo, hi) pairs from the last dimension to the first
        pads = [p for pair in reversed(self.padding) for p in pair]
        if self.periodic:
            h = F.pad(h, pads, mode="circular")
            padding = 0
        elif all(lo == hi for lo, hi in self.padding):
            padding = tuple(lo for lo, _ in self.padding)
        else:
            h = F.pad(h, pads)
            padding = 0

        bias = None if self.bias is None else self.bias.to(x.dtype)
        w = self.weight.to(x.dtype)
        y = _CONV[len(self.stride)](h, w, None if defer_bias else bias, stride=self.stride, padding=padding)
        y = y.movedim(1, -1)

        return (y, bias) if defer_bias else y


def ConvNd(
    in_channels: int,
    out_channels: int,
    spatial: int = 2,
    identity_init: bool = False,
    kernel_size: int | Sequence[int] = 1,
    stride: int | Sequence[int] = 1,
    padding: int | Sequence[tuple[int, int]] | None = None,
    periodic: bool = False,
    bias: bool = True,
    *,
    device=None,
    dtype=None,
    generator: torch.Generator | None = None,
) -> nn.Module:
    r"""Returns an N-dimensional convolutional layer (a :class:`Linear` when
    :py:`spatial == 0`).

    Arguments:
        in_channels: The number of input channels :math:`C_i`.
        out_channels: The number of output channels :math:`C_o`.
        spatial: The number of spatial dimensions :math:`N`.
        identity_init: Initialize the convolution as a (pseudo-)identity.
        kernel_size, stride, padding, periodic, bias: As :class:`Conv`; an
            integer stands for every spatial dimension.
        device, dtype, generator: The parameters' device, dtype and
            initial-value generator.
    """

    factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

    if spatial == 0:
        return Linear(in_channels, out_channels, bias=bias, **factory)

    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * spatial
    if isinstance(stride, int):
        stride = (stride,) * spatial
    if padding is None:
        padding = ((0, 0),) * spatial
    elif isinstance(padding, int):
        padding = ((padding, padding),) * spatial

    conv = Conv(
        in_channels, out_channels, kernel_size, stride=stride, padding=padding, periodic=periodic, bias=bias, **factory
    )

    if identity_init:
        conv.identity_init_()

    return conv


class Upsample(nn.Module):
    r"""Nearest-neighbor upsampling over the spatial dimensions,
    channels-last: each of the last :math:`N` non-channel axes is repeated
    by its factor."""

    def __init__(self, factor: Sequence[int]) -> None:
        super().__init__()

        self.factor = tuple(factor)

    def forward(self, x: Tensor) -> Tensor:
        N = len(self.factor)

        for i, f in enumerate(self.factor):
            if f > 1:
                x = x.repeat_interleave(f, dim=x.ndim - 1 - N + i)

        return x


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
    r"""Dropout layer: active only when a generator is given (training), the
    identity otherwise. Elements are kept with probability :math:`1 - r`,
    drawn from the generator (of `x`'s device), and scaled by
    :math:`1 / (1 - r)`."""

    def __init__(self, rate: float) -> None:
        super().__init__()

        self.rate = rate

    def forward(self, x: Tensor, generator: torch.Generator | None = None) -> Tensor:
        if generator is None or self.rate <= 0:
            return x

        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - self.rate
        # 1 - r in x's dtype, as JAX's weak-typed scalar takes it
        retain = torch.tensor(1 - self.rate, dtype=x.dtype).item()

        return torch.where(keep, x / retain, 0.0).to(x.dtype)


class Identity(nn.Module):
    r"""Identity layer."""

    def forward(self, x: Tensor, *args, **kwargs) -> Tensor:
        return x


class ReLU2(nn.Module):
    r"""ReLU² activation: :math:`y = \max(x, 0)^2`."""

    def forward(self, x: Tensor) -> Tensor:
        return relu2(x)


def relu2(x: Tensor, /) -> Tensor:
    return torch.square(F.relu(x))


class SwiGLU(nn.Module):
    r"""SwiGLU activation: :math:`y = x_1 \times x_2 \, \sigma(x_2)` over
    interleaved channel pairs :math:`(x_1, x_2) = (x_{2i}, x_{2i+1})`."""

    def forward(self, x: Tensor) -> Tensor:
        return swiglu(x)


def swiglu(x: Tensor, /) -> Tensor:
    x = x.unflatten(-1, (-1, 2))
    return x[..., 0] * F.silu(x[..., 1])


class LayerNorm(nn.Module):
    r"""Parameter-free layer normalization over one or more dimensions,
    computed in float32."""

    def __init__(self, dim: int | Sequence[int] = -1, eps: float = 1e-5) -> None:
        super().__init__()

        self.dim = dim if isinstance(dim, int) else tuple(dim)
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        return layer_norm(x, dim=self.dim, eps=self.eps)


@promote_dtype
def layer_norm(x: Tensor, /, dim: int | Sequence[int] = -1, eps: float = 1e-5) -> Tensor:
    m = torch.mean(x, dim=dim, keepdim=True)
    v = torch.mean(torch.square(x - m), dim=dim, keepdim=True)

    return (x - m) * torch.rsqrt(v + eps)


class RMSNorm(nn.Module):
    r"""Parameter-free RMS normalization over one or more dimensions,
    computed in float32."""

    def __init__(self, dim: int | Sequence[int] = -1, eps: float = 1e-5) -> None:
        super().__init__()

        self.dim = dim if isinstance(dim, int) else tuple(dim)
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        return rms_norm(x, dim=self.dim, eps=self.eps)


@promote_dtype
def rms_norm(x: Tensor, /, dim: int | Sequence[int] = -1, eps: float = 1e-5) -> Tensor:
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=dim, keepdim=True) + eps)


class Patchify(nn.Module):
    r"""Folds spatial patches into the channel dimension (channels-last).

    :math:`(B, L_1 p_1, ..., L_N p_N, C) \to (B, L_1, ..., L_N, C p_1 \cdots p_N)`,
    with the inner feature order :math:`(C, p_1, ..., p_N)`.
    """

    def __init__(self, patch_shape: Sequence[int]) -> None:
        super().__init__()

        self.patch_shape = tuple(patch_shape)

    def forward(self, x: Tensor) -> Tensor:
        p = self.patch_shape
        N = len(p)

        # (*, L1 p1, ..., LN pN, C) -> (*, L1, p1, ..., LN, pN, C)
        shape = list(x.shape[: -N - 1])
        for size, patch in zip(x.shape[-N - 1 : -1], p, strict=True):
            shape.extend([size // patch, patch])
        shape.append(x.shape[-1])
        x = x.reshape(shape)

        # -> (*, L1, ..., LN, C, p1, ..., pN) -> (*, L1, ..., LN, C p1 ... pN)
        batch = x.ndim - 2 * N - 1
        grid = [batch + 2 * i for i in range(N)]
        patches = [batch + 2 * i + 1 for i in range(N)]
        x = x.permute(*range(batch), *grid, x.ndim - 1, *patches)

        return x.flatten(-N - 1)


class Unpatchify(nn.Module):
    r"""Unfolds the channel dimension back into spatial patches (the inverse
    of :class:`Patchify`)."""

    def __init__(self, patch_shape: Sequence[int]) -> None:
        super().__init__()

        self.patch_shape = tuple(patch_shape)

    def forward(self, x: Tensor) -> Tensor:
        p = self.patch_shape
        N = len(p)

        grid = x.shape[-N - 1 : -1]
        C = x.shape[-1] // math.prod(p)

        # (*, L1, ..., LN, C p1 ... pN) -> (*, L1, ..., LN, C, p1, ..., pN)
        x = x.unflatten(-1, (C, *p))

        # -> (*, L1, p1, ..., LN, pN, C) -> (*, L1 p1, ..., LN pN, C)
        batch = x.ndim - 2 * N - 1
        order = list(range(batch))
        for i in range(N):
            order.extend([batch + i, batch + N + 1 + i])
        order.append(batch + N)
        x = x.permute(order)

        return x.reshape(*x.shape[:batch], *(size * patch for size, patch in zip(grid, p, strict=True)), C)


class SineEncoding(nn.Module):
    r"""Sinusoidal positional encoding, in two halves:

    .. math::
        e_i = \sin(x \, \omega^{-f_i}), \quad e_{D/2 + i} = \cos(x \, \omega^{-f_i})

    with :math:`f` the :math:`D / 2` points of :math:`\mathrm{linspace}(0, 1)`.

    Arguments:
        features: The number of embedding features :math:`D`. Must be even.
        omega: The maximum frequency :math:`\omega`.
    """

    def __init__(self, features: int, omega: float = 1e4) -> None:
        super().__init__()

        if features % 2:
            raise ValueError(f"SineEncoding takes an even number of features, got {features}")

        self.features = features
        self.omega = omega

    def forward(self, x: Tensor) -> Tensor:
        return sine_encoding(x, features=self.features, omega=self.omega)


@promote_dtype
def sine_encoding(x: Tensor, /, features: int, omega: float = 1e4) -> Tensor:
    x = x[..., None]

    freqs = _linspace(0, 1, features // 2, x.dtype, x.device)
    freqs = torch.exp(math.log(1 / omega) * freqs)

    return torch.cat((torch.sin(x * freqs), torch.cos(x * freqs)), dim=-1)
