r"""U-Net building blocks.

Port of :mod:`azula_tpu.nn.unet`: AdaLN-Zero modulated blocks,
strided-convolution downsampling, nearest upsampling, skip concatenation
narrowed for odd sizes, 1 to 3 spatial dimensions and periodic padding, in
channels-last layout :math:`(B, L_1, ..., L_N, C)`. The module lists nest as
the JAX package's, so the state-dict keys agree (`descent.1.2.conv1.weight`,
`ascent.0.3.weight`, ...).
"""

from __future__ import annotations

__all__ = [
    "AdaZero",
    "UNet",
    "UNetBlock",
]

import torch
import torch.nn.functional as F

from collections.abc import Sequence
from torch import Tensor, nn

from .layers import ConvNd, Dropout, GroupNorm, LayerNorm, Linear, RMSNorm, Upsample
from .utils import checkpoint, default_device


class AdaZero(nn.Module):
    r"""AdaLN-Zero modulation head: maps a modulation vector to per-channel
    :math:`(a, b, c)` triples, the final projection scaled by :math:`10^{-2}`;
    a learned parameter triple :math:`(3, C)` when :py:`mod_features == 0`."""

    def __init__(
        self,
        mod_features: int,
        channels: int,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        device = default_device(device)

        if mod_features > 0:
            factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408
            self.lin1 = Linear(mod_features, mod_features, **factory)
            self.lin2 = Linear(mod_features, 3 * channels, **factory)
            with torch.no_grad():
                self.lin2.weight.mul_(1e-2)
            self.param = None
        else:
            self.lin1 = None
            self.lin2 = None
            param = torch.randn((3, channels), device=device, generator=generator) * 1e-2
            self.param = nn.Parameter(param.to(dtype))

    def forward(self, mod: Tensor | None, spatial: int) -> tuple[Tensor, Tensor, Tensor]:
        if self.param is not None:
            abc = self.param
        else:
            h = F.silu(self.lin1(mod))
            h = self.lin2(h)
            abc = h.unflatten(-1, (3, -1)).movedim(-2, 0)  # (3, *, C)

        # singleton spatial axes before the channel axis (channels-last)
        return tuple(z.reshape(*z.shape[:-1], *(1,) * spatial, z.shape[-1]) for z in abc)


class UNetBlock(nn.Module):
    r"""Creates a modulated U-Net block.

    :math:`y = x + c \cdot \mathrm{FFN}\big((a + 1) \, \mathrm{norm}(x) + b\big)`
    where :math:`(a, b, c)` come from the AdaLN-Zero head and the FFN is two
    convolutions around a SiLU.

    Arguments:
        channels: The number of channels :math:`C`.
        mod_features: The number of modulating features :math:`D`.
        norm: The kind of normalization: `'layer'`, `'rms'` or `'group'`.
        groups: The number of groups for group normalization.
        ffn_factor: The channel factor in the FFN.
        spatial: The number of spatial dimensions :math:`N`.
        dropout: The dropout rate in :math:`[0, 1]`.
        checkpointing: Whether to recompute the block in the backward pass
            (applied only while gradients are enabled).
        device: The device of the parameters. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters. Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`).
        kwargs: Keyword arguments passed to :func:`ConvNd`.
    """

    def __init__(
        self,
        channels: int,
        mod_features: int = 0,
        norm: str = "layer",
        groups: int = 16,
        ffn_factor: int = 1,
        spatial: int = 2,
        dropout: float | None = None,
        checkpointing: bool = False,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
        **kwargs,
    ) -> None:
        super().__init__()

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408

        self.checkpointing = checkpointing
        self.spatial = spatial

        if norm == "layer":
            self.norm = LayerNorm(dim=-1, eps=1e-5)
        elif norm == "rms":
            self.norm = RMSNorm(dim=-1, eps=1e-5)
        elif norm == "group":
            self.norm = GroupNorm(groups, channels, eps=1e-5, affine=False)
        else:
            raise NotImplementedError(f"unknown norm '{norm}'")

        self.ada_zero = AdaZero(mod_features, channels, **factory)

        self.conv1 = ConvNd(channels, ffn_factor * channels, spatial=spatial, **factory, **kwargs)
        self.conv2 = ConvNd(ffn_factor * channels, channels, spatial=spatial, **factory, **kwargs)
        self.drop = None if dropout is None else Dropout(dropout)

    def _forward(
        self, x: Tensor, mod: Tensor | None = None, generator: torch.Generator | None = None
    ) -> Tensor:
        a, b, c = self.ada_zero(mod, self.spatial)

        y = (a + 1) * self.norm(x) + b
        y = self.conv1(y)
        y = F.silu(y)
        if self.drop is not None:
            y = self.drop(y, generator)
        y = self.conv2(y)
        y = x + c * y

        return y

    def forward(
        self, x: Tensor, mod: Tensor | None = None, generator: torch.Generator | None = None
    ) -> Tensor:
        r"""
        Arguments:
            x: The input tensor, with shape :math:`(B, L_1, ..., L_N, C)`.
            mod: The modulation vector, with shape :math:`(D)` or :math:`(B, D)`.
            generator: The generator of the dropout, which it enables
                (training; the JAX `key`).

        Returns:
            The output tensor, with shape :math:`(B, L_1, ..., L_N, C)`.
        """

        if self.checkpointing and torch.is_grad_enabled():
            return checkpoint(self._forward)(x, mod, generator=generator)

        return self._forward(x, mod, generator)


class UNet(nn.Module):
    r"""Creates a modulated U-Net, channels-last.

    Arguments:
        in_channels: The number of input channels :math:`C_i`.
        out_channels: The number of output channels :math:`C_o`.
        cond_channels: The number of condition channels :math:`C_c`.
        hid_channels: The numbers of channels at each depth.
        hid_blocks: The numbers of hidden blocks at each depth.
        kernel_size: The kernel size of all convolutions.
        stride: The stride of the downsampling convolutions.
        spatial: The number of spatial dimensions :math:`N`.
        periodic: Whether the spatial dimensions are periodic.
        identity_init: Initialize down/upsampling convolutions as identity.
        device: The device of the parameters. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters. Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`).
        kwargs: Keyword arguments passed to :class:`UNetBlock`.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        cond_channels: int = 0,
        hid_channels: Sequence[int] = (64, 128, 256),
        hid_blocks: Sequence[int] = (3, 3, 3),
        kernel_size: int | Sequence[int] = 3,
        stride: int | Sequence[int] = 2,
        spatial: int = 2,
        periodic: bool = False,
        identity_init: bool = False,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
        **kwargs,
    ) -> None:
        super().__init__()

        if len(hid_blocks) != len(hid_channels):
            raise ValueError("hid_blocks and hid_channels must have the same length")

        if isinstance(kernel_size, int):
            kernel_size = [kernel_size] * spatial
        if isinstance(stride, int):
            stride = [stride] * spatial

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408
        conv_kwargs = dict(  # noqa: C408
            kernel_size=tuple(kernel_size),
            padding=tuple((k // 2, k // 2) for k in kernel_size),
            periodic=periodic,
            spatial=spatial,
        )

        self.descent, self.ascent = nn.ModuleList(), nn.ModuleList()

        for i, num_blocks in enumerate(hid_blocks):
            do, up = [], []

            for _ in range(num_blocks):
                do.append(UNetBlock(hid_channels[i], **factory, **conv_kwargs, **kwargs))
                up.append(UNetBlock(hid_channels[i], **factory, **conv_kwargs, **kwargs))

            if i > 0:
                do.insert(
                    0,
                    ConvNd(
                        hid_channels[i - 1],
                        hid_channels[i],
                        stride=tuple(stride),
                        identity_init=identity_init,
                        **factory,
                        **conv_kwargs,
                    ),
                )
                up.append(Upsample(factor=tuple(stride)))
            else:
                do.insert(0, ConvNd(in_channels + cond_channels, hid_channels[i], **factory, **conv_kwargs))
                up.append(ConvNd(hid_channels[i], out_channels, **factory, **conv_kwargs))

            if i + 1 < len(hid_blocks):
                up.insert(
                    0,
                    ConvNd(
                        hid_channels[i] + hid_channels[i + 1],
                        hid_channels[i],
                        identity_init=identity_init,
                        **factory,
                        **conv_kwargs,
                    ),
                )

            self.descent.append(nn.ModuleList(do))
            self.ascent.insert(0, nn.ModuleList(up))

    def forward(
        self,
        x: Tensor,
        mod: Tensor | None = None,
        cond: Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> Tensor:
        r"""
        Arguments:
            x: The input tensor, with shape :math:`(B, L_1, ..., L_N, C_i)`.
            mod: The modulation vector, with shape :math:`(D)` or :math:`(B, D)`.
            cond: The condition tensor, with shape :math:`(B, L_1, ..., L_N, C_c)`.
            generator: The generator of the dropout, which it enables
                (training; the JAX `key`), drawn from by each block in turn,
                as JAX splits one key per block.

        Returns:
            The output tensor, with shape :math:`(B, L_1, ..., L_N, C_o)`.
        """

        if cond is not None:
            x = torch.cat((x, cond), dim=-1)

        memory = []

        for blocks in self.descent:
            memory.append(x if memory else None)

            for block in blocks:
                if isinstance(block, UNetBlock):
                    x = block(x, mod, generator=generator)
                else:
                    x = block(x)

        for blocks in self.ascent:
            for block in blocks:
                if isinstance(block, UNetBlock):
                    x = block(x, mod, generator=generator)
                else:
                    x = block(x)

            y = memory.pop()

            if y is None:
                continue

            # narrow to the skip's spatial shape (odd sizes after a round trip)
            for i in range(1, x.ndim - 1):
                if x.shape[i] > y.shape[i]:
                    x = x.narrow(i, 0, y.shape[i])

            x = torch.cat((y, x), dim=-1)

        return x
