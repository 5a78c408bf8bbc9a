r"""Diffusion Transformer (DiT) building blocks.

Port of :mod:`azula_tpu.nn.dit`: RMSNorm AdaLN-Zero blocks where MSA and FFN
live inside one gated residual, sinusoidal embedding of arbitrary position
coordinates, and FFN activations chosen by name.

References:
    | Scalable Diffusion Models with Transformers (Peebles et al., 2022)
    | https://arxiv.org/abs/2212.09748
"""

from __future__ import annotations

__all__ = [
    "DiT",
    "DiTAdaZero",
    "DiTBlock",
]

import torch
import torch.nn.functional as F

from torch import Tensor, nn
from typing import Literal

from .attention import MultiheadSelfAttention
from .layers import Dropout, Linear, RMSNorm, SineEncoding, relu2, swiglu
from .utils import checkpoint, default_device

_ACTIVATIONS = {
    "relu": F.relu,
    "relu2": relu2,
    "silu": F.silu,
    "swiglu": swiglu,
}


class DiTAdaZero(nn.Module):
    r"""AdaLN-Zero modulation head for token sequences: the scale, shift and
    gate :math:`(a, b, c)`, each of shape :math:`(*, 1, C)` (or :math:`(C)`
    without modulating features)."""

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

    def forward(self, mod: Tensor | None) -> tuple[Tensor, Tensor, Tensor]:
        if self.param is not None:
            a, b, c = self.param
        else:
            h = F.silu(self.lin1(mod))
            h = self.lin2(h)
            # (*, 3 C) -> (3, *, 1, C): broadcast over the token axis
            a, b, c = h.unflatten(-1, (3, -1)).movedim(-2, 0)[..., None, :]

        return a, b, c


class DiTBlock(nn.Module):
    r"""Creates a modulated DiT block.

    .. math::
        y &= (a + 1) \, \mathrm{norm}(x) + b \\
        y &= y + \mathrm{MSA}(y) \\
        y &= \mathrm{FFN}(y) \\
        \mathrm{out} &= x + c \cdot y

    Arguments:
        channels: The number of channels :math:`C`.
        mod_features: The number of modulating features :math:`D`.
        ffn_factor: The channel factor in the FFN.
        ffn_activation: The FFN activation: `'relu'`, `'relu2'`, `'silu'` or `'swiglu'`.
        dropout: The dropout rate in :math:`[0, 1]`.
        checkpointing: Whether to recompute the block in the backward pass
            (applied only while gradients are enabled).
        device: The device of the parameters. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters. Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`).
        kwargs: Keyword arguments passed to :class:`MultiheadSelfAttention`.
    """

    def __init__(
        self,
        channels: int,
        mod_features: int = 0,
        ffn_factor: int = 4,
        ffn_activation: Literal["relu", "relu2", "silu", "swiglu"] = "silu",
        dropout: float | None = None,
        checkpointing: bool = False,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
        **kwargs,
    ) -> None:
        super().__init__()

        if ffn_activation not in _ACTIVATIONS:
            raise NotImplementedError(f"Unknown activation '{ffn_activation}'.")

        device = default_device(device)
        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.checkpointing = checkpointing

        self.norm = RMSNorm(dim=-1, eps=1e-5)
        self.ada_zero = DiTAdaZero(mod_features, channels, **factory)

        self.msa = MultiheadSelfAttention(channels, dropout=dropout, **factory, **kwargs)

        self.ffn_activation = ffn_activation
        activation_factor = 2 if ffn_activation == "swiglu" else 1

        self.ffn1 = Linear(channels, ffn_factor * channels, **factory)
        self.ffn2 = Linear(ffn_factor * channels // activation_factor, channels, **factory)
        self.drop = None if dropout is None else Dropout(dropout)

    def _forward(
        self,
        x: Tensor,
        mod: Tensor | None = None,
        pos: Tensor | None = None,
        mask: Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> Tensor:
        a, b, c = self.ada_zero(mod)

        y = (a + 1) * self.norm(x) + b
        y = y + self.msa(y, pos, mask, generator=generator)
        y = self.ffn1(y)
        y = _ACTIVATIONS[self.ffn_activation](y)
        if self.drop is not None:
            y = self.drop(y, generator)
        y = self.ffn2(y)
        y = x + c * y

        return y

    def forward(
        self,
        x: Tensor,
        mod: Tensor | None = None,
        pos: Tensor | None = None,
        mask: Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> Tensor:
        r"""
        Arguments:
            x: The input tokens :math:`x`, with shape :math:`(*, L, C)`.
            mod: The modulation vector, with shape :math:`(D)` or :math:`(*, D)`.
            pos: The position coordinates, with shape :math:`(*, L, N)`.
            mask: The attention mask, with shape :math:`(*, L, L)`.
            generator: The generator of the dropout, which it enables
                (training; the JAX `key`): the attention's, then the FFN's
                draws, as JAX splits the key in two.

        Returns:
            The output tokens :math:`y`, with shape :math:`(*, L, C)`.
        """

        if self.checkpointing and torch.is_grad_enabled():
            return checkpoint(self._forward)(x, mod, pos, mask, generator=generator)

        return self._forward(x, mod, pos, mask, generator)


class DiT(nn.Module):
    r"""Creates a modulated DiT-like module.

    Arguments:
        in_channels: The number of input channels :math:`C_i`.
        out_channels: The number of output channels :math:`C_o`.
        cond_channels: The number of condition channels :math:`C_c`.
        mod_features: The number of modulating features :math:`D`.
        pos_channels: The number of positional channels :math:`P`.
        hid_channels: The number of hidden token channels :math:`C_h`.
        hid_blocks: The number of hidden transformer blocks.
        device: The device of the parameters. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters. Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`).
        kwargs: Keyword arguments passed to :class:`DiTBlock`.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        cond_channels: int = 0,
        mod_features: int = 0,
        pos_channels: int = 1,
        hid_channels: int = 1024,
        hid_blocks: int = 3,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
        **kwargs,
    ) -> None:
        super().__init__()

        device = default_device(device)
        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.in_proj = Linear(in_channels + cond_channels, hid_channels, **factory)
        self.out_proj = Linear(hid_channels, out_channels, **factory)

        self.pos_encoding = SineEncoding(hid_channels, omega=1e2)
        self.pos_proj = Linear(pos_channels * hid_channels, hid_channels, bias=False, **factory)
        with torch.no_grad():
            self.pos_proj.weight.mul_(1e-2)

        self.blocks = nn.ModuleList(
            DiTBlock(
                channels=hid_channels,
                pos_channels=pos_channels,
                mod_features=mod_features,
                **factory,
                **kwargs,
            )
            for _ in range(hid_blocks)
        )

    def forward(
        self,
        x: Tensor,
        mod: Tensor | None = None,
        pos: Tensor | None = None,
        cond: Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> Tensor:
        r"""
        Arguments:
            x: The input tensor, with shape :math:`(*, L, C_i)`.
            mod: The modulation vector, with shape :math:`(D)` or :math:`(*, D)`.
            pos: The position tensor, with shape :math:`(*, L, P)`.
                If :py:`None`, use the sequence indices instead.
            cond: The condition tensor, with shape :math:`(*, L, C_c)`.
            generator: The generator of the dropout, which it enables
                (training; the JAX `key`), drawn from by each block in turn,
                as JAX splits one key per block.

        Returns:
            The output tensor, with shape :math:`(*, L, C_o)`.
        """

        if cond is not None:
            x = torch.cat((x, cond), dim=-1)

        x = self.in_proj(x)

        if pos is None:
            pos = torch.arange(x.shape[-2], device=x.device).to(x.dtype)[..., None]

        emb = self.pos_encoding(pos)
        emb = emb.flatten(-2)
        x = x + self.pos_proj(emb)

        for block in self.blocks:
            x = block(x, mod, pos=pos, generator=generator)

        return self.out_proj(x)
