r"""ADM (guided-diffusion) UNet backbone, channels-last.

Port of :mod:`azula_tpu.models.adm.backbone`: ResBlocks with scale-shift
GroupNorm conditioning, spatial attention at selected downsampling rates (both
QKV head orders), residual up/down-sampling blocks and class embeddings.
Module names and container indices follow the JAX package (and the
checkpoints), so :func:`azula_tpu_torch.models.adm.convert.from_jax_state_dict`
is a mechanical walk.

The JAX package feeds the skip connection of each output stage to its first
ResBlock as a *virtual* concatenation (two GroupNorms and two convolutions
whose sums equal those of the concatenation). Here the two parts are
concatenated (`torch.cat`) and run through one GroupNorm and one convolution:
groups never straddle the boundary, so the result is the same up to the
rounding of the convolution's sum.
"""

from __future__ import annotations

__all__ = [
    "ADMUNet",
    "timestep_embedding",
]

import functools
import math
import torch
import torch.nn.functional as F

from collections.abc import Sequence
from torch import Tensor, nn

from ...nn.layers import Conv, Dropout, GroupNorm, Linear
from ...nn.utils import checkpoint
from ...ops.attention import dot_product_attention
from ...ops.norm import group_norm_silu
from ...ops.residual import residual_add
from ...utils.profiling import annotate


def timestep_embedding(t: Tensor, dim: int, max_period: float = 10000.0) -> Tensor:
    r"""Sinusoidal timestep embedding, cosine components first.

    Arguments:
        t: Timestep indices (may be fractional), with shape :math:`(B,)`.
        dim: The embedding dimension.

    Returns:
        Embeddings with shape :math:`(B, \text{dim})`, float32.
    """

    half = dim // 2

    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[..., None].float() * freqs

    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)

    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)

    return emb


def _conv3(in_ch: int, out_ch: int, *, stride: int = 1, **factory) -> Conv:
    return Conv(
        in_ch,
        out_ch,
        kernel_size=(3, 3),
        stride=(stride, stride),
        padding=((1, 1), (1, 1)),
        **factory,
    )


def _zero(module: Conv | Linear) -> Conv | Linear:
    with torch.no_grad():
        module.weight.zero_()
        if module.bias is not None:
            module.bias.zero_()
    return module


def _norm(channels: int, device=None, dtype=None) -> GroupNorm:
    # guided-diffusion GroupNorm32: 32 groups, affine, float32 statistics
    return GroupNorm(32, channels, eps=1e-5, affine=True, device=device, dtype=dtype)


def _upsample2(x: Tensor) -> Tensor:
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)


def _avgpool2(x: Tensor) -> Tensor:
    # sums each 2 x 2 window in float32 and rounds once, as the JAX reshape-mean
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class ADMUpsample(nn.Module):
    r"""Nearest x2 upsampling with optional 3x3 convolution."""

    def __init__(
        self, channels: int, use_conv: bool, out_channels: int | None = None, **factory
    ) -> None:
        super().__init__()

        out_channels = out_channels or channels
        self.conv = _conv3(channels, out_channels, **factory) if use_conv else None

    def forward(self, x: Tensor, emb: Tensor | None = None, generator=None) -> Tensor:
        x = _upsample2(x)
        if self.conv is not None:
            x = self.conv(x)
        return x


class ADMDownsample(nn.Module):
    r"""Stride-2 convolution or average pooling."""

    def __init__(
        self, channels: int, use_conv: bool, out_channels: int | None = None, **factory
    ) -> None:
        super().__init__()

        out_channels = out_channels or channels
        self.op = _conv3(channels, out_channels, stride=2, **factory) if use_conv else None

    def forward(self, x: Tensor, emb: Tensor | None = None, generator=None) -> Tensor:
        if self.op is not None:
            return self.op(x)
        return _avgpool2(x)


class ADMResBlock(nn.Module):
    r"""Residual block with timestep-embedding conditioning.

    With `use_scale_shift_norm`, the embedding modulates the second GroupNorm
    FiLM-style: :math:`h \gets \mathrm{norm}(h) (1 + s) + b`.
    """

    def __init__(
        self,
        channels: int,
        emb_channels: int,
        dropout: float = 0.0,
        out_channels: int | None = None,
        use_conv: bool = False,
        use_scale_shift_norm: bool = False,
        up: bool = False,
        down: bool = False,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408
        out_channels = out_channels or channels

        self.use_scale_shift_norm = use_scale_shift_norm
        self.updown = "up" if up else "down" if down else None

        self.in_norm = _norm(channels, device, dtype)
        self.in_conv = _conv3(channels, out_channels, **factory)

        self.emb_lin = Linear(
            emb_channels,
            2 * out_channels if use_scale_shift_norm else out_channels,
            **factory,
        )

        self.out_norm = _norm(out_channels, device, dtype)
        self.drop = Dropout(dropout)
        self.out_conv = _zero(_conv3(out_channels, out_channels, **factory))

        if out_channels == channels:
            self.skip = None
        elif use_conv:
            self.skip = _conv3(channels, out_channels, **factory)
        else:
            self.skip = Conv(channels, out_channels, kernel_size=(1, 1), **factory)

    def forward(
        self,
        x: Tensor | tuple[Tensor, ...],
        emb: Tensor,
        generator: torch.Generator | None = None,
    ) -> Tensor:
        r"""`x` may be a tuple of channel parts (the UNet skip pathway), which
        are concatenated along the channel axis."""

        if isinstance(x, tuple):
            x = torch.cat(x, dim=-1)

        h = group_norm_silu(
            x,
            self.in_norm.groups,
            eps=self.in_norm.eps,
            scale=self.in_norm.weight,
            bias=self.in_norm.bias,
        )

        if self.updown == "up":
            h, x = _upsample2(h), _upsample2(x)
        elif self.updown == "down":
            h, x = _avgpool2(h), _avgpool2(x)

        h = self.in_conv(h)

        emb_out = self.emb_lin(F.silu(emb)).to(h.dtype)

        # GroupNorm + scale-shift modulation + SiLU in one fused op
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = group_norm_silu(
                h,
                self.out_norm.groups,
                eps=self.out_norm.eps,
                scale=self.out_norm.weight,
                bias=self.out_norm.bias,
                mod_scale=scale,
                mod_shift=shift,
            )
        else:
            h = group_norm_silu(
                h + emb_out[:, None, None, :],  # broadcast over spatial (channels-last)
                self.out_norm.groups,
                eps=self.out_norm.eps,
                scale=self.out_norm.weight,
                bias=self.out_norm.bias,
            )

        h = self.drop(h, generator)

        # the convolutions without their biases, which the residual sum adds
        # in the same pass (cuDNN adds a bias in a broadcast pass of its own)
        h, b_out = self.out_conv(h, defer_bias=True)
        if self.skip is None:
            skip, b_skip = x, None
        else:
            skip, b_skip = self.skip(x, defer_bias=True)

        return residual_add(skip, h, b_out, b_skip)


class ADMAttentionBlock(nn.Module):
    r"""Spatial self-attention over flattened positions, both QKV channel orders:

    - legacy (`use_new_attention_order=False`): channels grouped head-major,
      `H x (q, k, v)`;
    - new: grouped qkv-major, `(q, k, v) x H`.
    """

    def __init__(
        self,
        channels: int,
        num_heads: int = 1,
        num_head_channels: int = -1,
        use_new_attention_order: bool = False,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        if num_head_channels == -1:
            self.heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(f"{channels} channels do not split into heads of {num_head_channels}")
            self.heads = channels // num_head_channels

        self.new_order = use_new_attention_order

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.norm = _norm(channels, device, dtype)
        self.qkv = Linear(channels, 3 * channels, **factory)
        self.proj = _zero(Linear(channels, channels, **factory))

    def forward(self, x: Tensor, emb: Tensor | None = None, generator=None) -> Tensor:
        B, *spatial, C = x.shape
        H = self.heads
        ch = C // H

        t = x.reshape(B, -1, C)
        T = t.shape[1]

        qkv = self.qkv(self.norm(t))

        if self.new_order:
            qkv = qkv.reshape(B, T, 3, H, ch)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            qkv = qkv.reshape(B, T, H, 3, ch)
            q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]

        # (B, T, H, ch) -> (B, H, T, ch)
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))

        a = dot_product_attention(q, k, v)

        a = a.transpose(1, 2).reshape(B, T, C)
        a = self.proj(a)

        return (t + a).reshape(B, *spatial, C)


def _span(layers: nn.ModuleList) -> str:
    r"""The span of a block of the UNet: its layers' classes, as
    `azula.block.ADMResBlock+ADMAttentionBlock`."""

    return "azula.block." + "+".join(type(m).__name__ for m in layers)


class ADMUNet(nn.Module):
    r"""The full ADM UNet with attention and timestep embedding, channels-last.

    Arguments:
        image_size: The image size (kept for the card's signature).
        in_channels: Input channels.
        model_channels: Base channel count.
        out_channels: Output channels.
        num_res_blocks: Residual blocks per downsampling level.
        attention_resolutions: Downsample *rates* (`ds` values) at which
            attention runs.
        dropout: Dropout rate.
        channel_mult: Channel multiplier per level.
        conv_resample: Learned convs for up/downsampling.
        num_classes: If set, class-conditional with this many classes.
        num_heads / num_head_channels / num_heads_upsample: Attention head config.
        use_scale_shift_norm: FiLM-style conditioning.
        resblock_updown: Residual blocks for up/downsampling.
        use_new_attention_order: QKV channel order (see :class:`ADMAttentionBlock`).
        checkpointing: Recompute each input, middle and output stage in the
            backward pass (training), through
            :func:`azula_tpu_torch.nn.utils.checkpoint`, which replays the
            dropout's generator.
        device: The device of the parameters. Defaults to the card.
        dtype: The dtype of the parameters.
        generator: The generator of the initial parameters (the JAX `key`).
    """

    def __init__(
        self,
        image_size: int,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int],
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        num_classes: int | None = None,
        num_heads: int = 1,
        num_head_channels: int = -1,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        use_new_attention_order: bool = False,
        checkpointing: bool = False,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        if device is None:
            device = torch.device("cuda")
        if num_heads_upsample == -1:
            num_heads_upsample = num_heads

        self.model_channels = model_channels
        self.num_classes = num_classes
        self.checkpointing = checkpointing

        attention_resolutions = set(attention_resolutions)
        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        time_embed_dim = model_channels * 4
        self.time_embed = nn.ModuleList([
            Linear(model_channels, time_embed_dim, **factory),
            Linear(time_embed_dim, time_embed_dim, **factory),
        ])

        if num_classes is not None:
            self.label_emb = nn.Parameter(
                torch.randn(
                    num_classes, time_embed_dim, device=device, dtype=dtype, generator=generator
                )
            )
        else:
            self.label_emb = None

        res_kwargs = dict(  # noqa: C408
            emb_channels=time_embed_dim,
            dropout=dropout,
            use_scale_shift_norm=use_scale_shift_norm,
            **factory,
        )

        def attn(ch, heads):
            return ADMAttentionBlock(
                ch,
                num_heads=heads,
                num_head_channels=num_head_channels,
                use_new_attention_order=use_new_attention_order,
                **factory,
            )

        ch = input_ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([nn.ModuleList([_conv3(in_channels, ch, **factory)])])
        input_block_chans = [ch]
        ds = 1

        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ADMResBlock(ch, out_channels=int(mult * model_channels), **res_kwargs)]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(attn(ch, num_heads))
                self.input_blocks.append(nn.ModuleList(layers))
                input_block_chans.append(ch)
            if level != len(channel_mult) - 1:
                out_ch = ch
                self.input_blocks.append(nn.ModuleList([
                    ADMResBlock(ch, out_channels=out_ch, down=True, **res_kwargs)
                    if resblock_updown
                    else ADMDownsample(ch, conv_resample, out_channels=out_ch, **factory)
                ]))
                ch = out_ch
                input_block_chans.append(ch)
                ds *= 2

        self.middle_block = nn.ModuleList([
            ADMResBlock(ch, **res_kwargs),
            attn(ch, num_heads),
            ADMResBlock(ch, **res_kwargs),
        ])

        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                ich = input_block_chans.pop()
                layers = [
                    ADMResBlock(ch + ich, out_channels=int(model_channels * mult), **res_kwargs)
                ]
                ch = int(model_channels * mult)
                if ds in attention_resolutions:
                    layers.append(attn(ch, num_heads_upsample))
                if level and i == num_res_blocks:
                    out_ch = ch
                    layers.append(
                        ADMResBlock(ch, out_channels=out_ch, up=True, **res_kwargs)
                        if resblock_updown
                        else ADMUpsample(ch, conv_resample, out_channels=out_ch, **factory)
                    )
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out_norm = _norm(ch, device, dtype)
        self.out_conv = _zero(_conv3(input_ch, out_channels, **factory))

        # the span of each block in `forward`
        self._spans = (
            [_span(layers) for layers in self.input_blocks],
            _span(self.middle_block),
            [_span(layers) for layers in self.output_blocks],
        )

    def forward(
        self,
        x: Tensor,
        timesteps: Tensor,
        y: Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> Tensor:
        r"""
        Arguments:
            x: Input images, channels-last, with shape :math:`(B, H, W, C)`.
            timesteps: Timestep indices (fractional ok), with shape :math:`(B,)`
                or :math:`()`.
            y: Class labels, with shape :math:`(B,)` (class-conditional only).
            generator: The generator of the dropout, which it enables
                (training; the JAX `key`).

        Returns:
            The output tensor, with shape :math:`(B, H, W, C_o)`.
        """

        if (y is not None) != (self.num_classes is not None):
            raise ValueError("y must be given iff the model is class-conditional")

        timesteps = torch.atleast_1d(torch.as_tensor(timesteps, device=x.device))
        timesteps = timesteps.expand(x.shape[0])

        emb = timestep_embedding(timesteps, self.model_channels).to(x.dtype)
        emb = self.time_embed[1](F.silu(self.time_embed[0](emb)))

        if self.num_classes is not None:
            emb = emb + self.label_emb[y].to(emb.dtype)

        def stage(layers, h, emb, generator=None):
            for layer in layers:
                h = layer(h, emb, generator=generator)
            return h

        def run(layers, h, span):
            with annotate(span):
                if self.checkpointing and torch.is_grad_enabled():
                    return checkpoint(functools.partial(stage, layers))(h, emb, generator=generator)
                return stage(layers, h, emb, generator)

        inputs, middle, outputs = self._spans
        hs = []
        h = x

        for i, (layers, span) in enumerate(zip(self.input_blocks, inputs)):
            if i > 0:
                h = run(layers, h, span)
            else:
                with annotate(span):
                    h = layers[0](h)
            hs.append(h)

        h = run(self.middle_block, h, middle)

        for layers, span in zip(self.output_blocks, outputs):
            h = run(layers, (h, hs.pop()), span)

        h = h.to(x.dtype)
        h = F.silu(self.out_norm(h))

        return self.out_conv(h)
