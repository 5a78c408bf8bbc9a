r"""Stable Diffusion UNet backbone, channels-last.

Port of :mod:`azula_tpu.models.sd.backbone` (diffusers
``UNet2DConditionModel`` semantics): ResNet blocks with additive timestep
conditioning, cross-attention transformer stages conditioned on CLIP prompt
embeddings, and skip connections collected per layer.

Every GroupNorm goes through :func:`~azula_tpu_torch.ops.norm.group_norm`
(on the card the GroupNorm kernel) and SiLU is a separate `F.silu` after it,
as the JAX package applies `jax.nn.silu` after the norm. Attention goes
through :func:`~azula_tpu_torch.ops.attention.dot_product_attention` on
(B, H, L, D) heads: on the card SD 2's self-attention (D = 64) takes the
attention kernel; cross-attention (77 keys) and SD 1's heads (D = 40, 80,
160) take the plain route, as JAX takes XLA.

The modules keep the diffusers key names of the SD `unet/` checkpoints
(`time_embedding.linear_1`, `attn1.to_out.0`, `ff.net.0.proj`, `ff.net.2`,
`downsamplers.0.conv`), which are the manifests' and which the JAX
package's `convert_unet_state_dict` maps onto its own; :mod:`.convert` maps
the JAX arrays here.
"""

from __future__ import annotations

__all__ = [
    "SDUNet",
    "sinusoidal_timestep_embedding",
]

import math
import torch
import torch.nn.functional as F

from collections.abc import Sequence
from torch import Tensor, nn

from ...nn.layers import Conv, GroupNorm, Linear
from ...nn.utils import default_device
from ...ops.attention import dot_product_attention
from ..clip import _LayerNorm


def sinusoidal_timestep_embedding(
    t: Tensor,
    dim: int,
    max_period: float = 10000.0,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
) -> Tensor:
    r"""Sinusoidal timestep embedding with diffusers' conventions
    (`get_timestep_embedding`): exponents :math:`-\log(P) i / (d/2 - s)`, sine
    components first unless flipped (SD uses ``flip_sin_to_cos=True``).

    Arguments:
        t: Timestep values (may be fractional), with shape :math:`(B,)`.
        dim: The embedding dimension.

    Returns:
        Embeddings with shape :math:`(B, \text{dim})`, float32.
    """

    half = dim // 2

    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - freq_shift)
    )
    args = t[..., None].float() * freqs

    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)

    if flip_sin_to_cos:
        emb = torch.cat([emb[..., half:], emb[..., :half]], dim=-1)

    return emb


class AffineLayerNorm(_LayerNorm):
    r"""Layer normalization with learned `weight` and `bias` over the last
    dimension (`torch.nn.LayerNorm`), statistics and affine in float32."""


def _conv(in_ch: int, out_ch: int, k: int = 3, stride: int = 1, **factory) -> Conv:
    pad = (k - 1) // 2
    return Conv(in_ch, out_ch, kernel_size=(k, k), stride=(stride, stride), padding=((pad, pad), (pad, pad)), **factory)


def _norm(channels: int, eps: float, device=None, dtype=None) -> GroupNorm:
    return GroupNorm(32, channels, eps=eps, affine=True, device=device, dtype=dtype)


class ResnetBlock2D(nn.Module):
    r"""Diffusers-style residual block: GN-SiLU-conv + additive time embedding,
    GN-SiLU-conv, 1x1 shortcut on channel change."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: int | None = None,
        eps: float = 1e-5,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.norm1 = _norm(in_channels, eps, device, dtype)
        self.conv1 = _conv(in_channels, out_channels, **factory)
        self.time_emb_proj = Linear(temb_channels, out_channels, **factory) if temb_channels is not None else None
        self.norm2 = _norm(out_channels, eps, device, dtype)
        self.conv2 = _conv(out_channels, out_channels, **factory)

        if in_channels != out_channels:
            self.conv_shortcut = Conv(in_channels, out_channels, kernel_size=(1, 1), **factory)
        else:
            self.conv_shortcut = None

    def forward(self, x: Tensor, temb: Tensor | None = None) -> Tensor:
        h = self.conv1(F.silu(self.norm1(x)))

        if self.time_emb_proj is not None and temb is not None:
            t = self.time_emb_proj(F.silu(temb)).to(h.dtype)
            h = h + t[:, None, None, :]

        h = self.conv2(F.silu(self.norm2(h)))

        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)

        return skip + h


class CrossAttention(nn.Module):
    r"""Multi-head attention with optional cross-attention context
    (diffusers `Attention`): unbiased q/k/v projections, biased output."""

    def __init__(
        self,
        query_dim: int,
        context_dim: int | None = None,
        heads: int = 8,
        dim_head: int | None = None,
        **factory,
    ) -> None:
        super().__init__()

        context_dim = context_dim or query_dim
        inner = heads * (dim_head if dim_head is not None else query_dim // heads)

        self.heads = heads
        self.to_q = Linear(query_dim, inner, bias=False, **factory)
        self.to_k = Linear(context_dim, inner, bias=False, **factory)
        self.to_v = Linear(context_dim, inner, bias=False, **factory)
        self.to_out = nn.ModuleList([Linear(inner, query_dim, **factory)])

    def forward(self, x: Tensor, context: Tensor | None = None) -> Tensor:
        context = x if context is None else context

        B, L, _ = x.shape
        S = context.shape[-2]

        q = self.to_q(x).reshape(B, L, self.heads, -1).transpose(1, 2)
        k = self.to_k(context).reshape(B, S, self.heads, -1).transpose(1, 2)
        v = self.to_v(context).reshape(B, S, self.heads, -1).transpose(1, 2)

        a = dot_product_attention(q, k, v)

        return self.to_out[0](a.transpose(1, 2).reshape(B, L, -1))


class GEGLU(nn.Module):
    r"""The gated projection of the feed-forward: :math:`h, g = W x`,
    :math:`h \cdot \mathrm{gelu}(g)` (exact, erf-based)."""

    def __init__(self, dim: int, inner: int, **factory) -> None:
        super().__init__()

        self.proj = Linear(dim, 2 * inner, **factory)

    def forward(self, x: Tensor) -> Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)

        return h * F.gelu(gate)


class GEGLUFeedForward(nn.Module):
    r"""GEGLU feed-forward (diffusers `FeedForward` with `geglu` activation):
    :math:`y = W_o (h \cdot \mathrm{gelu}(g))`. `net` keeps the checkpoint's
    indices: the gated projection at 0, the output at 2 (1 is a dropout
    without parameters)."""

    def __init__(self, dim: int, mult: int = 4, **factory) -> None:
        super().__init__()

        inner = dim * mult

        self.net = nn.ModuleList([GEGLU(dim, inner, **factory), nn.Identity(), Linear(inner, dim, **factory)])

    def forward(self, x: Tensor) -> Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    r"""LayerNorm / self-attention / LayerNorm / cross-attention / LayerNorm /
    GEGLU feed-forward, all with residuals."""

    def __init__(self, dim: int, context_dim: int, heads: int, **factory) -> None:
        super().__init__()

        norm = dict(device=factory.get("device"), dtype=factory.get("dtype"))  # noqa: C408

        self.norm1 = AffineLayerNorm(dim, **norm)
        self.attn1 = CrossAttention(dim, heads=heads, **factory)
        self.norm2 = AffineLayerNorm(dim, **norm)
        self.attn2 = CrossAttention(dim, context_dim=context_dim, heads=heads, **factory)
        self.norm3 = AffineLayerNorm(dim, **norm)
        self.ff = GEGLUFeedForward(dim, **factory)

    def forward(self, x: Tensor, context: Tensor) -> Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        x = x + self.ff(self.norm3(x))

        return x


class Transformer2DModel(nn.Module):
    r"""Spatial transformer: GroupNorm (eps 1e-6), (conv or linear)
    in-projection, flatten to tokens, transformer blocks, out-projection,
    residual.

    SD 1.x uses 1x1-conv projections; SD 2 uses linear ones
    (`use_linear_projection`).
    """

    def __init__(
        self,
        channels: int,
        context_dim: int,
        heads: int,
        depth: int = 1,
        use_linear_projection: bool = False,
        **factory,
    ) -> None:
        super().__init__()

        self.linear = use_linear_projection
        self.norm = _norm(channels, 1e-6, factory.get("device"), factory.get("dtype"))

        if use_linear_projection:
            self.proj_in = Linear(channels, channels, **factory)
            self.proj_out = Linear(channels, channels, **factory)
        else:
            self.proj_in = Conv(channels, channels, kernel_size=(1, 1), **factory)
            self.proj_out = Conv(channels, channels, kernel_size=(1, 1), **factory)

        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, context_dim, heads, **factory) for _ in range(depth)
        ])

    def forward(self, x: Tensor, context: Tensor) -> Tensor:
        B, H, W, C = x.shape
        residual = x

        h = self.norm(x)

        if self.linear:
            h = self.proj_in(h.reshape(B, H * W, C))
        else:
            h = self.proj_in(h).reshape(B, H * W, C)

        for block in self.transformer_blocks:
            h = block(h, context)

        if self.linear:
            h = self.proj_out(h).reshape(B, H, W, C)
        else:
            h = self.proj_out(h.reshape(B, H, W, C))

        return h + residual


class Downsample2D(nn.Module):
    r"""3x3 stride-2 convolution (``downsamplers.0.conv`` in checkpoints)."""

    def __init__(self, channels: int, out_channels: int | None = None, **factory) -> None:
        super().__init__()

        self.conv = _conv(channels, out_channels or channels, stride=2, **factory)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    r"""Nearest x2 upsampling followed by a 3x3 convolution."""

    def __init__(self, channels: int, out_channels: int | None = None, **factory) -> None:
        super().__init__()

        self.conv = _conv(channels, out_channels or channels, **factory)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2))


class DownBlock2D(nn.Module):
    r"""`layers_per_block` resnets (+ optional cross-attention transformers)
    followed by an optional downsampler; every intermediate state is collected
    as a skip."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: int,
        num_layers: int,
        context_dim: int | None = None,
        heads: int = 8,
        add_downsample: bool = True,
        use_linear_projection: bool = False,
        **factory,
    ) -> None:
        super().__init__()

        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels, **factory)
            for i in range(num_layers)
        ])

        if context_dim is not None:
            self.attentions = nn.ModuleList([
                Transformer2DModel(out_channels, context_dim, heads, use_linear_projection=use_linear_projection, **factory)
                for _ in range(num_layers)
            ])
        else:
            self.attentions = None

        self.downsamplers = nn.ModuleList([Downsample2D(out_channels, **factory)]) if add_downsample else None

    def forward(self, x: Tensor, temb: Tensor, context: Tensor) -> tuple[Tensor, list[Tensor]]:
        states = []

        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            states.append(x)

        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            states.append(x)

        return x, states


class UpBlock2D(nn.Module):
    r"""`layers_per_block + 1` resnets, each consuming one skip state, followed
    by an optional upsampler."""

    def __init__(
        self,
        in_channels: int,
        prev_output_channel: int,
        out_channels: int,
        temb_channels: int,
        num_layers: int,
        context_dim: int | None = None,
        heads: int = 8,
        add_upsample: bool = True,
        use_linear_projection: bool = False,
        **factory,
    ) -> None:
        super().__init__()

        resnets = []
        for i in range(num_layers):
            res_skip = in_channels if i == num_layers - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            resnets.append(ResnetBlock2D(res_in + res_skip, out_channels, temb_channels, **factory))
        self.resnets = nn.ModuleList(resnets)

        if context_dim is not None:
            self.attentions = nn.ModuleList([
                Transformer2DModel(out_channels, context_dim, heads, use_linear_projection=use_linear_projection, **factory)
                for _ in range(num_layers)
            ])
        else:
            self.attentions = None

        self.upsamplers = nn.ModuleList([Upsample2D(out_channels, **factory)]) if add_upsample else None

    def forward(self, x: Tensor, skips: list[Tensor], temb: Tensor, context: Tensor) -> Tensor:
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=-1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)

        if self.upsamplers is not None:
            x = self.upsamplers[0](x)

        return x


class MidBlock2DCrossAttn(nn.Module):
    r"""Resnet, cross-attention transformer, resnet."""

    def __init__(
        self,
        channels: int,
        temb_channels: int,
        context_dim: int,
        heads: int,
        use_linear_projection: bool = False,
        **factory,
    ) -> None:
        super().__init__()

        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb_channels, **factory),
            ResnetBlock2D(channels, channels, temb_channels, **factory),
        ])
        self.attentions = nn.ModuleList([
            Transformer2DModel(channels, context_dim, heads, use_linear_projection=use_linear_projection, **factory)
        ])

    def forward(self, x: Tensor, temb: Tensor, context: Tensor) -> Tensor:
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)

        return self.resnets[1](x, temb)


class TimestepEmbedding(nn.Module):
    r"""The two linears of the timestep embedding with a SiLU between them
    (diffusers `TimestepEmbedding`)."""

    def __init__(self, in_features: int, features: int, **factory) -> None:
        super().__init__()

        self.linear_1 = Linear(in_features, features, **factory)
        self.linear_2 = Linear(features, features, **factory)

    def forward(self, x: Tensor) -> Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class SDUNet(nn.Module):
    r"""The SD UNet (diffusers ``UNet2DConditionModel`` semantics), channels-last.

    Defaults correspond to SD 1.x; SD 2 differs by ``cross_attention_dim=1024``,
    ``attention_head_dim=(5, 10, 20, 20)`` and ``use_linear_projection=True``.

    Arguments:
        in_channels: Input (latent) channels.
        out_channels: Output channels.
        block_out_channels: Channel count per resolution level.
        layers_per_block: ResNet blocks per down level.
        cross_attention_dim: The prompt-embedding dimension.
        attention_head_dim: Heads per level (int or per-level sequence; for SD
            checkpoints this config field holds the *head count*, matching the
            diffusers naming quirk).
        cross_attention_levels: Levels with cross-attention transformers.
        use_linear_projection: Linear (SD 2) vs 1x1-conv (SD 1) transformer
            projections.
        freq_shift: Timestep-embedding frequency shift.
        device: The parameters' device; the card unless another is named.
        dtype, generator: The parameters' dtype and initial-value generator.
    """

    def __init__(
        self,
        in_channels: int = 4,
        out_channels: int = 4,
        block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
        layers_per_block: int = 2,
        cross_attention_dim: int = 768,
        attention_head_dim: int | Sequence[int] = 8,
        cross_attention_levels: Sequence[bool] = (True, True, True, False),
        use_linear_projection: bool = False,
        freq_shift: float = 0.0,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408
        n_levels = len(block_out_channels)

        if isinstance(attention_head_dim, int):
            attention_head_dim = (attention_head_dim,) * n_levels
        attention_head_dim = tuple(attention_head_dim)

        self.freq_shift = freq_shift
        self.model_channels = block_out_channels[0]

        temb_dim = 4 * block_out_channels[0]

        self.time_embedding = TimestepEmbedding(block_out_channels[0], temb_dim, **factory)
        self.conv_in = _conv(in_channels, block_out_channels[0], **factory)

        self.down_blocks = nn.ModuleList()
        ch = block_out_channels[0]
        for i, out_ch in enumerate(block_out_channels):
            self.down_blocks.append(
                DownBlock2D(
                    ch,
                    out_ch,
                    temb_dim,
                    num_layers=layers_per_block,
                    context_dim=cross_attention_dim if cross_attention_levels[i] else None,
                    heads=attention_head_dim[i],
                    add_downsample=i < n_levels - 1,
                    use_linear_projection=use_linear_projection,
                    **factory,
                )
            )
            ch = out_ch

        self.mid_block = MidBlock2DCrossAttn(
            block_out_channels[-1],
            temb_dim,
            cross_attention_dim,
            heads=attention_head_dim[-1],
            use_linear_projection=use_linear_projection,
            **factory,
        )

        self.up_blocks = nn.ModuleList()
        reversed_out = tuple(reversed(block_out_channels))
        reversed_attn = tuple(reversed(cross_attention_levels))
        reversed_heads = tuple(reversed(attention_head_dim))
        out_ch = reversed_out[0]
        for i in range(n_levels):
            prev_out = out_ch
            out_ch = reversed_out[i]
            in_ch = reversed_out[min(i + 1, n_levels - 1)]
            self.up_blocks.append(
                UpBlock2D(
                    in_ch,
                    prev_out,
                    out_ch,
                    temb_dim,
                    num_layers=layers_per_block + 1,
                    context_dim=cross_attention_dim if reversed_attn[i] else None,
                    heads=reversed_heads[i],
                    add_upsample=i < n_levels - 1,
                    use_linear_projection=use_linear_projection,
                    **factory,
                )
            )

        self.conv_norm_out = _norm(block_out_channels[0], 1e-5, factory["device"], dtype)
        self.conv_out = _conv(block_out_channels[0], out_channels, **factory)

    def forward(self, sample: Tensor, timestep: Tensor, encoder_hidden_states: Tensor, **kwargs) -> Tensor:
        r"""
        Arguments:
            sample: Noisy latents, channels-last, with shape :math:`(B, H, W, C)`.
            timestep: Timestep indices, with shape :math:`(B,)` or :math:`()`.
            encoder_hidden_states: Prompt embeddings, with shape :math:`(B, L, D)`.

        Returns:
            The predicted noise/velocity, with shape :math:`(B, H, W, C_o)`.
        """

        timestep = torch.atleast_1d(torch.as_tensor(timestep, device=sample.device)).expand(sample.shape[0])

        temb = sinusoidal_timestep_embedding(timestep, self.model_channels, freq_shift=self.freq_shift)
        temb = self.time_embedding(temb.to(sample.dtype))

        context = encoder_hidden_states

        h = self.conv_in(sample)

        skips = [h]
        for block in self.down_blocks:
            h, states = block(h, temb, context)
            skips.extend(states)

        h = self.mid_block(h, temb, context)

        for block in self.up_blocks:
            h = block(h, skips, temb, context)

        return self.conv_out(F.silu(self.conv_norm_out(h)))
