r"""Sana linear-attention DiT, channels-last.

Port of :mod:`azula_tpu.models.sana.backbone` (diffusers
``SanaTransformer2DModel`` semantics): ReLU linear self-attention in float32
(:math:`O(L)` in the sequence length), softmax cross-attention over the
Gemma prompt embeddings (with the prompt mask an einsum softmax under a
-10000 bias; without one `dot_product_attention`, whose route for
:math:`L \neq S` is the plain one), the MobileNet-style gated convolutional
feed-forward (GLUMBConv, its 3x3 depthwise), and PixArt-style single AdaLN
with per-block learned scale-shift tables.

The modules keep the diffusers key names of the Sana `transformer/`
checkpoints (`patch_embed.proj`, `time_embed.emb.timestep_embedder`,
`time_embed.linear`, `attn1.to_out.0`, the RMSNorm `weight`), which are the
manifests' and which the JAX package's `convert_sana_state_dict` maps onto
its own; :mod:`.convert` maps the JAX arrays here.
"""

from __future__ import annotations

__all__ = [
    "SanaTransformer",
]

import math
import torch
import torch.nn.functional as F

from torch import Tensor, nn

from ...nn.layers import Conv, LayerNorm, Linear
from ...nn.utils import default_device
from ...ops.attention import dot_product_attention
from ..flux.backbone import MLPEmbedder, sinusoidal_timestep_embedding


def depthwise(x: Tensor, conv: Conv, groups: int | None = None) -> Tensor:
    r"""`conv`'s weight, with shape :math:`(C_o, C_i / G, k, k)`, applied to a
    channels-last `x` as a grouped convolution (`groups` defaults to the
    channels: depthwise) with its symmetric padding, without its bias."""

    C = x.shape[-1]
    pad = conv.padding[0][0]
    y = F.conv2d(x.movedim(-1, 1), conv.weight.to(x.dtype), padding=pad, groups=C if groups is None else groups)

    return y.movedim(1, -1)


class AffineRMSNorm(nn.Module):
    r"""RMSNorm with a learned scale (diffusers `RMSNorm`, elementwise
    affine): float32 statistics, the result cast to the input dtype and then
    scaled."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None, dtype=None, generator=None) -> None:
        super().__init__()

        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        h = x.float()
        h = h * torch.rsqrt(torch.square(h).mean(dim=-1, keepdim=True) + self.eps)

        return h.to(x.dtype) * self.weight.to(x.dtype)


class CaptionProjection(nn.Module):
    r"""The prompt-embedding projection (diffusers `PixArtAlphaTextProjection`
    with ``act_fn='gelu_tanh'``)."""

    def __init__(self, in_dim: int, dim: int, **factory) -> None:
        super().__init__()

        self.linear_1 = Linear(in_dim, dim, **factory)
        self.linear_2 = Linear(dim, dim, **factory)

    def forward(self, x: Tensor) -> Tensor:
        return self.linear_2(F.gelu(self.linear_1(x), approximate="tanh"))


class SanaLinearAttention(nn.Module):
    r"""ReLU linear attention (diffusers `SanaLinearAttnProcessor2_0`),
    :math:`\mathrm{out} = \frac{\phi(q) (\phi(k)^T v)}{\phi(q) \sum_l
    \phi(k_l)}` with :math:`\phi = \mathrm{relu}`, in float32: the
    denominator is the product with a ones column appended to v, plus 1e-15.
    SANA 1.5 adds across-heads RMS q/k normalization."""

    def __init__(self, dim: int, heads: int, head_dim: int, qk_norm: bool = False, **factory) -> None:
        super().__init__()

        inner = heads * head_dim

        self.heads = heads
        self.to_q = Linear(dim, inner, bias=False, **factory)
        self.to_k = Linear(dim, inner, bias=False, **factory)
        self.to_v = Linear(dim, inner, bias=False, **factory)
        self.to_out = nn.ModuleList([Linear(inner, dim, **factory)])

        self.norm_q = AffineRMSNorm(inner, eps=1e-5, **factory) if qk_norm else None
        self.norm_k = AffineRMSNorm(inner, eps=1e-5, **factory) if qk_norm else None

    def forward(self, x: Tensor) -> Tensor:
        B, L, _ = x.shape
        H = self.heads

        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)

        if self.norm_q is not None:
            q, k = self.norm_q(q), self.norm_k(k)

        q = F.relu(q).reshape(B, L, H, -1).float()
        k = F.relu(k).reshape(B, L, H, -1).float()
        v = v.reshape(B, L, H, -1).float()

        # k^T v and k^T 1 in one contraction (a ones column appended to v)
        v1 = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
        scores = torch.einsum("blhd,blhe->bhde", k, v1)  # (B, H, d, d + 1)
        out = torch.einsum("blhd,bhde->blhe", q, scores)  # (B, L, H, d + 1)

        out = out[..., :-1] / (out[..., -1:] + 1e-15)
        out = out.reshape(B, L, -1).to(x.dtype)

        return self.to_out[0](out)


class SanaCrossAttention(nn.Module):
    r"""Softmax cross-attention over the prompt embeddings, with an additive
    mask bias and optional across-heads RMS q/k normalization (SANA 1.5)."""

    def __init__(self, dim: int, heads: int, head_dim: int, qk_norm: bool = False, **factory) -> None:
        super().__init__()

        inner = heads * head_dim

        self.heads = heads
        self.to_q = Linear(dim, inner, **factory)
        self.to_k = Linear(dim, inner, **factory)
        self.to_v = Linear(dim, inner, **factory)
        self.to_out = nn.ModuleList([Linear(inner, dim, **factory)])

        self.norm_q = AffineRMSNorm(inner, eps=1e-5, **factory) if qk_norm else None
        self.norm_k = AffineRMSNorm(inner, eps=1e-5, **factory) if qk_norm else None

    def forward(self, x: Tensor, context: Tensor, mask: Tensor | None = None) -> Tensor:
        B, L, _ = x.shape
        S = context.shape[1]
        H = self.heads

        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)

        if self.norm_q is not None:
            q, k = self.norm_q(q), self.norm_k(k)

        q = q.reshape(B, L, H, -1).transpose(1, 2)
        k = k.reshape(B, S, H, -1).transpose(1, 2)
        v = v.reshape(B, S, H, -1).transpose(1, 2)

        if mask is not None:
            # an additive bias of -10000 on the masked-out positions (diffusers)
            bias = (1.0 - mask.float()) * -10000.0
            logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
            logits = logits + bias[:, None, None, :]
            weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)
            a = torch.matmul(weights, v)
        else:
            a = dot_product_attention(q, k, v)

        a = a.transpose(1, 2).reshape(B, L, -1)

        return self.to_out[0](a)


class GLUMBConv(nn.Module):
    r"""MobileNet-style gated convolutional feed-forward: 1x1 expansion, 3x3
    depthwise, GLU gate, 1x1 projection (no bias on the projection)."""

    def __init__(self, dim: int, mlp_ratio: float = 2.5, **factory) -> None:
        super().__init__()

        hidden = int(dim * mlp_ratio)

        self.conv_inverted = Conv(dim, 2 * hidden, kernel_size=(1, 1), **factory)
        # depthwise: weight (2 hidden, 1, 3, 3), as diffusers stores it
        self.conv_depth = Conv(1, 2 * hidden, kernel_size=(3, 3), padding=((1, 1), (1, 1)), **factory)
        self.conv_point = Conv(hidden, dim, kernel_size=(1, 1), bias=False, **factory)

    def forward(self, x: Tensor) -> Tensor:
        h = F.silu(self.conv_inverted(x))
        h = depthwise(h, self.conv_depth) + self.conv_depth.bias.to(h.dtype)
        h, gate = h.chunk(2, dim=-1)
        h = h * F.silu(gate)

        return self.conv_point(h)


class SanaTransformerBlock(nn.Module):
    def __init__(
        self,
        dim: int,
        heads: int,
        head_dim: int,
        cross_heads: int,
        cross_head_dim: int,
        mlp_ratio: float = 2.5,
        qk_norm: bool = False,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.norm1 = LayerNorm(eps=1e-6)
        self.attn1 = SanaLinearAttention(dim, heads, head_dim, qk_norm, **factory)
        self.attn2 = SanaCrossAttention(dim, cross_heads, cross_head_dim, qk_norm, **factory)
        self.norm2 = LayerNorm(eps=1e-6)
        self.ff = GLUMBConv(dim, mlp_ratio, **factory)

        self.scale_shift_table = _table((6, dim), device, dtype, generator)

    def forward(
        self, x: Tensor, context: Tensor, context_mask: Tensor | None, timestep: Tensor, H: int, W: int
    ) -> Tensor:
        B, L, C = x.shape

        table = (self.scale_shift_table[None] + timestep.reshape(B, 6, -1)).to(x.dtype)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (table[:, i : i + 1] for i in range(6))

        h = self.norm1(x) * (1 + scale_msa) + shift_msa
        x = x + gate_msa * self.attn1(h)

        x = x + self.attn2(x, context, context_mask)

        h = self.norm2(x) * (1 + scale_mlp) + shift_mlp
        h = self.ff(h.reshape(B, H, W, C)).reshape(B, L, C)

        return x + gate_mlp * h


def _table(shape: tuple[int, int], device, dtype, generator) -> nn.Parameter:
    r"""A learned scale-shift table, drawn :math:`\mathcal{N}(0, 1 / d)`."""

    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(0.0, 1 / math.sqrt(shape[-1]), generator=generator)
    return nn.Parameter(w)


class SanaTransformer(nn.Module):
    r"""The Sana linear DiT (diffusers ``SanaTransformer2DModel`` semantics).

    Defaults correspond to Sana 1.6B; :data:`~azula_tpu_torch.models.sana.ARCHS`
    lists the other sizes.

    Arguments:
        in_channels: Latent channels (DC-AE: 32).
        out_channels: Output channels.
        num_attention_heads, attention_head_dim: The linear self-attention's shape.
        num_cross_attention_heads, cross_attention_head_dim: The cross-attention's shape.
        caption_channels: The width of the prompt embeddings (Gemma: 2304).
        num_layers: The depth.
        patch_size: The latent patch size (1 for the 1024-px models).
        mlp_ratio: GLUMBConv's expansion.
        qk_norm: Across-heads RMS q/k normalization (SANA 1.5 checkpoints).
        device: The parameters' device; the card unless another is named.
        dtype, generator: The parameters' dtype and initial-value generator.
    """

    def __init__(
        self,
        in_channels: int = 32,
        out_channels: int = 32,
        num_attention_heads: int = 70,
        attention_head_dim: int = 32,
        num_cross_attention_heads: int = 20,
        cross_attention_head_dim: int = 112,
        caption_channels: int = 2304,
        num_layers: int = 20,
        patch_size: int = 1,
        mlp_ratio: float = 2.5,
        qk_norm: bool = False,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        device = default_device(device)
        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408
        dim = num_attention_heads * attention_head_dim

        self.patch_size = patch_size
        self.dim = dim

        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv(
            in_channels, dim, kernel_size=(patch_size, patch_size), stride=(patch_size, patch_size), **factory
        )

        # AdaLayerNormSingle: sinusoidal(256) -> MLP -> SiLU -> a 6 dim table
        self.time_embed = nn.Module()
        self.time_embed.emb = nn.Module()
        self.time_embed.emb.timestep_embedder = MLPEmbedder(256, dim, **factory)
        self.time_embed.linear = Linear(dim, 6 * dim, **factory)

        self.caption_projection = CaptionProjection(caption_channels, dim, **factory)
        self.caption_norm = AffineRMSNorm(dim, eps=1e-5, **factory)

        self.transformer_blocks = nn.ModuleList([
            SanaTransformerBlock(
                dim,
                num_attention_heads,
                attention_head_dim,
                num_cross_attention_heads,
                cross_attention_head_dim,
                mlp_ratio,
                qk_norm,
                **factory,
            )
            for _ in range(num_layers)
        ])

        self.scale_shift_table = _table((2, dim), device, dtype, generator)
        self.norm_out = LayerNorm(eps=1e-6)
        self.proj_out = Linear(dim, patch_size * patch_size * out_channels, **factory)

    def forward(
        self,
        hidden_states: Tensor,
        timestep: Tensor,
        encoder_hidden_states: Tensor,
        encoder_attention_mask: Tensor | None = None,
        **kwargs,
    ) -> Tensor:
        r"""
        Arguments:
            hidden_states: Noisy latents, channels-last, with shape :math:`(B, H, W, C)`.
            timestep: Scaled timesteps, with shape :math:`(B,)`.
            encoder_hidden_states: Gemma embeddings, with shape :math:`(B, L, D)`.
            encoder_attention_mask: The prompt mask, with shape :math:`(B, L)`.

        Returns:
            The prediction, with shape :math:`(B, H, W, C_o)`.
        """

        B, H, W, _ = hidden_states.shape
        p = self.patch_size
        Hp, Wp = H // p, W // p

        x = self.patch_embed.proj(hidden_states).reshape(B, Hp * Wp, self.dim)

        t_proj = sinusoidal_timestep_embedding(timestep.float(), 256).to(x.dtype)
        embedded_timestep = self.time_embed.emb.timestep_embedder(t_proj)
        timestep_table = self.time_embed.linear(F.silu(embedded_timestep))

        context = self.caption_norm(self.caption_projection(encoder_hidden_states))

        for block in self.transformer_blocks:
            x = block(x, context, encoder_attention_mask, timestep_table, Hp, Wp)

        table = (self.scale_shift_table[None] + embedded_timestep[:, None]).to(x.dtype)
        shift, scale = table[:, 0:1], table[:, 1:2]

        x = self.norm_out(x) * (1 + scale) + shift
        x = self.proj_out(x)

        # unpatchify
        C = x.shape[-1] // (p * p)
        x = x.reshape(B, Hp, Wp, p, p, C).permute(0, 1, 3, 2, 4, 5)

        return x.reshape(B, H, W, C)
