r"""Flux MMDiT transformer.

Port of :mod:`azula_tpu.models.flux.backbone` (diffusers
``FluxTransformer2DModel`` semantics): dual-stream MMDiT blocks over the
(text, image) token sequences, then single-stream blocks over their
concatenation, three-axis rotary position embeddings, and AdaLN-Zero
modulation from a combined timestep, guidance and pooled-text embedding.

The modules keep the diffusers key names of the FLUX.1 `transformer/`
checkpoints (`norm_out.linear`, `ff.net.0.proj`, `ff.net.2`, `attn.to_out.0`,
the RMSNorm `weight`), which the JAX package's converter maps onto its own
(`azula_tpu/models/flux/convert.py`); :mod:`.convert` maps the JAX arrays
here. Every attention is `dot_product_attention(..., max_free=True)`: on the
card at 1024 px (L = 4608) that is the max-free flash kernel.
"""

from __future__ import annotations

__all__ = [
    "FluxTransformer",
]

import math
import torch
import torch.nn.functional as F

from collections.abc import Sequence
from torch import Tensor, nn

from ...nn.layers import LayerNorm, Linear, rms_norm
from ...nn.utils import default_device
from ...ops.attention import dot_product_attention
from ...utils.profiling import annotate


def sinusoidal_timestep_embedding(t: Tensor, dim: int) -> Tensor:
    r"""Sinusoidal timestep embedding with diffusers' conventions
    (`get_timestep_embedding`) as Flux sets them, as
    `azula_tpu.models.sd.backbone` computes them with its defaults: exponents
    :math:`-\log(10^4) i / (d/2)`, cosine components first.

    Arguments:
        t: Timestep values (may be fractional), with shape :math:`(B,)`.
        dim: The embedding dimension.

    Returns:
        Embeddings with shape :math:`(B, \text{dim})`, float32.
    """

    half = dim // 2

    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[..., None].float() * freqs

    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_cos_sin(ids: Tensor, axes_dim: Sequence[int], theta: float = 10000.0) -> tuple[Tensor, Tensor]:
    r"""Three-axis rotary embedding tables (diffusers `FluxPosEmbed`): per axis
    `a` of dimension :math:`d_a`, angles `pos_a / theta^(2i / d_a)`, cos and
    sin repeated over interleaved pairs, concatenated across axes.

    Arguments:
        ids: Positions, with shape :math:`(L, A)`.

    Returns:
        `(cos, sin)` tables, with shape :math:`(L, \sum_a d_a)`, float32.
    """

    cos_parts, sin_parts = [], []

    for a, dim in enumerate(axes_dim):
        freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device) / dim)
        angles = ids[:, a].float()[:, None] * freqs
        cos_parts.append(torch.cos(angles).repeat_interleave(2, dim=-1))
        sin_parts.append(torch.sin(angles).repeat_interleave(2, dim=-1))

    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    r"""Rotates interleaved channel pairs of `x`, with shape :math:`(B, H, L, D)`,
    by tables with shape :math:`(L, D)`, in the input dtype (the tables are
    cast to it), as the JAX package does."""

    xr = x.unflatten(-1, (-1, 2))
    x_rot = torch.stack([-xr[..., 1], xr[..., 0]], dim=-1).flatten(-2)

    return x * cos.to(x.dtype) + x_rot * sin.to(x.dtype)


class RMSNorm(nn.Module):
    r"""RMSNorm with a learned `weight` (the JAX `scale`), eps 1e-6, applied
    per attention head to q and k: float32 statistics, the result cast to the
    input dtype and then multiplied by the weight cast to it. The weight
    starts at ones, so `generator` draws nothing."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None, dtype=None, generator=None) -> None:
        super().__init__()

        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        return rms_norm(x, eps=self.eps) * self.weight.to(x.dtype)


class MLPEmbedder(nn.Module):
    r"""`linear_1 -> SiLU -> linear_2` (diffusers `TimestepEmbedding` /
    `PixArtAlphaTextProjection`)."""

    def __init__(self, in_dim: int, dim: int, **factory) -> None:
        super().__init__()

        self.linear_1 = Linear(in_dim, dim, **factory)
        self.linear_2 = Linear(dim, dim, **factory)

    def forward(self, x: Tensor) -> Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class AdaLayerNormZero(nn.Module):
    r"""`silu(emb) -> linear -> n` modulation chunks (shift, scale, then the
    rest) and a parameter-free LayerNorm (float32 statistics, eps 1e-6)
    modulated by the first two."""

    def __init__(self, dim: int, n: int = 6, **factory) -> None:
        super().__init__()

        self.linear = Linear(dim, n * dim, **factory)
        self.norm = LayerNorm(eps=1e-6)
        self.n = n

    def forward(self, x: Tensor, emb: Tensor) -> tuple[Tensor, ...]:
        chunks = self.linear(F.silu(emb)).chunk(self.n, dim=-1)

        shift, scale = chunks[0], chunks[1]
        h = self.norm(x) * (1 + scale[:, None]) + shift[:, None]

        return (h, *chunks[2:])


class AdaLayerNormContinuous(nn.Module):
    r"""The output norm (diffusers `AdaLayerNormContinuous`, the JAX
    `norm_out_linear` and `norm_out`): `silu(emb) -> linear` split into
    **(scale, shift)**, the reverse of AdaLN-Zero's order."""

    def __init__(self, dim: int, **factory) -> None:
        super().__init__()

        self.linear = Linear(dim, 2 * dim, **factory)
        self.norm = LayerNorm(eps=1e-6)

    def forward(self, x: Tensor, emb: Tensor) -> Tensor:
        scale, shift = self.linear(F.silu(emb)).chunk(2, dim=-1)

        return self.norm(x) * (1 + scale[:, None]) + shift[:, None]


class GELUProjection(nn.Module):
    r"""`proj -> GELU(tanh)` (diffusers `GELU` with `approximate='tanh'`)."""

    def __init__(self, in_dim: int, out_dim: int, **factory) -> None:
        super().__init__()

        self.proj = Linear(in_dim, out_dim, **factory)

    def forward(self, x: Tensor) -> Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class GELUFeedForward(nn.Module):
    r"""`proj -> GELU(tanh) -> out` (diffusers `FeedForward`, whose `net.1`
    is a dropout: the identity at inference)."""

    def __init__(self, dim: int, mult: int = 4, **factory) -> None:
        super().__init__()

        self.net = nn.ModuleList([
            GELUProjection(dim, mult * dim, **factory),
            nn.Identity(),
            Linear(mult * dim, dim, **factory),
        ])

    def forward(self, x: Tensor) -> Tensor:
        return self.net[2](self.net[0](x))


def _split_heads(x: Tensor, heads: int) -> Tensor:
    r"""(B, L, H D) -> (B, H, L, D), a view."""

    return x.unflatten(-1, (heads, -1)).transpose(1, 2)


class JointAttention(nn.Module):
    r"""MMDiT joint attention: separate q, k, v projections for the image and
    text streams, per-head RMS q/k norms, rotary embedding over the
    concatenated sequence (text first), separate output projections."""

    def __init__(self, dim: int, heads: int, **factory) -> None:
        super().__init__()

        self.heads = heads
        self.to_q = Linear(dim, dim, **factory)
        self.to_k = Linear(dim, dim, **factory)
        self.to_v = Linear(dim, dim, **factory)
        self.add_q_proj = Linear(dim, dim, **factory)
        self.add_k_proj = Linear(dim, dim, **factory)
        self.add_v_proj = Linear(dim, dim, **factory)

        head_dim = dim // heads
        self.norm_q = RMSNorm(head_dim, **factory)
        self.norm_k = RMSNorm(head_dim, **factory)
        self.norm_added_q = RMSNorm(head_dim, **factory)
        self.norm_added_k = RMSNorm(head_dim, **factory)

        self.to_out = nn.ModuleList([Linear(dim, dim, **factory)])
        self.to_add_out = Linear(dim, dim, **factory)

    def forward(self, img: Tensor, txt: Tensor, cos: Tensor, sin: Tensor) -> tuple[Tensor, Tensor]:
        B, L, _ = img.shape
        Lt = txt.shape[1]
        H = self.heads

        q = self.norm_q(_split_heads(self.to_q(img), H))
        k = self.norm_k(_split_heads(self.to_k(img), H))
        v = _split_heads(self.to_v(img), H)

        qc = self.norm_added_q(_split_heads(self.add_q_proj(txt), H))
        kc = self.norm_added_k(_split_heads(self.add_k_proj(txt), H))
        vc = _split_heads(self.add_v_proj(txt), H)

        # text first, as the checkpoints order it
        q = apply_rope(torch.cat([qc, q], dim=2), cos, sin)
        k = apply_rope(torch.cat([kc, k], dim=2), cos, sin)
        v = torch.cat([vc, v], dim=2)

        # RMS-normalized q and k bound the logits: the max-free softmax
        a = dot_product_attention(q, k, v, max_free=True)
        a = a.transpose(1, 2).reshape(B, Lt + L, -1)  # -1: a tensor-parallel rank's heads

        return self.to_out[0](a[:, Lt:]), self.to_add_out(a[:, :Lt])


class FluxTransformerBlock(nn.Module):
    r"""Dual-stream MMDiT block."""

    def __init__(self, dim: int, heads: int, **factory) -> None:
        super().__init__()

        self.norm1 = AdaLayerNormZero(dim, **factory)
        self.norm1_context = AdaLayerNormZero(dim, **factory)
        self.attn = JointAttention(dim, heads, **factory)
        self.norm2 = LayerNorm(eps=1e-6)
        self.norm2_context = LayerNorm(eps=1e-6)
        self.ff = GELUFeedForward(dim, **factory)
        self.ff_context = GELUFeedForward(dim, **factory)

    def forward(self, img: Tensor, txt: Tensor, emb: Tensor, cos: Tensor, sin: Tensor) -> tuple[Tensor, Tensor]:
        h, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(img, emb)
        hc, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(txt, emb)

        attn_img, attn_txt = self.attn(h, hc, cos, sin)

        img = img + gate_msa[:, None] * attn_img
        h = self.norm2(img) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        img = img + gate_mlp[:, None] * self.ff(h)

        txt = txt + c_gate_msa[:, None] * attn_txt
        hc = self.norm2_context(txt) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        txt = txt + c_gate_mlp[:, None] * self.ff_context(hc)

        return img, txt


class SingleAttention(nn.Module):
    r"""Single-stream attention: q, k, v with RMS norms and rope, and no
    output projection (the block's `proj_out` takes it)."""

    def __init__(self, dim: int, heads: int, **factory) -> None:
        super().__init__()

        self.heads = heads
        self.to_q = Linear(dim, dim, **factory)
        self.to_k = Linear(dim, dim, **factory)
        self.to_v = Linear(dim, dim, **factory)
        self.norm_q = RMSNorm(dim // heads, **factory)
        self.norm_k = RMSNorm(dim // heads, **factory)

    def forward(self, x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
        B, L, _ = x.shape
        H = self.heads

        q = apply_rope(self.norm_q(_split_heads(self.to_q(x), H)), cos, sin)
        k = apply_rope(self.norm_k(_split_heads(self.to_k(x), H)), cos, sin)
        v = _split_heads(self.to_v(x), H)

        # RMS-normalized q and k: the max-free softmax
        a = dot_product_attention(q, k, v, max_free=True)

        return a.transpose(1, 2).reshape(B, L, -1)


class FluxSingleTransformerBlock(nn.Module):
    r"""Single-stream block: attention and MLP in parallel, concatenated and
    projected back under one gate."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, **factory) -> None:
        super().__init__()

        inner = int(dim * mlp_ratio)

        self.norm = AdaLayerNormZero(dim, n=3, **factory)
        self.proj_mlp = Linear(dim, inner, **factory)
        self.attn = SingleAttention(dim, heads, **factory)
        self.proj_out = Linear(dim + inner, dim, **factory)

    def forward(self, x: Tensor, emb: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
        h, gate = self.norm(x, emb)

        mlp = F.gelu(self.proj_mlp(h), approximate="tanh")
        attn = self.attn(h, cos, sin)

        return x + gate[:, None] * self.proj_out(torch.cat([attn, mlp], dim=-1))


class TimeTextEmbed(nn.Module):
    r"""Combined timestep, optional distilled guidance and pooled-text
    embedding (diffusers `CombinedTimestepGuidanceTextProjEmbeddings`)."""

    def __init__(self, dim: int, pooled_dim: int, guidance: bool, **factory) -> None:
        super().__init__()

        self.timestep_embedder = MLPEmbedder(256, dim, **factory)
        self.guidance_embedder = MLPEmbedder(256, dim, **factory) if guidance else None
        self.text_embedder = MLPEmbedder(pooled_dim, dim, **factory)

    def forward(self, timestep: Tensor, guidance: Tensor | None, pooled: Tensor) -> Tensor:
        t_proj = sinusoidal_timestep_embedding(timestep * 1000.0, 256).to(pooled.dtype)
        emb = self.timestep_embedder(t_proj)

        if self.guidance_embedder is not None:
            # `g * 1000` in the guidance's own dtype (bf16 from the denoiser)
            g = torch.zeros_like(timestep) if guidance is None else guidance
            g_proj = sinusoidal_timestep_embedding(g * 1000.0, 256).to(pooled.dtype)
            emb = emb + self.guidance_embedder(g_proj)

        return emb + self.text_embedder(pooled)


class FluxTransformer(nn.Module):
    r"""The Flux MMDiT (diffusers ``FluxTransformer2DModel`` semantics).

    The defaults are FLUX.1-dev (11.9B parameters); FLUX.1-schnell takes
    `guidance_embeds=False`.

    Arguments:
        in_channels: Packed latent channels (2x2 pixel-shuffled, 64).
        num_layers: Dual-stream MMDiT blocks.
        num_single_layers: Single-stream blocks.
        attention_head_dim: Per-head width.
        num_attention_heads: Head count (inner dim = heads x head_dim).
        joint_attention_dim: T5 embedding width.
        pooled_projection_dim: CLIP pooled width.
        guidance_embeds: Distilled-guidance conditioning input.
        axes_dims_rope: Rotary dims per position axis (sum = head dim).
        device: The device of the parameters. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters, drawn in it directly (bf16 for
            serving: no float32 copy is ever made). Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`).
    """

    def __init__(
        self,
        in_channels: int = 64,
        num_layers: int = 19,
        num_single_layers: int = 38,
        attention_head_dim: int = 128,
        num_attention_heads: int = 24,
        joint_attention_dim: int = 4096,
        pooled_projection_dim: int = 768,
        guidance_embeds: bool = True,
        axes_dims_rope: Sequence[int] = (16, 56, 56),
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = {"device": default_device(device), "dtype": dtype, "generator": generator}
        dim = num_attention_heads * attention_head_dim

        self.axes_dims_rope = tuple(axes_dims_rope)

        self.time_text_embed = TimeTextEmbed(dim, pooled_projection_dim, guidance_embeds, **factory)
        self.context_embedder = Linear(joint_attention_dim, dim, **factory)
        self.x_embedder = Linear(in_channels, dim, **factory)

        self.transformer_blocks = nn.ModuleList(
            [FluxTransformerBlock(dim, num_attention_heads, **factory) for _ in range(num_layers)]
        )
        self.single_transformer_blocks = nn.ModuleList(
            [FluxSingleTransformerBlock(dim, num_attention_heads, **factory) for _ in range(num_single_layers)]
        )

        self.norm_out = AdaLayerNormContinuous(dim, **factory)
        self.proj_out = Linear(dim, in_channels, **factory)

    def forward(
        self,
        hidden_states: Tensor,
        timestep: Tensor,
        encoder_hidden_states: Tensor,
        pooled_projections: Tensor,
        img_ids: Tensor,
        txt_ids: Tensor,
        guidance: Tensor | None = None,
        **kwargs,
    ) -> Tensor:
        r"""
        Arguments:
            hidden_states: Packed latents, with shape :math:`(B, L, C)`.
            timestep: Noise level in :math:`[0, 1]`, with shape :math:`(B,)`.
            encoder_hidden_states: T5 embeddings, with shape :math:`(B, L_t, D)`.
            pooled_projections: CLIP pooled prompt, with shape :math:`(B, F)`.
            img_ids / txt_ids: Position ids, with shape :math:`(L, 3)`.
            guidance: Distilled guidance strength, with shape :math:`(B,)`.

        Returns:
            The velocity prediction, with shape :math:`(B, L, C)`.
        """

        img = self.x_embedder(hidden_states)
        txt = self.context_embedder(encoder_hidden_states)

        emb = self.time_text_embed(timestep.float(), guidance, pooled_projections).to(img.dtype)

        ids = torch.cat([txt_ids, img_ids], dim=0)
        cos, sin = rope_cos_sin(ids, self.axes_dims_rope)

        for block in self.transformer_blocks:
            with annotate("azula.block.FluxTransformerBlock"):
                img, txt = block(img, txt, emb, cos, sin)

        h = torch.cat([txt, img], dim=1)

        for block in self.single_transformer_blocks:
            with annotate("azula.block.FluxSingleTransformerBlock"):
                h = block(h, emb, cos, sin)

        h = h[:, txt.shape[1] :]

        return self.proj_out(self.norm_out(h, emb))
