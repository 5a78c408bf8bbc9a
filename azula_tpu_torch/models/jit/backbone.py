r"""JiT (Just image Transformer) backbone, channels-last.

Port of :mod:`azula_tpu.models.jit.backbone`: a bottleneck patch embedding,
a fixed 2D sin-cos position embedding, 2D axial RoPE with in-context
class-token padding, 6-way AdaLN-Zero blocks with SwiGLU FFNs (half-split
gating) and a zero-initialized final layer.

Each block's attention normalizes q and k per head (:class:`JiTRMSNorm`,
float32 statistics) and rotates them, then calls
:func:`~azula_tpu_torch.ops.attention.dot_product_attention`: on the card
the attention kernel at JiT-B's and JiT-L's heads of 64, the plain route
at JiT-H's 80, as the JAX package takes XLA there.

The state dict's keys are the checkpoints' (`t_embedder.mlp.0.weight`,
`y_embedder.embedding_table.weight`, `x_embedder.proj1.weight`,
`blocks.3.adaLN_modulation.1.weight`, `final_layer.linear.weight`,
`pos_embed` and `in_context_posemb` with their leading 1), PyTorch's
layouts. The RoPE tables are buffers outside the state dict, computed on
the host as in the JAX package.
"""

from __future__ import annotations

__all__ = [
    "JIT_CONFIGS",
    "JiT",
    "JiTAttention",
    "JiTBlock",
    "JiTRMSNorm",
    "JiTSwiGLU",
]

import math
import numpy as np
import torch
import torch.nn.functional as F

from torch import Tensor, nn

from ...nn.layers import Conv, Embedding, Linear
from ...nn.utils import table_device
from ...ops.attention import dot_product_attention


def _xavier_(w: Tensor, fan_in: int, fan_out: int, generator) -> Tensor:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def _linear(d_in: int, d_out: int, std: float | None = None, zero: bool = False, **factory) -> Linear:
    r"""A Linear initialized as the JAX package's JiT initializes it: Xavier
    uniform (or normal at `std`, or zeros) and a zero bias."""

    generator = factory.get("generator")
    lin = Linear(d_in, d_out, **factory)
    if zero:
        lin.weight.zero_()
    elif std is None:
        _xavier_(lin.weight, d_in, d_out, generator)
    else:
        lin.weight.normal_(0.0, std, generator=generator)
    lin.bias.zero_()
    return lin


class JiTRMSNorm(nn.Module):
    r"""Llama-style affine RMSNorm: float32 statistics, a learned scale, the
    product rounded to x's dtype (JiT's own rounding point)."""

    def __init__(self, hidden_size: int, eps: float = 1e-6, *, device=None, dtype=None) -> None:
        super().__init__()

        self.weight = nn.Parameter(torch.ones(hidden_size, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + self.eps)
        return (self.weight * h).to(x.dtype)


def _rotate_half(x: Tensor) -> Tensor:
    r"""The rotation of interleaved pairs: (x1, x2) -> (-x2, x1)."""

    x = x.unflatten(-1, (-1, 2))
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def _axial_rope_tables(head_dim: int, seq_len: int, num_cls: int) -> tuple[np.ndarray, np.ndarray]:
    r"""The 2D axial RoPE cos/sin tables, :math:`(n_{cls} + S^2, D)`, float32,
    computed on the host as the JAX package computes them; the class-token
    rows rotate by identity (cos 1, sin 0)."""

    dim = head_dim // 2  # per-axis rotary dim

    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float32) / dim))
    t = np.arange(seq_len, dtype=np.float32)

    f = np.einsum("n,f->nf", t, freqs)
    f = np.repeat(f, 2, axis=-1)  # interleaved pairs

    fh = np.broadcast_to(f[:, None, :], (seq_len, seq_len, f.shape[-1]))
    fw = np.broadcast_to(f[None, :, :], (seq_len, seq_len, f.shape[-1]))
    full = np.concatenate([fh, fw], axis=-1).reshape(-1, head_dim)

    cos = np.cos(full)
    sin = np.sin(full)

    if num_cls > 0:
        cos = np.concatenate([np.ones((num_cls, head_dim), np.float32), cos], axis=0)
        sin = np.concatenate([np.zeros((num_cls, head_dim), np.float32), sin], axis=0)

    return cos.astype(np.float32), sin.astype(np.float32)


def _sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    r"""The fixed 2D sin-cos position embedding, :math:`(S^2, D)`, computed in
    float64 and rounded to float32, as the JAX package computes it."""

    def axis_embed(pos):
        omega = np.arange(embed_dim // 4, dtype=np.float64)
        omega = 1.0 / 10000 ** (omega / (embed_dim / 4))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    gw, gh = np.meshgrid(grid_w, grid_h)

    emb = np.concatenate([axis_embed(gw), axis_embed(gh)], axis=1)

    return emb.astype(np.float32)


class JiTAttention(nn.Module):
    r"""Multi-head attention with per-head RMSNorm and axial RoPE."""

    def __init__(self, dim: int, num_heads: int, *, device=None, dtype=None, generator=None) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.num_heads = num_heads
        self.q_norm = JiTRMSNorm(dim // num_heads, device=device, dtype=dtype)
        self.k_norm = JiTRMSNorm(dim // num_heads, device=device, dtype=dtype)
        self.qkv = _linear(dim, 3 * dim, **factory)
        self.proj = _linear(dim, dim, **factory)

    def forward(self, x: Tensor, rope: tuple[Tensor, Tensor]) -> Tensor:
        B, N, C = x.shape
        H = self.num_heads

        qkv = self.qkv(x).reshape(B, N, 3, H, C // H)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # (B, H, N, ch) each

        q = self.q_norm(q)
        k = self.k_norm(k)

        cos, sin = (a.to(q.dtype) for a in rope)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin

        y = dot_product_attention(q, k, v)

        return self.proj(y.transpose(1, 2).reshape(B, N, C))


class JiTSwiGLU(nn.Module):
    r"""SwiGLU FFN with half-split gating; the hidden width is
    `int(hidden_dim * 2 / 3)`."""

    def __init__(self, dim: int, hidden_dim: int, *, device=None, dtype=None, generator=None) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408
        hidden_dim = int(hidden_dim * 2 / 3)

        self.w12 = _linear(dim, 2 * hidden_dim, **factory)
        self.w3 = _linear(hidden_dim, dim, **factory)

    def forward(self, x: Tensor) -> Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


def _modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


class JiTBlock(nn.Module):
    r"""6-way AdaLN-Zero transformer block."""

    def __init__(
        self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0, *, device=None, dtype=None, generator=None
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.norm1 = JiTRMSNorm(hidden_size, device=device, dtype=dtype)
        self.attn = JiTAttention(hidden_size, num_heads, **factory)
        self.norm2 = JiTRMSNorm(hidden_size, device=device, dtype=dtype)
        self.mlp = JiTSwiGLU(hidden_size, int(hidden_size * mlp_ratio), **factory)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), _linear(hidden_size, 6 * hidden_size, zero=True, **factory))

    def forward(self, x: Tensor, c: Tensor, rope: tuple[Tensor, Tensor]) -> Tensor:
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = self.adaLN_modulation(c).chunk(6, dim=-1)

        x = x + g_msa[:, None, :] * self.attn(_modulate(self.norm1(x), s_msa, sc_msa), rope)
        x = x + g_mlp[:, None, :] * self.mlp(_modulate(self.norm2(x), s_mlp, sc_mlp))

        return x


def _timestep_embedding(t: Tensor, dim: int, max_period: float = 10000.0) -> Tensor:
    r"""cos then sin of :math:`t \cdot \omega`, float32, with :math:`t \in [0, 1]`."""

    half = dim // 2

    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs

    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class JiT(nn.Module):
    r"""Just image Transformer.

    Arguments mirror the checkpoint factories (`JIT_CONFIGS`); `model(x, t,
    y)` takes channels-last images :math:`(B, H, W, C)`, times :math:`(B)`
    and labels :math:`(B)` (`num_classes` for none), and returns
    channels-last images.
    """

    def __init__(
        self,
        input_size: int = 256,
        patch_size: int = 16,
        in_channels: int = 3,
        hidden_size: int = 1024,
        depth: int = 24,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        num_classes: int = 1000,
        bottleneck_dim: int = 128,
        in_context_len: int = 32,
        in_context_start: int = 8,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.patch_size = patch_size
        self.num_classes = num_classes
        self.in_context_len = in_context_len
        self.in_context_start = in_context_start

        grid = input_size // patch_size

        # timestep embedder: sinusoidal(256) + MLP
        self.t_embedder = nn.Module()
        self.t_embedder.mlp = nn.Sequential(
            _linear(256, hidden_size, std=0.02, **factory), nn.SiLU(), _linear(hidden_size, hidden_size, std=0.02, **factory)
        )

        # label embedding, one extra row for the unconditional class
        self.y_embedder = nn.Module()
        self.y_embedder.embedding_table = Embedding(num_classes + 1, hidden_size, **factory)

        # bottleneck patch embedding: patchify conv, then a 1 x 1 conv
        self.x_embedder = nn.Module()
        self.x_embedder.proj1 = Conv(
            in_channels, bottleneck_dim, (patch_size, patch_size), stride=(patch_size, patch_size), bias=False, **factory
        )
        self.x_embedder.proj2 = Conv(bottleneck_dim, hidden_size, (1, 1), **factory)
        with torch.no_grad():
            _xavier_(self.x_embedder.proj1.weight, in_channels * patch_size**2, bottleneck_dim, generator)
            _xavier_(self.x_embedder.proj2.weight, bottleneck_dim, hidden_size, generator)
            self.x_embedder.proj2.bias.zero_()

        # fixed 2D sin-cos position embedding, and learned in-context positions
        pos = torch.from_numpy(_sincos_pos_embed(hidden_size, grid))[None]
        self.pos_embed = nn.Parameter(pos.to(device=device, dtype=dtype), requires_grad=False)
        if in_context_len > 0:
            w = torch.empty((1, in_context_len, hidden_size), device=device, dtype=dtype)
            self.in_context_posemb = nn.Parameter(w.normal_(0.0, 0.02, generator=generator))
        else:
            self.in_context_posemb = None

        # axial RoPE tables, without and with the in-context rows
        head_dim = hidden_size // num_heads // 2 * 2
        for name, cls in (("rope", 0), ("rope_incontext", in_context_len)):
            cos, sin = _axial_rope_tables(head_dim, grid, cls)
            self.register_buffer(f"{name}_cos", torch.from_numpy(cos).to(table_device(device)), persistent=False)
            self.register_buffer(f"{name}_sin", torch.from_numpy(sin).to(table_device(device)), persistent=False)

        self.blocks = nn.ModuleList([
            JiTBlock(hidden_size, num_heads, mlp_ratio=mlp_ratio, **factory) for _ in range(depth)
        ])

        # final layer: 2-way AdaLN and a zero-initialized linear
        self.final_layer = nn.Module()
        self.final_layer.norm_final = JiTRMSNorm(hidden_size, device=device, dtype=dtype)
        self.final_layer.linear = _linear(hidden_size, patch_size**2 * in_channels, zero=True, **factory)
        self.final_layer.adaLN_modulation = nn.Sequential(
            nn.SiLU(), _linear(hidden_size, 2 * hidden_size, zero=True, **factory)
        )

    def forward(self, x: Tensor, t: Tensor, y: Tensor) -> Tensor:
        B, H, W, C = x.shape
        p = self.patch_size

        # conditioning
        t_emb = self.t_embedder.mlp(_timestep_embedding(t, 256).to(x.dtype))
        y_emb = self.y_embedder.embedding_table(y).to(x.dtype)
        c = t_emb + y_emb

        # patch embedding and fixed positions
        h = self.x_embedder.proj2(self.x_embedder.proj1(x))
        h = h.reshape(B, -1, h.shape[-1])
        h = h + self.pos_embed.to(h.dtype)

        rope = (self.rope_cos, self.rope_sin)
        for i, block in enumerate(self.blocks):
            if self.in_context_len > 0 and i == self.in_context_start:
                tokens = torch.broadcast_to(y_emb[:, None, :], (B, self.in_context_len, y_emb.shape[-1]))
                tokens = tokens + self.in_context_posemb.to(h.dtype)
                h = torch.cat([tokens, h], dim=1)
            if i == self.in_context_start:
                rope = (self.rope_incontext_cos, self.rope_incontext_sin)
            h = block(h, c, rope)

        h = h[:, self.in_context_len:]

        # final layer
        shift, scale = self.final_layer.adaLN_modulation(c).chunk(2, dim=-1)
        h = self.final_layer.linear(_modulate(self.final_layer.norm_final(h), shift, scale))

        # unpatchify, channels-last
        g = H // p
        h = h.reshape(B, g, g, p, p, C).permute(0, 1, 3, 2, 4, 5)

        return h.reshape(B, H, W, C)


JIT_CONFIGS = {
    "JiT-B/16": dict(depth=12, hidden_size=768, num_heads=12, bottleneck_dim=128, in_context_len=32, in_context_start=4, patch_size=16),  # noqa: C408
    "JiT-B/32": dict(depth=12, hidden_size=768, num_heads=12, bottleneck_dim=128, in_context_len=32, in_context_start=4, patch_size=32),  # noqa: C408
    "JiT-L/16": dict(depth=24, hidden_size=1024, num_heads=16, bottleneck_dim=128, in_context_len=32, in_context_start=8, patch_size=16),  # noqa: C408
    "JiT-L/32": dict(depth=24, hidden_size=1024, num_heads=16, bottleneck_dim=128, in_context_len=32, in_context_start=8, patch_size=32),  # noqa: C408
    "JiT-H/16": dict(depth=32, hidden_size=1280, num_heads=16, bottleneck_dim=256, in_context_len=32, in_context_start=10, patch_size=16),  # noqa: C408
    "JiT-H/32": dict(depth=32, hidden_size=1280, num_heads=16, bottleneck_dim=256, in_context_len=32, in_context_start=10, patch_size=32),  # noqa: C408
}
