r"""Gemma 2 text model.

Port of :mod:`azula_tpu.models.gemma` (`transformers.Gemma2Model`
semantics): the prompt encoder of the Sana family. Zero-centered RMSNorms
(:math:`\hat x (1 + w)`, float32) in a sandwich layout around both the
attention and the MLP, grouped-query attention with rotary embeddings, the
logits scaled and soft-capped in float32, a sliding window on alternate
layers and a padding mask, a tanh-GELU-gated MLP, and the embedding scaled
by :math:`\sqrt{d}` in its dtype.

The state dict's keys are `transformers.Gemma2Model`'s (`layers.N...`,
`embed_tokens.weight`, `norm.weight`): :func:`canonicalize_gemma_keys` maps
them onto the manifests', and the JAX package's `convert_gemma_state_dict`
loads them as they are.
"""

from __future__ import annotations

__all__ = [
    "Gemma2TextModel",
    "canonicalize_gemma_keys",
    "from_jax_state_dict",
]

import numpy as np
import torch
import torch.nn.functional as F

from collections.abc import Mapping
from torch import Tensor, nn

from ..nn.layers import Embedding, Linear
from ..nn.utils import default_device
from .utils import from_jax_arrays


class GemmaRMSNorm(nn.Module):
    r"""RMSNorm with a zero-centered weight, :math:`y = \hat x (1 + w)`, in
    float32."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None, dtype=None, generator=None) -> None:
        super().__init__()

        self.weight = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        h = x.float()
        h = h * torch.rsqrt(torch.square(h).mean(dim=-1, keepdim=True) + self.eps)
        h = h * (1.0 + self.weight.float())

        return h.to(x.dtype)


def _rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    r"""Rotary embedding of `x`, with shape :math:`(B, L, H, D)`, over
    half-split channel pairs (the transformers convention, `rotate_half`),
    in float32."""

    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions.float()[:, None] * freqs  # (L, d/2)

    cos = torch.cat([torch.cos(angles)] * 2, dim=-1)[None, :, None, :]
    sin = torch.cat([torch.sin(angles)] * 2, dim=-1)[None, :, None, :]

    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)

    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


class Gemma2Attention(nn.Module):
    def __init__(
        self,
        dim: int,
        heads: int,
        kv_heads: int,
        head_dim: int,
        query_pre_attn_scalar: float,
        softcap: float | None,
        sliding_window: int | None,
        **factory,
    ) -> None:
        super().__init__()

        self.heads = heads
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.scale = query_pre_attn_scalar**-0.5
        self.softcap = softcap
        self.sliding_window = sliding_window

        self.q_proj = Linear(dim, heads * head_dim, bias=False, **factory)
        self.k_proj = Linear(dim, kv_heads * head_dim, bias=False, **factory)
        self.v_proj = Linear(dim, kv_heads * head_dim, bias=False, **factory)
        self.o_proj = Linear(heads * head_dim, dim, bias=False, **factory)

    def forward(self, x: Tensor, mask: Tensor | None) -> Tensor:
        B, L, _ = x.shape
        H, KV, D = self.heads, self.kv_heads, self.head_dim

        pos = torch.arange(L, device=x.device)

        q = _rope(self.q_proj(x).reshape(B, L, H, D), pos)
        k = _rope(self.k_proj(x).reshape(B, L, KV, D), pos)
        v = self.v_proj(x).reshape(B, L, KV, D)

        # grouped-query: each kv head serves H / KV query heads
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)

        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, L, D)

        logits = torch.matmul(q, k.transpose(-1, -2)).float() * self.scale

        if self.softcap is not None:
            logits = self.softcap * torch.tanh(logits / self.softcap)

        allow = pos[:, None] >= pos[None, :]
        if self.sliding_window is not None:
            allow = allow & (pos[:, None] - pos[None, :] < self.sliding_window)
        allow = allow[None, None]
        if mask is not None:
            allow = allow & mask.bool()[:, None, None, :]

        logits = torch.where(allow, logits, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        del logits

        out = torch.matmul(weights, v).transpose(1, 2).reshape(B, L, H * D)

        return self.o_proj(out)


class Gemma2MLP(nn.Module):
    def __init__(self, dim: int, intermediate: int, **factory) -> None:
        super().__init__()

        self.gate_proj = Linear(dim, intermediate, bias=False, **factory)
        self.up_proj = Linear(dim, intermediate, bias=False, **factory)
        self.down_proj = Linear(intermediate, dim, bias=False, **factory)

    def forward(self, x: Tensor) -> Tensor:
        return self.down_proj(F.gelu(self.gate_proj(x), approximate="tanh") * self.up_proj(x))


class Gemma2Layer(nn.Module):
    def __init__(
        self,
        dim: int,
        heads: int,
        kv_heads: int,
        head_dim: int,
        intermediate: int,
        query_pre_attn_scalar: float,
        softcap: float | None,
        sliding_window: int | None,
        **factory,
    ) -> None:
        super().__init__()

        self.input_layernorm = GemmaRMSNorm(dim, **factory)
        self.self_attn = Gemma2Attention(
            dim, heads, kv_heads, head_dim, query_pre_attn_scalar, softcap, sliding_window, **factory
        )
        self.post_attention_layernorm = GemmaRMSNorm(dim, **factory)
        self.pre_feedforward_layernorm = GemmaRMSNorm(dim, **factory)
        self.mlp = Gemma2MLP(dim, intermediate, **factory)
        self.post_feedforward_layernorm = GemmaRMSNorm(dim, **factory)

    def forward(self, x: Tensor, mask: Tensor | None) -> Tensor:
        h = self.self_attn(self.input_layernorm(x), mask)
        x = x + self.post_attention_layernorm(h)

        h = self.mlp(self.pre_feedforward_layernorm(x))
        return x + self.post_feedforward_layernorm(h)


class Gemma2TextModel(nn.Module):
    r"""The Gemma 2 transformer, used as an encoder: returns the last hidden
    state.

    Defaults correspond to gemma-2-2b.

    Arguments:
        vocab_size: The token vocabulary size.
        dim: The model width.
        layers: The number of layers.
        heads, kv_heads, head_dim: The grouped-query attention's shape.
        intermediate: The MLP width.
        query_pre_attn_scalar: The attention's scaling denominator.
        attn_logit_softcapping: The logits' soft cap (None disables it).
        sliding_window: The window of the even layers' local attention.
        device: The parameters' device; the card unless another is named.
        dtype, generator: The parameters' dtype and initial-value generator.
    """

    def __init__(
        self,
        vocab_size: int = 256000,
        dim: int = 2304,
        layers: int = 26,
        heads: int = 8,
        kv_heads: int = 4,
        head_dim: int = 256,
        intermediate: int = 9216,
        query_pre_attn_scalar: float = 256.0,
        attn_logit_softcapping: float | None = 50.0,
        sliding_window: int = 4096,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408

        self.dim = dim
        self.embed_tokens = Embedding(vocab_size, dim, **factory)
        self.layers = nn.ModuleList([
            Gemma2Layer(
                dim, heads, kv_heads, head_dim, intermediate, query_pre_attn_scalar, attn_logit_softcapping,
                # even layers take the sliding window (transformers Gemma2)
                sliding_window if i % 2 == 0 else None,
                **factory,
            )
            for i in range(layers)
        ])
        self.norm = GemmaRMSNorm(dim, **factory)

    def forward(self, input_ids: Tensor, attention_mask: Tensor | None = None) -> Tensor:
        r"""
        Arguments:
            input_ids: Token ids, with shape :math:`(B, L)`.
            attention_mask: A padding mask (1 = keep), with shape :math:`(B, L)`.

        Returns:
            The last hidden state, with shape :math:`(B, L, C)`.
        """

        x = self.embed_tokens(input_ids)
        x = x * torch.tensor(self.dim**0.5, dtype=x.dtype)

        for layer in self.layers:
            x = layer(x, attention_mask)

        return self.norm(x)


def canonicalize_gemma_keys(sd: Mapping) -> dict:
    r"""Renames `transformers.Gemma2Model` keys (this module's) to the
    canonical space of the manifests (key-only)."""

    out = {}
    for k, v in sd.items():
        k = k.removeprefix("model.")
        k = k.replace("layers.", "model_layers.")
        out[k] = v

    return out


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts the state dict of a JAX `Gemma2TextModel` (numpy arrays) to
    the port's layout: `model_layers.` -> `layers.`, `embed_tokens` ->
    `embed_tokens.weight`, norm `scale` -> `weight`, Linear weights
    transposed."""

    return from_jax_arrays(
        sd, module, rename=lambda key: key.replace("model_layers.", "layers.", 1), tables=("embed_tokens",)
    )
