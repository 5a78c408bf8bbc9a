r"""T5 text encoder.

Port of :mod:`azula_tpu.models.t5` (`transformers.T5EncoderModel`, v1.1
gated-GELU semantics): the long-prompt encoder of the Flux family.
Relative-position-bucket attention biases (the first block's table, shared
by every block), T5 LayerNorm (RMS, no bias, no mean subtraction; the result
cast back to the input dtype before the scale), unscaled attention logits
to which the bias is added in the input dtype, gated tanh-GELU feed-forward.

The state dict's keys are the canonical names of
:func:`canonicalize_t5_keys`, which are the manifests'; the JAX package's
`convert_t5_state_dict` loads it as it is.
"""

from __future__ import annotations

__all__ = [
    "T5Encoder",
    "canonicalize_t5_keys",
    "from_jax_state_dict",
    "relative_position_bucket",
]

import numpy as np
import torch
import torch.nn.functional as F

from collections.abc import Mapping
from torch import Tensor, nn

from ..nn.layers import Embedding, Linear
from ..nn.utils import default_device
from .utils import from_jax_arrays


class T5LayerNorm(nn.Module):
    r"""RMS LayerNorm without bias or mean subtraction (T5 style)."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None, dtype=None, generator=None) -> None:
        super().__init__()

        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        h = x.float()
        h = h * torch.rsqrt(torch.square(h).mean(dim=-1, keepdim=True) + self.eps)

        return self.weight.to(x.dtype) * h.to(x.dtype)


def relative_position_bucket(
    relative_position: np.ndarray, num_buckets: int = 32, max_distance: int = 128
) -> np.ndarray:
    r"""T5's bidirectional relative-position buckets, on the host (the
    positions are static): the same integers as the JAX package's."""

    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)

    max_exact = num_buckets // 2
    is_small = n < max_exact

    val_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)

    return ret + np.where(is_small, n, val_large)


class T5Attention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, has_bias: bool, **factory) -> None:
        super().__init__()

        inner = heads * head_dim

        self.heads = heads
        self.q = Linear(dim, inner, bias=False, **factory)
        self.k = Linear(dim, inner, bias=False, **factory)
        self.v = Linear(dim, inner, bias=False, **factory)
        self.o = Linear(inner, dim, bias=False, **factory)

        self.relative_attention_bias = Embedding(32, heads, **factory) if has_bias else None

    def forward(self, x: Tensor, position_bias: Tensor) -> Tensor:
        B, L, _ = x.shape
        H = self.heads

        q = self.q(x).reshape(B, L, H, -1).transpose(1, 2)
        k = self.k(x).reshape(B, L, H, -1).transpose(1, 2)
        v = self.v(x).reshape(B, L, H, -1).transpose(1, 2)

        # T5 does not scale the logits
        logits = torch.matmul(q, k.transpose(-1, -2)) + position_bias
        weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        a = torch.matmul(weights, v).transpose(1, 2).reshape(B, L, -1)

        return self.o(a)


class T5FF(nn.Module):
    r"""Gated feed-forward (`DenseGatedActDense`): `wo(gelu(wi_0 x) * wi_1 x)`."""

    def __init__(self, dim: int, ff_dim: int, **factory) -> None:
        super().__init__()

        self.wi_0 = Linear(dim, ff_dim, bias=False, **factory)
        self.wi_1 = Linear(dim, ff_dim, bias=False, **factory)
        self.wo = Linear(ff_dim, dim, bias=False, **factory)

    def forward(self, x: Tensor) -> Tensor:
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5Block(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, ff_dim: int, first: bool, **factory) -> None:
        super().__init__()

        self.attn_norm = T5LayerNorm(dim, **factory)
        self.attn = T5Attention(dim, heads, head_dim, has_bias=first, **factory)
        self.ff_norm = T5LayerNorm(dim, **factory)
        self.ff = T5FF(dim, ff_dim, **factory)

    def forward(self, x: Tensor, position_bias: Tensor) -> Tensor:
        x = x + self.attn(self.attn_norm(x), position_bias)
        return x + self.ff(self.ff_norm(x))


class T5Encoder(nn.Module):
    r"""The T5 encoder stack.

    Defaults correspond to t5-v1_1-xxl (Flux's `text_encoder_2`).

    Arguments:
        vocab_size: The token vocabulary size.
        dim: The model dimension.
        heads: The number of attention heads.
        head_dim: The width of a head (T5 decouples it from `dim`).
        ff_dim: The feed-forward width.
        layers: The number of blocks.
        device: The parameters' device; the card unless another is named.
        dtype, generator: The parameters' dtype and initial-value generator.
    """

    def __init__(
        self,
        vocab_size: int = 32128,
        dim: int = 4096,
        heads: int = 64,
        head_dim: int = 64,
        ff_dim: int = 10240,
        layers: int = 24,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408

        self.shared = Embedding(vocab_size, dim, **factory).weight
        self.blocks = nn.ModuleList([
            T5Block(dim, heads, head_dim, ff_dim, first=(i == 0), **factory) for i in range(layers)
        ])
        self.final_layer_norm = T5LayerNorm(dim, **factory)

    def forward(self, input_ids: Tensor) -> Tensor:
        r"""
        Arguments:
            input_ids: Token ids, with shape :math:`(B, L)`.

        Returns:
            The last hidden state, with shape :math:`(B, L, C)`.
        """

        L = input_ids.shape[-1]

        x = F.embedding(input_ids, self.shared)

        # the first block's table, at buckets that depend only on L
        pos = np.arange(L)
        buckets = torch.from_numpy(relative_position_bucket(pos[None, :] - pos[:, None])).to(x.device)
        bias = self.blocks[0].attn.relative_attention_bias(buckets)  # (L, L, H)
        bias = bias.permute(2, 0, 1)[None].to(x.dtype)

        for block in self.blocks:
            x = block(x, bias)

        return self.final_layer_norm(x)


def canonicalize_t5_keys(sd: Mapping) -> dict:
    r"""Renames `transformers.T5EncoderModel` keys to the canonical space of
    the manifests and of this module's state dict (key-only)."""

    out = {}
    for k, v in sd.items():
        k = k.removeprefix("encoder.")
        k = k.replace("block.", "blocks.")
        k = k.replace(".layer.0.SelfAttention.", ".attn.")
        k = k.replace(".layer.0.layer_norm.", ".attn_norm.")
        k = k.replace(".layer.1.DenseReluDense.", ".ff.")
        k = k.replace(".layer.1.layer_norm.", ".ff_norm.")
        if k in ("shared.weight", "embed_tokens.weight"):
            k = "shared"
        out[k] = v

    return out


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts the state dict of a JAX `T5Encoder` (numpy arrays) to the
    port's layout: `shared` as it is, the bias table ->
    `relative_attention_bias.weight`, norm `scale` -> `weight`, Linear
    weights transposed."""

    return from_jax_arrays(sd, module, tables=("relative_attention_bias",), raw=("shared",))
