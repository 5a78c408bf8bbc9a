r"""CLIP text encoder.

Port of :mod:`azula_tpu.models.clip` (`transformers.CLIPTextModel`
semantics): the pooled-text branch of the Flux family. A pre-LayerNorm
transformer with causal attention and quick-GELU (or GELU) activations;
LayerNorm statistics and affine in float32, the logits in the input dtype
and their softmax in float32, as in the JAX package.

The state dict's keys are the canonical names of
:func:`canonicalize_clip_keys`, which are the manifests'; the JAX package's
`convert_clip_state_dict` loads it as it is.
"""

from __future__ import annotations

__all__ = [
    "CLIPTextEncoder",
    "canonicalize_clip_keys",
    "from_jax_state_dict",
]

import math
import numpy as np
import torch
import torch.nn.functional as F

from collections.abc import Mapping
from torch import Tensor, nn

from ..nn.layers import Embedding, Linear
from ..nn.utils import default_device
from .utils import from_jax_arrays


class _LayerNorm(nn.Module):
    r"""Affine LayerNorm, statistics and affine in float32."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None, dtype=None, generator=None) -> None:
        super().__init__()

        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        h = x.float()
        m = h.mean(dim=-1, keepdim=True)
        v = torch.square(h - m).mean(dim=-1, keepdim=True)
        h = (h - m) * torch.rsqrt(v + self.eps)
        h = h * self.weight.float() + self.bias.float()

        return h.to(x.dtype)


def quick_gelu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, **factory) -> None:
        super().__init__()

        self.heads = heads
        self.q_proj = Linear(dim, dim, **factory)
        self.k_proj = Linear(dim, dim, **factory)
        self.v_proj = Linear(dim, dim, **factory)
        self.out_proj = Linear(dim, dim, **factory)

    def forward(self, x: Tensor, causal: bool = True) -> Tensor:
        B, L, C = x.shape
        H = self.heads

        q = self.q_proj(x).reshape(B, L, H, -1).transpose(1, 2)
        k = self.k_proj(x).reshape(B, L, H, -1).transpose(1, 2)
        v = self.v_proj(x).reshape(B, L, H, -1).transpose(1, 2)

        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(C // H)

        if causal:
            mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~mask, -math.inf)

        weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        a = torch.matmul(weights, v).transpose(1, 2).reshape(B, L, C)

        return self.out_proj(a)


class _MLP(nn.Module):
    def __init__(self, dim: int, intermediate: int, act: str, **factory) -> None:
        super().__init__()

        self.fc1 = Linear(dim, intermediate, **factory)
        self.fc2 = Linear(intermediate, dim, **factory)
        self.act = act

    def forward(self, x: Tensor) -> Tensor:
        h = self.fc1(x)
        h = quick_gelu(h) if self.act == "quick_gelu" else F.gelu(h)

        return self.fc2(h)


class _EncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, intermediate: int, act: str, **factory) -> None:
        super().__init__()

        self.layer_norm1 = _LayerNorm(dim, **factory)
        self.self_attn = _Attention(dim, heads, **factory)
        self.layer_norm2 = _LayerNorm(dim, **factory)
        self.mlp = _MLP(dim, intermediate, act, **factory)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEncoder(nn.Module):
    r"""The CLIP text transformer.

    Defaults correspond to CLIP ViT-L/14's text encoder (SD 1.x, Flux).

    Arguments:
        vocab_size: The token vocabulary size.
        hidden: The hidden dimension.
        layers: The number of transformer layers.
        heads: The number of attention heads.
        intermediate: The MLP dimension.
        max_positions: The maximum sequence length.
        act: The MLP activation (`'quick_gelu'` or `'gelu'`).
        device: The parameters' device; the card unless another is named.
        dtype, generator: The parameters' dtype and initial-value generator.
    """

    def __init__(
        self,
        vocab_size: int = 49408,
        hidden: int = 768,
        layers: int = 12,
        heads: int = 12,
        intermediate: int = 3072,
        max_positions: int = 77,
        act: str = "quick_gelu",
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408

        self.token_embedding = Embedding(vocab_size, hidden, **factory)
        self.position_embedding = Embedding(max_positions, hidden, **factory)
        self.encoder_layers = nn.ModuleList([
            _EncoderLayer(hidden, heads, intermediate, act, **factory) for _ in range(layers)
        ])
        self.final_layer_norm = _LayerNorm(hidden, **factory)

    def forward(self, input_ids: Tensor) -> Tensor:
        r"""
        Arguments:
            input_ids: Token ids, with shape :math:`(B, L)`.

        Returns:
            The last hidden state, with shape :math:`(B, L, C)`.
        """

        L = input_ids.shape[-1]

        x = self.token_embedding(input_ids) + self.position_embedding.weight[:L]

        for layer in self.encoder_layers:
            x = layer(x)

        return self.final_layer_norm(x)


def canonicalize_clip_keys(sd: Mapping) -> dict:
    r"""Renames `transformers.CLIPTextModel` keys to the canonical space of
    the manifests and of this module's state dict (key-only)."""

    out = {}
    for k, v in sd.items():
        k = k.removeprefix("text_model.")
        k = k.replace("embeddings.token_embedding.", "token_embedding.")
        k = k.replace("embeddings.position_embedding.", "position_embedding.")
        k = k.replace("encoder.layers.", "encoder_layers.")
        if k == "embeddings.position_ids":  # a buffer of old checkpoints
            continue
        out[k] = v

    return out


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts the state dict of a JAX `CLIPTextEncoder` (numpy arrays) to
    the port's layout: the embedding tables -> `<name>.weight`, LayerNorm
    `scale` -> `weight`, Linear weights transposed."""

    return from_jax_arrays(sd, module, tables=("token_embedding", "position_embedding"))
