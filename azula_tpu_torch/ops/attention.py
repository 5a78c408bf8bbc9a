r"""Scaled dot-product attention.

Port of :func:`azula_tpu.ops.attention.dot_product_attention`, with its
signature and its (B, H, L, D) layout. Two versions compute it: the
hand-written flash-attention forward (`csrc/attention_fwd.cu`) for tensors
on the card, and a plain PyTorch version for tensors on the CPU.
"""

from __future__ import annotations

__all__ = [
    "dot_product_attention",
]

import math
import torch

from torch import Tensor

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _attention_plain(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    mask: Tensor | None = None,
    scale: float | None = None,
) -> Tensor:
    r"""Plain PyTorch version of `_xla_attention` (azula_tpu/ops/attention.py):
    float32 logits; the value product takes the *unnormalized* exp-weights
    (cast to the input dtype below float32, with float32 accumulation) and the
    denominator divides afterwards."""

    if scale is None:
        scale = 1 / math.sqrt(q.shape[-1])

    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits * scale

    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, -math.inf)
        else:
            logits = logits + mask

    m = logits.amax(dim=-1, keepdim=True)
    weights = torch.exp(logits - m)
    denom = weights.sum(dim=-1, dtype=torch.float32)

    if q.dtype == torch.float32:
        out = torch.matmul(weights / denom[..., None], v)
    else:
        out = torch.matmul(weights.to(q.dtype).float(), v.float())
        out = out / denom[..., None]

    return out.to(q.dtype)


@_build.forward_only("attention_fwd", "the attention backward, ROADMAP A16")
def _attention_kernel(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    r"""Launches `csrc/attention_fwd.cu` on CUDA tensors (B, H, L, D)."""

    if q.device.type != "cuda":
        raise ValueError(f"the attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 4:
        raise ValueError(f"the attention kernel takes (B, H, L, D) tensors, got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device (self-attention)")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the attention kernel takes contiguous, 16-byte aligned tensors")

    B, H, L, D = q.shape

    if D not in _HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head dims {_HEAD_DIMS}, got {D}")
    if B * H > 65535:
        raise ValueError(f"the attention kernel takes at most 65535 (batch, head) pairs, got {B * H}")

    o = torch.empty_like(q)

    status = _build.library().azula_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B * H, L, D, scale, _DTYPES[q.dtype], _build.stream(q.device),
    )
    _build.check(status, "attention_fwd")
    _build.LAUNCHES["attention_fwd"] += 1

    return o


def dot_product_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    mask: Tensor | None = None,
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
    scale: float | None = None,
    implementation: str | None = None,
    max_free: bool = False,
) -> Tensor:
    r"""Computes scaled dot-product attention.

    .. math:: \mathrm{softmax}\left(\frac{q k^\top}{\sqrt{D}}\right) v

    Arguments:
        q: Queries, with shape :math:`(*, H, L, D)`.
        k: Keys, with shape :math:`(*, H, L, D)`.
        v: Values, with shape :math:`(*, H, L, D)`.
        mask: Optional boolean or additive mask, broadcastable to :math:`(L, L)`.
            Only the plain version takes it.
        dropout_rate: Attention-weight dropout rate. Not ported yet: must be 0.
        generator: The generator of the dropout mask (the JAX `key`).
        scale: Logit scale; defaults to :math:`1 / \sqrt{D}`.
        implementation: :py:`None` or `'auto'` (the kernel for CUDA tensors,
            the plain version for CPU tensors), `'kernel'` (raises on the CPU)
            or `'plain'`.
        max_free: Accepted for the JAX signature; the kernel always keeps the
            exact row max.

    Returns:
        The attention output, with shape :math:`(*, H, L, D)`.
    """

    if implementation not in (None, "auto", "kernel", "plain"):
        raise ValueError(f"unknown attention implementation '{implementation}'")

    if dropout_rate > 0:
        raise NotImplementedError(
            "attention dropout is not ported yet (training kernels, ROADMAP B)"
        )

    if scale is None:
        scale = 1 / math.sqrt(q.shape[-1])

    if implementation in (None, "auto"):
        implementation = "kernel" if q.device.type == "cuda" else "plain"

    if implementation == "plain":
        return _attention_plain(q, k, v, mask=mask, scale=scale)

    if mask is not None:
        raise NotImplementedError(
            "the attention kernel takes no mask yet (masked flash forward, ROADMAP B)"
        )

    return _attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(), scale)
