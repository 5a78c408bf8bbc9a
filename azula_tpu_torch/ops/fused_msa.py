r"""Fused multi-head self-attention: QK RMS-norm, RoPE and attention in one pass.

Port of :mod:`azula_tpu.ops.fused_msa`. The function reads the QKV projection
output in its matmul layout :math:`(B, L, 3 H D)` and writes
:math:`(B, L, H D)`, the tensors that the projections on either side produce
and take, so no head transpose goes through memory. Two versions compute it:
the hand-written kernel (`csrc/fused_msa.cu`) for tensors on the card, and a
plain PyTorch version for tensors on the CPU, which follows the JAX
package's `_reference` op by op (its rounding points included): normalize,
rotate, round q and k to the input dtype, then attend. The kernel's bf16
form runs on the tensor cores and rounds the exp-weights against the
running max of key tiles; `_fused_msa_tiled_plain` repeats its arithmetic.
Its float32 form runs on the CUDA cores.

Under grad on the card, the function takes the JAX package's training route
(`_fused_fwd`): `_reference_core_flash`, the norm and rotation in mixed
precision as PyTorch ops, then the differentiable flash attention of
:func:`azula_tpu_torch.ops.attention._flash_blhd`, whose forward and backward
are kernels. The serving kernel has no backward.
"""

from __future__ import annotations

__all__ = [
    "fused_msa_attention",
    "fused_msa_eligible",
    "rope_tables",
]

import math
import torch

from torch import Tensor

from . import _build
from ..utils import profiling
from .attention import _BLHD_HEAD_DIMS, _BLHD_MAX_L, _attention_tiled_plain, _flash_blhd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rope_tables(theta: Tensor, heads: int) -> tuple[Tensor, Tensor]:
    r"""Expands per-head rotary angles into full-width cos / signed-sin tables.

    `theta` has shape :math:`(L, H D / 2)` with head-blocked features (as
    `MultiheadSelfAttention.theta_proj` makes them). Returns float32
    `(cos2, sin2)` of shape :math:`(L, H D)` such that the interleaved
    rotation of `apply_rope` is

    .. math:: \mathrm{rope}(x) = x \cdot \mathrm{cos2} + \mathrm{swap}(x) \cdot \mathrm{sin2}

    where `swap` exchanges each even/odd lane pair: :math:`-\sin` on even
    lanes, :math:`+\sin` on odd ones.
    """

    L, half = theta.shape
    D2 = half // heads

    th = theta.float().reshape(L, heads, D2)
    cos2 = torch.repeat_interleave(torch.cos(th), 2, dim=-1).reshape(L, 2 * half)
    sgn = torch.tensor([-1.0, 1.0], device=theta.device).repeat(D2)
    sin2 = (torch.repeat_interleave(torch.sin(th), 2, dim=-1) * sgn).reshape(L, 2 * half)

    return cos2, sin2


def _prepare(
    qkv: Tensor,
    cos2: Tensor | None,
    sin2: Tensor | None,
    heads: int,
    eps: float | None,
) -> tuple[Tensor, Tensor, Tensor]:
    r"""q, k and v of `_reference`'s attention core, (B, H, L, D) in the input
    dtype: float32 RMS-norm and rotation of q and k, then q and k rounded to
    the input dtype; v as it is."""

    B, L, C3 = qkv.shape
    C = C3 // 3
    D = C // heads

    x = qkv.reshape(B, L, 3, heads, D)
    q, k, v = x[:, :, 0].float(), x[:, :, 1].float(), x[:, :, 2]  # (B, L, H, D)

    if eps is not None:
        q = q * torch.rsqrt(torch.mean(torch.square(q), dim=-1, keepdim=True) + eps)
        k = k * torch.rsqrt(torch.mean(torch.square(k), dim=-1, keepdim=True) + eps)

    if cos2 is not None:
        c = cos2.float().reshape(L, heads, D)
        s = sin2.float().reshape(L, heads, D)

        def swap(z):
            return z.unflatten(-1, (D // 2, 2)).flip(-1).flatten(-2)

        q = q * c + swap(q) * s
        k = k * c + swap(k) * s

    return q.to(qkv.dtype).transpose(1, 2), k.to(qkv.dtype).transpose(1, 2), v.transpose(1, 2)


def _fused_msa_plain(
    qkv: Tensor,
    cos2: Tensor | None,
    sin2: Tensor | None,
    heads: int,
    eps: float | None,
    scale: float,
) -> Tensor:
    r"""Plain PyTorch version of `_reference` (azula_tpu/ops/fused_msa.py):
    float32 RMS-norm and rotation, q and k rounded to the input dtype, float32
    logits with the row max subtracted; in float32 the weights are divided
    before the value product, below float32 the unnormalized weights are
    rounded to the input dtype, multiplied with float32 accumulation, and the
    product is divided."""

    B, L, C3 = qkv.shape
    q, k, v = _prepare(qkv, cos2, sin2, heads, eps)
    q, k = q.float(), k.float()

    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    d = p.sum(dim=-1, keepdim=True)

    if qkv.dtype == torch.float32:
        o = torch.matmul(p / d, v)
    else:
        o = torch.matmul(p.to(qkv.dtype).float(), v.float()) / d

    return o.to(qkv.dtype).transpose(1, 2).reshape(B, L, C3 // 3)


def _fused_msa_tiled_plain(
    qkv: Tensor,
    cos2: Tensor | None,
    sin2: Tensor | None,
    heads: int,
    eps: float | None,
    scale: float,
) -> Tensor:
    r"""Plain PyTorch version of the bf16 tensor-core form of
    `csrc/fused_msa.cu`, with its rounding points: the preparation of
    :func:`_fused_msa_plain`, then :func:`_attention_tiled_plain` on the
    (B, H, L, D) heads, whose online softmax rounds the weights to the input
    dtype against the running max of :func:`_key_tile`-wide key tiles.

    Returns o as (B, L, H D) in float32, not rounded to the input dtype, so
    that a check holds the kernel to its own last rounding. Nothing on a
    card path calls it."""

    B, L, C3 = qkv.shape
    q, k, v = _prepare(qkv, cos2, sin2, heads, eps)
    o, _ = _attention_tiled_plain(q, k, v, scale)

    return o.transpose(1, 2).reshape(B, L, C3 // 3)


def _reference_core_flash(
    qkv: Tensor,
    cos2: Tensor | None,
    sin2: Tensor | None,
    heads: int,
    eps: float | None,
    scale: float,
    implementation: str | None = None,
) -> Tensor:
    r"""Port of `_reference_core_flash` (azula_tpu/ops/fused_msa.py): the
    `_reference` math in mixed precision, with the attention core swapped for
    :func:`_flash_blhd`. The RMS statistics are float32 and the normalization
    is applied in the input dtype; the rope tables are cast to the input
    dtype before the rotation; q, k and v go to the flash attention as
    :math:`(B, L, H D)` views of the projection, heads in place.
    `implementation` is passed to :func:`_flash_blhd`."""

    B, L, C3 = qkv.shape
    C = C3 // 3
    D = C // heads

    x = qkv.reshape(B, L, 3, heads, D)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]  # (B, L, H, D)

    def norm(z):
        r = torch.rsqrt(torch.mean(torch.square(z.float()), dim=-1, keepdim=True) + eps)
        return z * r.to(z.dtype)

    if eps is not None:
        q, k = norm(q), norm(k)

    if cos2 is not None:
        c = cos2.to(qkv.dtype).reshape(L, heads, D)
        s = sin2.to(qkv.dtype).reshape(L, heads, D)

        def swap(z):
            return z.unflatten(-1, (D // 2, 2)).flip(-1).flatten(-2)

        q = q * c + swap(q) * s
        k = k * c + swap(k) * s

    return _flash_blhd(
        q.reshape(B, L, C), k.reshape(B, L, C), v.reshape(B, L, C), heads, scale, implementation
    )


@_build.forward_only(
    "fused_msa", "under grad, call fused_msa_attention: it takes the flash route, whose kernels have one"
)
def _fused_msa_kernel(
    qkv: Tensor,
    cos2: Tensor | None,
    sin2: Tensor | None,
    heads: int,
    eps: float | None,
    scale: float,
) -> Tensor:
    r"""Launches `csrc/fused_msa.cu` on a CUDA tensor (B, L, 3 H D)."""

    if qkv.device.type != "cuda":
        raise ValueError(f"the fused MSA kernel needs CUDA tensors, got {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"the fused MSA kernel takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"the fused MSA kernel takes (B, L, 3 H D) with H = {heads}, got {tuple(qkv.shape)}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the fused MSA kernel takes a contiguous, 16-byte aligned qkv")

    B, L, C3 = qkv.shape
    C = C3 // 3
    D = C // heads

    if D not in _BLHD_HEAD_DIMS:
        raise ValueError(f"the fused MSA kernel takes head dims {_BLHD_HEAD_DIMS}, got {D}")
    if B * heads > 65535:
        raise ValueError(f"the fused MSA kernel takes at most 65535 (batch, head) pairs, got {B * heads}")

    if cos2 is not None:
        for t in (cos2, sin2):
            if t.shape != (L, C) or t.dtype != torch.float32 or t.device != qkv.device:
                raise ValueError(f"the rope tables must be float32 (L, H D) = {(L, C)} on {qkv.device}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("the rope tables must be contiguous and 16-byte aligned")

    o = torch.empty((B, L, C), dtype=qkv.dtype, device=qkv.device)

    status = _build.library().azula_fused_msa(
        qkv.data_ptr(),
        None if cos2 is None else cos2.data_ptr(),
        None if sin2 is None else sin2.data_ptr(),
        o.data_ptr(),
        B, L, heads, D,
        0.0 if eps is None else eps, int(eps is not None),
        scale, _DTYPES[qkv.dtype], _build.stream(qkv.device),
    )
    _build.check(status, "fused_msa")
    _build.launched("fused_msa", o)

    return o


def fused_msa_eligible(
    x: Tensor,
    heads: int,
    theta: Tensor | None,
    mask: Tensor | None,
    dropout: float,
    generator: torch.Generator | None,
) -> bool:
    r"""True when the fused route applies: `x` on a CUDA device, 3-d
    self-attention with unbatched positions, no mask, no dropout, and the
    shapes of the JAX gate (`azula_tpu/ops/fused_msa.py`)."""

    if x.device.type != "cuda":
        return False
    if x.ndim != 3 or mask is not None:
        return False
    if generator is not None and dropout > 0:
        return False
    if theta is not None and theta.ndim != 2:
        return False
    if x.dtype not in _DTYPES:
        return False

    L = x.shape[-2]
    D = x.shape[-1] // heads

    return L % 128 == 0 and 128 <= L <= _BLHD_MAX_L and D % 64 == 0 and D <= 256 and heads <= 12


def fused_msa_attention(
    qkv: Tensor,
    heads: int,
    theta: Tensor | None = None,
    eps: float | None = 1e-5,
    scale: float | None = None,
    implementation: str | None = None,
) -> Tensor:
    r"""Computes QK-normalized, rotary-embedded multi-head self-attention
    directly on the fused QKV projection output.

    Arguments:
        qkv: The QKV projection output, with shape :math:`(B, L, 3 H D)` and
            feature layout :math:`[q | k | v]`, each head-blocked.
        heads: The number of attention heads :math:`H`.
        theta: Optional rotary angles, with shape :math:`(L, H D / 2)`.
        eps: The QK RMS-norm epsilon, or :py:`None` to skip normalization.
        scale: Logit scale; defaults to :math:`1 / \sqrt{D}`.
        implementation: :py:`None` or `'auto'` (the kernels for CUDA
            tensors, the plain version for CPU tensors), `'kernel'` (raises on
            the CPU) or `'plain'`. Under grad, when `qkv` or `theta` requires
            it, the kernel route runs `_reference_core_flash` on the
            `_flash_blhd` kernels, whose backward is a kernel too; otherwise
            it runs the serving kernel. The plain version is differentiated
            by autograd.

    Returns:
        The attention output, with shape :math:`(B, L, H D)`, heads merged in
        the feature layout of the unfused path.
    """

    with profiling.annotate("azula.ops.fused_msa"):
        if implementation not in (None, "auto", "kernel", "plain"):
            raise ValueError(f"unknown fused MSA implementation '{implementation}'")

        D = qkv.shape[-1] // 3 // heads

        if scale is None:
            scale = 1 / math.sqrt(D)

        if theta is not None:
            cos2, sin2 = rope_tables(theta, heads)
        else:
            cos2 = sin2 = None

        if implementation in (None, "auto"):
            implementation = "kernel" if qkv.device.type == "cuda" else "plain"

        if implementation == "plain":
            return _fused_msa_plain(qkv, cos2, sin2, heads, eps, scale)

        # as the JAX package's `_fused` custom_vjp: the serving kernel has no
        # backward, so a forward that autograd records takes the flash route
        if torch.is_grad_enabled() and (qkv.requires_grad or (theta is not None and theta.requires_grad)):
            return _reference_core_flash(qkv, cos2, sin2, heads, eps, scale, implementation="kernel")

        return _fused_msa_kernel(qkv.contiguous(), cos2, sin2, heads, eps, scale)
