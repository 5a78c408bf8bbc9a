r"""Scaled dot-product attention.

Port of :func:`azula_tpu.ops.attention.dot_product_attention`, with its
signature and its (B, H, L, D) layout. Two versions compute it: the
hand-written flash-attention forward (`csrc/attention_fwd.cu`) for tensors
on the card, and a plain PyTorch version for tensors on the CPU. The kernel
has a second entry, the max-free forward of `_pallas_attention_blocked` and
of `_pallas_attention`'s `max_free` option, with its own plain version.

When autograd records the call on the card, :func:`_flash` runs instead: the
port of JAX's `_flash` custom vjp, whose forward is the same kernel's third
entry, writing the rows' log-sum-exp (`_pallas_attention(with_lse=True)`),
and whose backward is the FlashAttention-2 pair of `csrc/attention_bwd.cu`
(`_pallas_attention_bwd` and `_pallas_attention_batched_bwd`).

Also :func:`_flash_blhd`, the differentiable flash attention on the
projection layout :math:`(B, L, H D)` that fused MSA's training route runs:
hand-written forward and backward kernels (`csrc/flash_blhd_fwd.cu`,
`csrc/flash_blhd_bwd.cu`) on the card, plain PyTorch versions of the JAX
kernel bodies on the CPU.
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

# JAX's `_MAX_FREE_CLAMP`: the logit clamp of the max-free softmax
_MAX_FREE_CLAMP = 80.0

# JAX's `_BATCHED_MAX_L`: at or below it the TPU dispatch takes the batched
# kernel, which ignores max_free
_BATCHED_MAX_L = 512

# the head dims and the bound on L of the JAX package's fused gate, which the
# (B, L, H D) kernels here and the fused MSA kernel (ops/fused_msa.py) take
_BLHD_HEAD_DIMS = (64, 128, 192, 256)
_BLHD_MAX_L = 512


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


def _attention_max_free_plain(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    r"""Plain PyTorch version of the `max_free` forward of
    `_pallas_attention_blocked` and `_pallas_attention`
    (azula_tpu/ops/attention.py): float32 logits, no row max,
    :math:`p = \exp(\min(s, 80))`; the denominator sums p unrounded, the
    value product takes p rounded to the input dtype with float32
    accumulation, and the product is divided by the denominator."""

    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(torch.clamp(logits, max=_MAX_FREE_CLAMP))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), v.float())

    return (o / l).to(q.dtype)


def _attention_lse_plain(q: Tensor, k: Tensor, v: Tensor, scale: float) -> tuple[Tensor, Tensor]:
    r"""Plain PyTorch version of `_pallas_attention` with `with_lse=True`
    (azula_tpu/ops/attention.py): float32 logits, the row max m, the
    exp-weights p and their sum d; in float32 the weights are normalized
    before the value product, below float32 they enter it rounded to the
    input dtype (float32 accumulation) and the product is divided by d.
    Returns o and the float32 (B, H, L) log-sum-exp :math:`m + \log d`."""

    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    d = p.sum(dim=-1, keepdim=True)

    if q.dtype == torch.float32:
        o = torch.matmul(p / d, v)
    else:
        o = torch.matmul(p.to(q.dtype).float(), v.float()) / d

    return o.to(q.dtype), (m + torch.log(d)).squeeze(-1)


def _softmax_grads(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, g: Tensor, p: Tensor, scale: float, dtype: torch.dtype
) -> tuple[Tensor, Tensor, Tensor]:
    r"""dq, dk, dv in float32 from float32 (..., L, D) q, k, v, the stored o,
    the cotangent g and the softmax p, with the rounding points of the JAX
    backward kernels: dp = g v^T, delta = rowsum(g o), ds = p (dp - delta)
    scale rounded to `dtype`, then dq = ds k, dk = ds^T q and dv = p16^T g
    with p rounded to `dtype`, each summed in float32."""

    dp = torch.matmul(g, v.transpose(-1, -2))
    delta = torch.sum(g * o, dim=-1, keepdim=True)

    ds = (p * (dp - delta) * scale).to(dtype).float()
    p16 = p.to(dtype).float()

    return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), torch.matmul(p16.transpose(-1, -2), g)


def _attention_bwd_plain(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, g: Tensor, scale: float
) -> tuple[Tensor, Tensor, Tensor]:
    r"""Plain PyTorch version of `_pallas_attention_bwd` and
    `_pallas_attention_batched_bwd` (azula_tpu/ops/attention.py) on
    (B, H, L, D): g cast to the inputs' dtype, p = exp(s - lse) rebuilt in
    float32 from the float32 (B, H, L) log-sum-exp, then the rounding points
    of `_softmax_grads`. Returns dq, dk, dv in the inputs' dtype."""

    dtype = q.dtype
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, g.to(dtype)))

    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])

    return tuple(t.to(dtype) for t in _softmax_grads(qf, kf, vf, of, gf, p, scale, dtype))


def _check_bhld(tensors: tuple[Tensor, ...], name: str) -> tuple[int, int, int, int]:
    r"""Raises unless the (B, H, L, D) tensors are what the attention kernels
    take: CUDA, float32 or bfloat16, one shape, contiguous and aligned;
    returns (B, H, L, D)."""

    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"the {name} kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the {name} kernel takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 4:
        raise ValueError(f"the {name} kernel takes (B, H, L, D) tensors, got {tuple(q.shape)}")
    for t in tensors[1:]:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"the {name} kernel takes tensors of q's shape, dtype and device (self-attention)")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the {name} kernel takes contiguous, 16-byte aligned tensors")

    B, H, L, D = q.shape

    if D not in _HEAD_DIMS:
        raise ValueError(f"the {name} kernel takes head dims {_HEAD_DIMS}, got {D}")
    if B * H > 65535:
        raise ValueError(f"the {name} kernel takes at most 65535 (batch, head) pairs, got {B * H}")

    return B, H, L, D


def _launch_attention(name: str, q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    r"""Launches the inference entry `azula_<name>` of `csrc/attention_fwd.cu`
    on CUDA tensors (B, H, L, D)."""

    B, H, L, D = _check_bhld((q, k, v), name)
    o = torch.empty_like(q)

    status = getattr(_build.library(), f"azula_{name}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B * H, L, D, scale, _DTYPES[q.dtype], _build.stream(q.device),
    )
    _build.check(status, name)
    _build.LAUNCHES[name] += 1

    return o


# the direct wrappers' backward: JAX's training route, and so the port's, is `_flash`
_TRAINING_ROUTE = "under grad, dot_product_attention takes the LSE forward and the attention backward kernels"


@_build.forward_only("attention_fwd", _TRAINING_ROUTE)
def _attention_kernel(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    r"""Launches the exact flash forward of `csrc/attention_fwd.cu`."""

    return _launch_attention("attention_fwd", q, k, v, scale)


@_build.forward_only("attention_fwd_max_free", _TRAINING_ROUTE)
def _attention_max_free_kernel(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    r"""Launches the max-free flash forward of `csrc/attention_fwd.cu`."""

    return _launch_attention("attention_fwd_max_free", q, k, v, scale)


def _attention_lse_kernel(q: Tensor, k: Tensor, v: Tensor, scale: float) -> tuple[Tensor, Tensor]:
    r"""Launches the LSE entry of `csrc/attention_fwd.cu`; returns o and the
    float32 (B, H, L) log-sum-exp."""

    B, H, L, D = _check_bhld((q, k, v), "attention_fwd_lse")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)

    status = _build.library().azula_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B * H, L, D, scale, _DTYPES[q.dtype], _build.stream(q.device),
    )
    _build.check(status, "attention_fwd_lse")
    _build.LAUNCHES["attention_fwd_lse"] += 1

    return o, lse


def _attention_bwd_kernel(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, g: Tensor, scale: float
) -> tuple[Tensor, Tensor, Tensor]:
    r"""Launches `csrc/attention_bwd.cu` (its dq and dk/dv kernels, counted as
    one launch); returns dq, dk, dv."""

    B, H, L, D = _check_bhld((q, k, v, o, g), "attention_bwd")
    if lse.shape != (B, H, L) or lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"the log-sum-exp must be float32 (B, H, L) = {(B, H, L)} on {q.device}")

    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)

    status = _build.library().azula_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        B * H, L, D, scale, _DTYPES[q.dtype], _build.stream(q.device),
    )
    _build.check(status, "attention_bwd")
    _build.LAUNCHES["attention_bwd"] += 1

    return dq, dk, dv


class _Flash(torch.autograd.Function):
    r"""JAX's `_flash` with its custom vjp (`_flash_fwd`, `_flash_bwd`) as a
    node of the autograd graph: the forward saves q, k, v, o and the rows'
    log-sum-exp, the backward rebuilds the softmax from them; the kernels on
    the card, or the plain versions on the CPU. Like the custom vjp, it has
    no second derivative."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kernel):
        o, lse = (_attention_lse_kernel if kernel else _attention_lse_plain)(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.kernel = scale, kernel

        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.to(q.dtype)  # as `_pallas_attention_bwd` casts the cotangent

        if ctx.kernel:
            dq, dk, dv = _attention_bwd_kernel(q, k, v, o, lse, g.contiguous(), ctx.scale)
        else:
            dq, dk, dv = _attention_bwd_plain(q, k, v, o, lse, g, ctx.scale)

        return dq, dk, dv, None, None


def _flash(q: Tensor, k: Tensor, v: Tensor, scale: float, implementation: str | None = None) -> Tensor:
    r"""Differentiable flash attention over :math:`(B, H, L, D)` tensors, for
    unmasked, dropout-free self-attention.

    Port of `azula_tpu.ops.attention._flash` under `jax.grad`: the forward
    writes the rows' log-sum-exp, and the backward casts the cotangent to the
    inputs' dtype and returns dq, dk, dv. JAX's `_flash_fwd` writes the LSE
    above :math:`L = 512` only and its batched backward recomputes the
    softmax below; here the LSE is written at every length, which gives the
    same function. `max_free` does not apply: `_flash_fwd` ignores it.

    Arguments:
        q, k, v: Queries, keys and values, with shape :math:`(B, H, L, D)`.
        scale: The logit scale.
        implementation: :py:`None` or `'auto'` (the kernels for CUDA tensors,
            the plain versions for CPU tensors), `'kernel'` (raises on the
            CPU) or `'plain'`.

    Returns:
        The attention output, with shape :math:`(B, H, L, D)`.
    """

    if implementation not in (None, "auto", "kernel", "plain"):
        raise ValueError(f"unknown flash implementation '{implementation}'")

    if implementation in (None, "auto"):
        implementation = "kernel" if q.device.type == "cuda" else "plain"

    kernel = implementation == "kernel"
    if kernel:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()

    return _Flash.apply(q, k, v, scale, kernel)


def _max_free_route(q: Tensor) -> bool:
    r"""Whether the JAX package's TPU dispatch threads `max_free` to a kernel
    for this unmasked, dropout-free self-attention: `_use_pallas` admits
    :math:`L \geq 512`, :math:`L \bmod 128 = 0`, :math:`D \bmod 64 = 0`,
    :math:`D \leq 256`, and `_pallas_dispatch` passes `max_free` on only
    above :math:`L = 512` (to `_pallas_attention` up to 2048, to
    `_pallas_attention_blocked` beyond)."""

    if q.ndim != 4:
        return False

    L, D = q.shape[-2:]

    return L > _BATCHED_MAX_L and L % 128 == 0 and D % 64 == 0 and D <= 256


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
        implementation: :py:`None` or `'auto'` (the kernels for CUDA
            tensors, the plain version for CPU tensors), `'kernel'` (raises on
            the CPU) or `'plain'`. When autograd records a kernel call (grad
            enabled and any of q, k, v requiring it), the call goes to
            :func:`_flash`, the LSE forward and the backward kernels, as
            JAX's `_flash` custom vjp runs under `jax.grad`; otherwise to the
            inference forward. The plain version is differentiated by
            autograd, the counterpart of JAX's XLA path on the CPU.
        max_free: The softmax without a row max, for logits bounded by
            construction (RMS-normalized q and k, as in Flux): the weights are
            :math:`\exp(\min(s, 80))`. Taken where the JAX package takes it,
            on the card's unmasked inference route for self-attention with
            :math:`L > 512`, :math:`L \bmod 128 = 0` and
            :math:`D \bmod 64 = 0` (the max-free kernel); everywhere else,
            the plain version on the CPU and the training route included, the
            exact softmax is computed, as JAX's XLA path and its `_flash_fwd`
            ignore the flag.

    Returns:
        The attention output, with shape :math:`(*, H, L, D)`.
    """

    if implementation not in (None, "auto", "kernel", "plain"):
        raise ValueError(f"unknown attention implementation '{implementation}'")

    if dropout_rate > 0:
        raise NotImplementedError(
            "attention dropout is not ported yet (the dropout hash, ROADMAP A17 (c))"
        )

    if scale is None:
        scale = 1 / math.sqrt(q.shape[-1])

    if implementation in (None, "auto"):
        implementation = "kernel" if q.device.type == "cuda" else "plain"

    if implementation == "plain":
        return _attention_plain(q, k, v, mask=mask, scale=scale)

    if mask is not None:
        raise NotImplementedError(
            "the attention kernels take no mask yet (the bias modes, ROADMAP A17 (c))"
        )

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _flash(q, k, v, scale, implementation="kernel")

    kernel = _attention_max_free_kernel if max_free and _max_free_route(q) else _attention_kernel

    return kernel(q.contiguous(), k.contiguous(), v.contiguous(), scale)


def _split_heads(x: Tensor, heads: int) -> Tensor:
    r"""(B, L, H D) -> (B, H, L, D), as float32."""

    return x.unflatten(-1, (heads, -1)).transpose(1, 2).float()


def _merge_heads(x: Tensor, dtype: torch.dtype) -> Tensor:
    r"""(B, H, L, D) -> (B, L, H D), rounded to `dtype`."""

    return x.to(dtype).transpose(1, 2).flatten(2)


def _flash_blhd_fwd_plain(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float) -> Tensor:
    r"""Plain PyTorch version of `_flash_blhd_fwd_kernel`
    (azula_tpu/ops/attention.py): float32 logits times the scale, the row max,
    exp, the row sum; the exp-weights rounded to the input dtype enter the
    value product with float32 accumulation, and the product is divided by
    the sum, in both dtypes."""

    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))

    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    d = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), vh)

    return _merge_heads(o / d, q.dtype)


def _flash_blhd_bwd_plain(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, g: Tensor, heads: int, scale: float
) -> tuple[Tensor, Tensor, Tensor]:
    r"""Plain PyTorch version of `_flash_blhd_bwd_kernel`
    (azula_tpu/ops/attention.py): p recomputed in float32, dp = g v^T,
    delta = rowsum(g o) of the stored o and g, ds = p (dp - delta) scale
    rounded to the input dtype, then dq = ds k, dk = ds^T q and
    dv = p16^T g, each accumulated in float32 and rounded."""

    dtype = q.dtype
    qh, kh, vh, oh, gh = (_split_heads(t, heads) for t in (q, k, v, o, g))

    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)

    return tuple(_merge_heads(t, dtype) for t in _softmax_grads(qh, kh, vh, oh, gh, p, scale, dtype))


def _check_blhd(tensors: tuple[Tensor, ...], heads: int) -> tuple[int, int, int, int]:
    r"""Raises unless the (B, L, H D) tensors are what the kernels take;
    returns (B, L, H, D)."""

    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"the flash_blhd kernels need CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the flash_blhd kernels take float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or x.shape[-1] % heads:
        raise ValueError(f"the flash_blhd kernels take (B, L, H D) with H = {heads}, got {tuple(x.shape)}")
    for t in tensors:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError("the flash_blhd kernels take tensors of one shape, dtype and device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the flash_blhd kernels take contiguous, 16-byte aligned tensors")

    B, L, C = x.shape
    D = C // heads

    if D not in _BLHD_HEAD_DIMS:
        raise ValueError(f"the flash_blhd kernels take head dims {_BLHD_HEAD_DIMS}, got {D}")
    if L > _BLHD_MAX_L:
        raise ValueError(f"the flash_blhd kernels take L <= {_BLHD_MAX_L}, got {L}")
    if B * heads > 65535:
        raise ValueError(f"the flash_blhd kernels take at most 65535 (batch, head) pairs, got {B * heads}")

    return B, L, heads, D


def _flash_blhd_fwd_kernel(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float) -> tuple[Tensor, Tensor, Tensor]:
    r"""Launches `csrc/flash_blhd_fwd.cu`; returns o and the float32 (B, H, L)
    row max and denominator."""

    B, L, H, D = _check_blhd((q, k, v), heads)

    o = torch.empty_like(q)
    m = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)

    status = _build.library().azula_flash_blhd_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, L, H, D, scale, _DTYPES[q.dtype], _build.stream(q.device),
    )
    _build.check(status, "flash_blhd_fwd")
    _build.LAUNCHES["flash_blhd_fwd"] += 1

    return o, m, l


def _flash_blhd_bwd_kernel(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, g: Tensor, m: Tensor, l: Tensor, heads: int, scale: float
) -> tuple[Tensor, Tensor, Tensor]:
    r"""Launches `csrc/flash_blhd_bwd.cu`; returns dq, dk, dv."""

    B, L, H, D = _check_blhd((q, k, v, o, g), heads)
    for t in (m, l):
        if t.shape != (B, H, L) or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"the row statistics must be float32 (B, H, L) = {(B, H, L)} on {q.device}")

    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(m)

    status = _build.library().azula_flash_blhd_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        B, L, H, D, scale, _DTYPES[q.dtype], _build.stream(q.device),
    )
    _build.check(status, "flash_blhd_bwd")
    _build.LAUNCHES["flash_blhd_bwd"] += 1

    return dq, dk, dv


class _FlashBLHD(torch.autograd.Function):
    r"""`_flash_blhd` as a node of the autograd graph: the kernels on the
    card, whose forward saves the rows' max and denominator for the
    backward, or the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale, kernel):
        if kernel:
            o, m, l = _flash_blhd_fwd_kernel(q, k, v, heads, scale)
            ctx.save_for_backward(q, k, v, o, m, l)
        else:
            o = _flash_blhd_fwd_plain(q, k, v, heads, scale)
            ctx.save_for_backward(q, k, v, o)

        ctx.heads, ctx.scale, ctx.kernel = heads, scale, kernel

        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, *stats = ctx.saved_tensors
        g = g.to(q.dtype)  # as `_flash_blhd_bwd` casts the cotangent

        if ctx.kernel:
            dq, dk, dv = _flash_blhd_bwd_kernel(q, k, v, o, g.contiguous(), *stats, ctx.heads, ctx.scale)
        else:
            dq, dk, dv = _flash_blhd_bwd_plain(q, k, v, o, g, ctx.heads, ctx.scale)

        return dq, dk, dv, None, None, None


def _flash_blhd(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    heads: int,
    scale: float,
    implementation: str | None = None,
) -> Tensor:
    r"""Differentiable flash attention over :math:`(B, L, H D)` tensors, the
    layout of the fused QKV projection, for short self-attention
    (:math:`L \leq 512`, no mask, no dropout).

    Port of `azula_tpu.ops.attention._flash_blhd` and its `custom_vjp`: the
    backward casts the cotangent to the inputs' dtype and returns dq, dk, dv.

    Arguments:
        q, k, v: Queries, keys and values, with shape :math:`(B, L, H D)`.
        heads: The number of heads :math:`H`.
        scale: The logit scale.
        implementation: :py:`None` or `'auto'` (the kernels for CUDA tensors,
            the plain versions for CPU tensors), `'kernel'` (raises on the
            CPU) or `'plain'`.

    Returns:
        The attention output, with shape :math:`(B, L, H D)`.
    """

    if implementation not in (None, "auto", "kernel", "plain"):
        raise ValueError(f"unknown flash_blhd implementation '{implementation}'")

    if implementation in (None, "auto"):
        implementation = "kernel" if q.device.type == "cuda" else "plain"

    kernel = implementation == "kernel"
    if kernel:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()

    return _FlashBLHD.apply(q, k, v, heads, scale, kernel)
