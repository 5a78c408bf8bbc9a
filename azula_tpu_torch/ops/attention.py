r"""Scaled dot-product attention.

Port of :func:`azula_tpu.ops.attention.dot_product_attention`, with its
signature and its (B, H, L, D) layout. Two versions compute it: the
hand-written flash-attention forward (`csrc/attention_fwd.cu`) for tensors
on the card, and a plain PyTorch version for tensors on the CPU. The kernel
has a second entry, the max-free forward of `_pallas_attention_blocked` and
of `_pallas_attention`'s `max_free` option, with its own plain version. In
bf16 the kernel runs on the tensor cores and rounds its exp-weights to bf16
against the running max of its key tiles, in every form;
:func:`_attention_tiled_plain` repeats that arithmetic, while the plain
versions of the JAX functions round against the row's final max.

When autograd records the call on the card, :func:`_flash` runs instead: the
port of JAX's `_flash` custom vjp, whose forward is the same kernel's third
entry, writing the rows' log-sum-exp (`_pallas_attention(with_lse=True)`),
and whose backward is `csrc/attention_bwd.cu` (`_pallas_attention_bwd` and
`_pallas_attention_batched_bwd`): in bf16 one pass on the tensor cores that
adds dq's tiles by atomics, in float32 the FlashAttention-2 pair.

Boolean masks and attention dropout take the same kernels, as JAX's
`_flash_biased`, `_flash_dropout` and `_flash_dropout_biased` take its: a
mask becomes an additive bias (`_mask_to_bias`), and the dropout keep mask
is a counter hash of two seed words and the absolute (pair, row, column)
(:func:`dropout_keep_mask`), which the backward regenerates per tile.

Also :func:`_flash_blhd`, the differentiable flash attention on the
projection layout :math:`(B, L, H D)` that fused MSA's training route runs:
hand-written forward and backward kernels (`csrc/flash_blhd_fwd.cu`,
`csrc/flash_blhd_bwd.cu`) on the card, plain PyTorch versions of the JAX
kernel bodies on the CPU. In bf16 they are the tensor-core forward and
backward above, reading the heads in place; the forward saves the rows'
log-sum-exp as the backward's residual, as `_flash` does.
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
_HEAD_DIMS = (32, 64, 128, 192, 256)

# JAX's `_MASKED_OUT`: the bias of a masked key
_MASKED_OUT = -1e30

# the hash runs on int64 lanes holding uint32 values
_M32 = 0xFFFFFFFF

# JAX's `_MAX_FREE_CLAMP`: the logit clamp of the max-free softmax
_MAX_FREE_CLAMP = 80.0

# JAX's `_BATCHED_MAX_L`: at or below it the TPU dispatch takes the batched
# kernel, which ignores max_free
_BATCHED_MAX_L = 512

# the head dims and the bound on L of the JAX package's fused gate, which the
# (B, L, H D) kernels here and the fused MSA kernel (ops/fused_msa.py) take
_BLHD_HEAD_DIMS = (64, 128, 192, 256)
_BLHD_MAX_L = 512


def _masked_logits(q: Tensor, k: Tensor, mask: Tensor | None, scale: float) -> Tensor:
    r"""The float32 logits of the XLA path, -inf where a boolean mask is
    False, plus an additive mask (which keeps its gradient)."""

    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits * scale

    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, -math.inf)
        else:
            logits = logits + mask

    return logits


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
    denominator divides afterwards. A row that a boolean mask masks
    everywhere gives NaN, as on XLA (the kernels' -1e30 bias gives the mean
    of v, as the TPU kernels do)."""

    if scale is None:
        scale = 1 / math.sqrt(q.shape[-1])

    logits = _masked_logits(q, k, mask, scale)

    m = logits.amax(dim=-1, keepdim=True)
    weights = torch.exp(logits - m)
    denom = weights.sum(dim=-1, dtype=torch.float32)

    if q.dtype == torch.float32:
        out = torch.matmul(weights / denom[..., None], v)
    else:
        out = torch.matmul(weights.to(q.dtype).float(), v.float())
        out = out / denom[..., None]

    return out.to(q.dtype)


def _attention_dropout_plain(
    q: Tensor, k: Tensor, v: Tensor, mask: Tensor | None, rate: float, generator: torch.Generator, scale: float
) -> Tensor:
    r"""Plain PyTorch version of the dropout fallback of JAX's
    `dot_product_attention` (every dropout call off the TPU, and the shapes
    its kernels do not take): the float32 softmax of the masked logits, a
    Bernoulli keep mask drawn from `generator` (of the tensors' device), kept
    weights scaled by 1 / (1 - rate) and rounded to q's dtype before the
    value product."""

    weights = torch.softmax(_masked_logits(q, k, mask, scale), dim=-1)
    keep = torch.rand(weights.shape, generator=generator, device=weights.device) < 1 - rate
    weights = torch.where(keep, weights / (1 - rate), 0.0)

    return torch.matmul(weights.to(q.dtype), v)


def _dropout_threshold(rate: float) -> int:
    r"""JAX's `_dropout_threshold`: the *signed* int32 threshold t with
    P(bits >= t) = 1 - rate for uniform bits read as int32 (the uint32
    threshold moved down by 2^31, so that rate 0.5 gives 0 and does not wrap
    to INT32_MIN)."""

    return min(int(rate * 2**32), 2**32 - 1) - 2**31


def _mul32(h: Tensor, c: int) -> Tensor:
    r"""h c mod 2^32 for uint32 values h on int64 lanes and a constant
    c < 2^32: c times each 16-bit half of h stays below 2^48, so nothing
    overflows int64."""

    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h: Tensor) -> Tensor:
    r"""JAX's `_fmix32`, the murmur3 finalizer, on uint32 values held in
    int64 lanes: the shifts are logical there (JAX's `shift_right_logical`,
    where torch's `>>` on int32 is arithmetic), and `_mul32` wraps the
    products as int32 arithmetic does."""

    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _keep_mask(rows: Tensor, cols: Tensor, pairs: Tensor, seed: Tensor, rate: float) -> Tensor:
    r"""JAX's `_keep_mask` at absolute (row, column, pair) coordinates
    (broadcast int64 tensors): `_hash_bits` of the coordinates and the two
    int32 seed words, read as int32 and kept where at least
    `_dropout_threshold(rate)`."""

    s0, s1 = (seed.to(torch.int64) & _M32).unbind()
    h = ((rows * 0x9E3779B1) & _M32) ^ ((cols * 1000003) & _M32) ^ ((pairs * 0x27D4EB2F) & _M32) ^ s0
    bits = _fmix32(_fmix32(h) ^ s1)

    return bits - ((bits >> 31) << 32) >= _dropout_threshold(rate)


def dropout_keep_mask(B: int, H: int, L: int, seed: Tensor, rate: float) -> Tensor:
    r"""The (B, H, L, L) keep mask that the dropout kernels apply for two seed
    words: port of :func:`azula_tpu.ops.attention.dropout_keep_mask`, bit
    for bit, on the seed's device.

    Arguments:
        B, H, L: Batch, heads, and sequence length.
        seed: The two int32 seed words, as passed to the kernels.
        rate: The dropout rate.

    Returns:
        A boolean tensor of shape :math:`(B, H, L, L)`; True keeps the weight.
    """

    device = seed.device
    rows = torch.arange(L, device=device)[:, None]
    cols = torch.arange(L, device=device)
    keep = torch.empty((B * H, L, L), dtype=torch.bool, device=device)

    # a few pairs at a time: the int64 lanes take 8 bytes an element
    step = max(1, 2**24 // (L * L))
    for p0 in range(0, B * H, step):
        pairs = torch.arange(p0, min(p0 + step, B * H), device=device)[:, None, None]
        keep[p0 : p0 + step] = _keep_mask(rows, cols, pairs, seed, rate)

    return keep.reshape(B, H, L, L)


def _dropout_seed(generator: torch.Generator, device: torch.device) -> Tensor:
    r"""Two int32 seed words drawn from `generator`, as JAX draws
    `jax.random.bits(key, (2,))` and bitcasts them, in a tensor on `device`:
    the kernels read them through a pointer, so no attention call waits for
    the host."""

    words = torch.randint(-(2**31), 2**31, (2,), generator=generator, device=generator.device)
    return words.to(device=device, dtype=torch.int32, non_blocking=True)


def _mask_to_bias(mask: Tensor, q: Tensor) -> tuple[Tensor, str]:
    r"""JAX's `_mask_to_bias`: a boolean mask broadcastable to (B, H, L, L)
    as a (Gm, L, L) additive bias in q's dtype on q's device (0 where kept,
    -1e30 where masked) and its mode, "full", "batch", "head" or "one"."""

    L = q.shape[-2]
    shape = (1,) * (4 - mask.ndim) + tuple(mask.shape)
    Bm, Hm = shape[:2]
    mode = {(True, True): "full", (True, False): "batch", (False, True): "head", (False, False): "one"}[(Bm > 1, Hm > 1)]

    bias = torch.where(mask.to(q.device).reshape(shape), 0.0, _MASKED_OUT).to(q.dtype)

    return bias.reshape(Bm * Hm, L, L), mode


def _bias_extents(mode: str, B: int, H: int) -> tuple[int, int]:
    r"""The batch and head extents (Bm, Hm) of a (Bm Hm, L, L) bias in one of
    the modes of JAX's `_bias_group_fn`."""

    return {"full": (B, H), "batch": (B, 1), "head": (1, H), "one": (1, 1)}[mode]


def _bias_bhll(bias: Tensor, mode: str, B: int, H: int) -> Tensor:
    r"""The (Gm, L, L) bias of `mode` as a tensor that broadcasts to
    (B, H, L, L)."""

    L = bias.shape[-1]

    return bias.reshape(*_bias_extents(mode, B, H), L, L)


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


def _attention_lse_plain(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    scale: float,
    bias: Tensor | None = None,
    mode: str = "one",
    seed: Tensor | None = None,
    rate: float = 0.0,
) -> tuple[Tensor, Tensor]:
    r"""Plain PyTorch version of `_pallas_attention` with `with_lse=True`
    (azula_tpu/ops/attention.py): float32 logits plus the (Gm, L, L) `bias`
    of `mode`, the row max m, the exp-weights p and their sum d; in float32
    the weights are normalized before the value product, below float32 they
    enter it rounded to the input dtype (float32 accumulation) and the
    product is divided by d. With `rate` > 0, `_pallas_attention_blocked`'s
    dropout: the value product takes p / (1 - rate) where
    :func:`dropout_keep_mask` of `seed` keeps and 0 elsewhere, rounded to the
    input dtype, and is divided by the undropped d. Returns o and the float32
    (B, H, L) log-sum-exp :math:`m + \log d` of the undropped softmax."""

    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + _bias_bhll(bias, mode, *q.shape[:2]).float()
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    d = p.sum(dim=-1, keepdim=True)

    if rate > 0:
        keep = dropout_keep_mask(*q.shape[:3], seed, rate).to(q.device)
        o = torch.matmul((torch.where(keep, p, 0.0) / (1 - rate)).to(q.dtype).float(), v.float()) / d
    elif q.dtype == torch.float32:
        o = torch.matmul(p / d, v)
    else:
        o = torch.matmul(p.to(q.dtype).float(), v.float()) / d

    return o.to(q.dtype), (m + torch.log(d)).squeeze(-1)


def _key_tile(D: int) -> int:
    r"""The keys per tile of the bf16 tensor-core forward of
    `csrc/attention_fwd.cu` (`tc::Tiling<D>::BK`): the width of the running
    max against which it rounds the exp-weights."""

    return 128 if D <= 128 else 64


def _attention_tiled_plain(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    scale: float,
    bias: Tensor | None = None,
    mode: str = "one",
    seed: Tensor | None = None,
    rate: float = 0.0,
    max_free: bool = False,
) -> tuple[Tensor, Tensor | None]:
    r"""Plain PyTorch version of the bf16 tensor-core forward of
    `csrc/attention_fwd.cu`, with its rounding points: float32 scores times
    the scale plus the (Gm, L, L) `bias` of `mode`; an online softmax over
    key tiles of :func:`_key_tile` width, whose exp-weights enter the value
    product rounded to the input dtype against the running max, while the
    denominator sums them unrounded and the float32 accumulator is rescaled
    as the max grows; o = acc / l. With `rate` > 0 the value product takes
    p / (1 - rate) where :func:`dropout_keep_mask` of `seed` keeps and 0
    elsewhere; with `max_free` the weights are :math:`\exp(\min(s, 80))`
    with no max. In float32 the rounding is the identity.

    Returns o in float32, not rounded to the input dtype, so that a check
    holds a kernel's output to its own final rounding, and the float32
    (B, H, L) log-sum-exp of the undropped softmax (None with `max_free`)."""

    dtype = q.dtype
    B, H, L, D = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + _bias_bhll(bias, mode, B, H).float()
    vf = v.float()

    if max_free:
        p = torch.exp(torch.clamp(s, max=_MAX_FREE_CLAMP))
        return torch.matmul(p.to(dtype).float(), vf) / p.sum(dim=-1, keepdim=True), None

    keep = dropout_keep_mask(B, H, L, seed, rate).to(q.device) if rate > 0 else None
    m = torch.full((B, H, L, 1), -math.inf, device=q.device)
    l = torch.zeros((B, H, L, 1), device=q.device)
    acc = torch.zeros((B, H, L, D), device=q.device)

    bk = _key_tile(D)
    for k0 in range(0, L, bk):
        x = s[..., k0 : k0 + bk]
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., k0 : k0 + bk], p, 0.0) / (1 - rate)
        acc = acc * alpha + torch.matmul(p.to(dtype).float(), vf[..., k0 : k0 + bk, :])
        m = m_new

    return acc / l, (m + torch.log(l)).squeeze(-1)


def _softmax_grads(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    o: Tensor,
    g: Tensor,
    p: Tensor,
    scale: float,
    dtype: torch.dtype,
    keep: Tensor | None = None,
    rate: float = 0.0,
) -> tuple[Tensor, Tensor, Tensor]:
    r"""dq, dk, dv in float32 from float32 (..., L, D) q, k, v, the stored o,
    the cotangent g and the softmax p, with the rounding points of the JAX
    backward kernels: dp = g v^T, delta = rowsum(g o), ds = p (dp - delta)
    scale rounded to `dtype`, then dq = ds k, dk = ds^T q and dv = p16^T g
    with p rounded to `dtype`, each summed in float32. With a dropout `keep`
    mask (`_p_ds`), dp and the p of dv become M dp / (1 - rate) and
    M p / (1 - rate)."""

    dp = torch.matmul(g, v.transpose(-1, -2))
    delta = torch.sum(g * o, dim=-1, keepdim=True)

    p_tilde = p
    if keep is not None:
        p_tilde = torch.where(keep, p, 0.0) / (1 - rate)
        dp = torch.where(keep, dp, 0.0) / (1 - rate)

    ds = (p * (dp - delta) * scale).to(dtype).float()
    p16 = p_tilde.to(dtype).float()

    return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), torch.matmul(p16.transpose(-1, -2), g)


def _attention_bwd_plain(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    o: Tensor,
    lse: Tensor,
    g: Tensor,
    scale: float,
    bias: Tensor | None = None,
    mode: str = "one",
    seed: Tensor | None = None,
    rate: float = 0.0,
    rounded: bool = True,
) -> tuple[Tensor, Tensor, Tensor]:
    r"""Plain PyTorch version of `_pallas_attention_bwd` and
    `_pallas_attention_batched_bwd` (azula_tpu/ops/attention.py) on
    (B, H, L, D): g cast to the inputs' dtype, p = exp(s - lse) rebuilt in
    float32 from the scaled scores plus the bias and the float32 (B, H, L)
    log-sum-exp, then the rounding points of `_softmax_grads`, with the keep
    mask of `seed` under dropout. Returns dq, dk, dv in the inputs' dtype,
    or with `rounded=False` the float32 sums before that last rounding, so
    that a check can hold a kernel's output to its own final rounding."""

    dtype = q.dtype
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, g.to(dtype)))

    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + _bias_bhll(bias, mode, *q.shape[:2]).float()
    p = torch.exp(s - lse[..., None])
    keep = dropout_keep_mask(*q.shape[:3], seed, rate).to(q.device) if rate > 0 else None
    grads = _softmax_grads(qf, kf, vf, of, gf, p, scale, dtype, keep, rate)

    return tuple(t.to(dtype) for t in grads) if rounded else grads


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

    return B, H, L, D


def _mask_args(q: Tensor, bias: Tensor | None, mode: str, seed: Tensor | None, rate: float) -> tuple:
    r"""Raises unless the bias and seed are what the kernels take; returns the
    mask arguments of their C entries: the bias, its group divisor and
    modulus (pair p = b H + h reads group (p // div) % mod), the seed, the
    signed keep threshold and 1 - rate."""

    B, H, L, _ = q.shape
    Bm, Hm = _bias_extents(mode, B, H)
    groups, div, mod = Bm * Hm, H if Hm == 1 else 1, Bm * Hm

    if bias is not None:
        if bias.shape != (groups, L, L) or bias.dtype != q.dtype or bias.device != q.device or not bias.is_contiguous():
            raise ValueError(f"the '{mode}' bias must be a contiguous {(groups, L, L)} tensor of q's dtype and device")
    if rate <= 0:
        return (None if bias is None else bias.data_ptr()), div, mod, None, 0, 1.0
    if seed is None or seed.shape != (2,) or seed.dtype != torch.int32 or seed.device != q.device:
        raise ValueError(f"dropout takes two int32 seed words on {q.device}")

    return (None if bias is None else bias.data_ptr()), div, mod, seed.data_ptr(), _dropout_threshold(rate), 1 - rate


def _form(bias: Tensor | None, rate: float) -> str:
    r"""The suffix of a kernel form's launch count: "", "_bias", "_dropout"
    or "_bias_dropout"."""

    return ("_bias" if bias is not None else "") + ("_dropout" if rate > 0 else "")


def _launch_attention(
    name: str,
    q: Tensor,
    k: Tensor,
    v: Tensor,
    scale: float,
    bias: Tensor | None = None,
    mode: str = "one",
    seed: Tensor | None = None,
    rate: float = 0.0,
) -> Tensor:
    r"""Launches the inference entry `azula_<name>` of `csrc/attention_fwd.cu`
    on CUDA tensors (B, H, L, D); the exact entry takes a bias and dropout.
    In bf16 the weights enter the value product rounded to bf16 against the
    running max of the kernel's key tiles (:func:`_attention_tiled_plain`),
    in float32 unrounded."""

    B, H, L, D = _check_bhld((q, k, v), name)
    o = torch.empty_like(q)

    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B * H, L, D, scale, _DTYPES[q.dtype]]
    args.append(_build.stream(q.device))
    if name == "attention_fwd":
        args.extend(_mask_args(q, bias, mode, seed, rate))

    status = getattr(_build.library(), f"azula_{name}")(*args)
    _build.check(status, name)
    _build.LAUNCHES[name + _form(bias, rate)] += 1

    return o


# the direct wrappers' backward: JAX's training route, and so the port's, is `_flash`
_TRAINING_ROUTE = "under grad, dot_product_attention takes the LSE forward and the attention backward kernels"


@_build.forward_only("attention_fwd", _TRAINING_ROUTE)
def _attention_kernel(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    scale: float,
    bias: Tensor | None = None,
    mode: str = "one",
    seed: Tensor | None = None,
    rate: float = 0.0,
) -> Tensor:
    r"""Launches the exact flash forward of `csrc/attention_fwd.cu`, with the
    (Gm, L, L) `bias` of `mode` and the dropout of `seed` at `rate`: in bf16
    the tensor-core forward, whose weights are rounded to bf16 against the
    running max of its key tiles (:func:`_attention_tiled_plain`); in
    float32 the CUDA-core forward, which keeps them unrounded."""

    return _launch_attention("attention_fwd", q, k, v, scale, bias, mode, seed, rate)


@_build.forward_only("attention_fwd_max_free", _TRAINING_ROUTE)
def _attention_max_free_kernel(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    r"""Launches the max-free flash forward of `csrc/attention_fwd.cu`."""

    return _launch_attention("attention_fwd_max_free", q, k, v, scale)


def _attention_lse_kernel(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    scale: float,
    bias: Tensor | None = None,
    mode: str = "one",
    seed: Tensor | None = None,
    rate: float = 0.0,
) -> tuple[Tensor, Tensor]:
    r"""Launches the LSE entry of `csrc/attention_fwd.cu`, with the
    (Gm, L, L) `bias` of `mode` and the dropout of `seed` at `rate`; returns
    o and the float32 (B, H, L) log-sum-exp."""

    B, H, L, D = _check_bhld((q, k, v), "attention_fwd_lse")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)

    status = _build.library().azula_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B * H, L, D, scale, _DTYPES[q.dtype], _build.stream(q.device),
        *_mask_args(q, bias, mode, seed, rate),
    )
    _build.check(status, "attention_fwd_lse")
    _build.LAUNCHES["attention_fwd_lse" + _form(bias, rate)] += 1

    return o, lse


# the query rows per tile of the bf16 tensor-core backward (`BM` of
# `csrc/attention_bwd_tc.cuh`), to which its per-tile LSE and delta rows are
# padded
_BWD_QUERY_TILE = 64


def _bwd_scratch(B: int, H: int, L: int, D: int, dtype: torch.dtype) -> tuple[int, int]:
    r"""The float32 scratch of `csrc/attention_bwd.cu` and
    `csrc/flash_blhd_bwd.cu`, in elements: each query tile's LSE and delta
    rows (B H, ceil(L / 64), 2, 64), whose first B H L the float32 kernels
    take for delta, and in bf16 the dq accumulator in dq's layout, (B H, L, D)
    or (B, L, H D) (0 in float32)."""

    tiles = -(-L // _BWD_QUERY_TILE)
    return B * H * tiles * 2 * _BWD_QUERY_TILE, B * H * L * D if dtype == torch.bfloat16 else 0


def _attention_bwd_kernel(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    o: Tensor,
    lse: Tensor,
    g: Tensor,
    scale: float,
    bias: Tensor | None = None,
    mode: str = "one",
    seed: Tensor | None = None,
    rate: float = 0.0,
) -> tuple[Tensor, Tensor, Tensor]:
    r"""Launches `csrc/attention_bwd.cu`, counted as one launch, with the
    forward's bias and dropout; returns dq, dk, dv. In bf16 the one-pass
    tensor-core backward: a pre-kernel (delta and the rows' LSE, a zeroed
    float32 dq accumulator), the kernel, whose blocks add their dq tiles to
    the accumulator by atomics (so dq's float32 sums run in an order that
    changes from run to run), and dq's rounding; in float32 the CUDA-core
    FlashAttention-2 pair, dq then dk/dv. Both keep the rounding points of
    :func:`_attention_bwd_plain`."""

    B, H, L, D = _check_bhld((q, k, v, o, g), "attention_bwd")
    if lse.shape != (B, H, L) or lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"the log-sum-exp must be float32 (B, H, L) = {(B, H, L)} on {q.device}")

    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    rows, acc = _bwd_scratch(B, H, L, D, q.dtype)
    delta = torch.empty(rows, dtype=torch.float32, device=q.device)
    dq_acc = torch.empty(acc, dtype=torch.float32, device=q.device) if acc else None

    status = _build.library().azula_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), None if dq_acc is None else dq_acc.data_ptr(),
        B * H, L, D, scale, _DTYPES[q.dtype], _build.stream(q.device),
        *_mask_args(q, bias, mode, seed, rate),
    )
    _build.check(status, "attention_bwd")
    _build.LAUNCHES["attention_bwd" + _form(bias, rate)] += 1

    return dq, dk, dv


class _Flash(torch.autograd.Function):
    r"""JAX's `_flash`, `_flash_biased`, `_flash_dropout` and
    `_flash_dropout_biased` with their custom vjps as a node of the autograd
    graph: the forward saves q, k, v, o, the rows' log-sum-exp, the bias and
    the seed, the backward rebuilds the softmax (and the keep mask) from
    them; the kernels on the card, or the plain versions on the CPU. The
    bias, which comes from a boolean mask, and the seed get no gradient.
    Like the custom vjps, it has no second derivative."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kernel, bias=None, mode="one", seed=None, rate=0.0):
        lse_fn = _attention_lse_kernel if kernel else _attention_lse_plain
        o, lse = lse_fn(q, k, v, scale, bias, mode, seed, rate)
        ctx.save_for_backward(q, k, v, o, lse, bias, seed)
        ctx.scale, ctx.kernel, ctx.mode, ctx.rate = scale, kernel, mode, rate

        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse, bias, seed = ctx.saved_tensors
        g = g.to(q.dtype)  # as `_pallas_attention_bwd` casts the cotangent

        if ctx.kernel:
            bwd_fn, g = _attention_bwd_kernel, g.contiguous()
        else:
            bwd_fn = _attention_bwd_plain
        dq, dk, dv = bwd_fn(q, k, v, o, lse, g, ctx.scale, bias, ctx.mode, seed, ctx.rate)

        return dq, dk, dv, None, None, None, None, None, None


def _flash(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    scale: float,
    implementation: str | None = None,
    bias: Tensor | None = None,
    mode: str = "one",
    seed: Tensor | None = None,
    rate: float = 0.0,
) -> Tensor:
    r"""Differentiable flash attention over :math:`(B, H, L, D)` tensors, for
    self-attention with an optional additive bias and attention dropout.

    Port of `azula_tpu.ops.attention._flash` under `jax.grad`, and of
    `_flash_biased`, `_flash_dropout` and `_flash_dropout_biased`: the
    forward writes the rows' log-sum-exp, and the backward casts the
    cotangent to the inputs' dtype and returns dq, dk, dv. JAX's
    `_flash_fwd` writes the LSE above :math:`L = 512` only and its batched
    backward recomputes the softmax below; here the LSE is written at every
    length, which gives the same function. `max_free` does not apply:
    `_flash_fwd` ignores it. JAX's dropout forward is
    `_pallas_attention_blocked`, whose weights the LSE entry rounds as it
    does.

    Arguments:
        q, k, v: Queries, keys and values, with shape :math:`(B, H, L, D)`.
        scale: The logit scale.
        implementation: :py:`None` or `'auto'` (the kernels for CUDA tensors,
            the plain versions for CPU tensors), `'kernel'` (raises on the
            CPU) or `'plain'`.
        bias: An optional (Gm, L, L) additive bias in q's dtype, from
            `_mask_to_bias`.
        mode: The bias's broadcast mode: `'full'`, `'batch'`, `'head'` or
            `'one'`.
        seed: The two int32 seed words of the dropout, on q's device.
        rate: The dropout rate.

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

    return _Flash.apply(q, k, v, scale, kernel, bias, mode, seed, rate)


def _self_attention(q: Tensor, k: Tensor, v: Tensor) -> bool:
    r"""Whether the attention kernels take (q, k, v) at all: (B, H, L, D)
    self-attention of one shape, dtype and device, in float32 or bfloat16,
    with D one of the kernels' head dims (what JAX's kernels take: D of 64,
    128, 192 or 256, and also 32)."""

    return (
        q.ndim == 4
        and k.shape == v.shape == q.shape
        and q.dtype in _DTYPES
        and k.dtype == v.dtype == q.dtype
        and k.device == v.device == q.device
        and q.shape[-1] in _HEAD_DIMS
    )


def _use_kernels(q: Tensor, k: Tensor, v: Tensor, mask: Tensor | None, floor: int) -> bool:
    r"""JAX's `_use_pallas` without its TPU check, for masked or dropout
    calls: self-attention with :math:`L \geq \max(floor, 128)`,
    :math:`L \bmod 128 = 0`, :math:`D \bmod 64 = 0`, :math:`D \leq 256`,
    and no mask or a boolean one that broadcasts to (B, H, L, L) along B
    and H. Float masks keep the plain route, where they have a gradient."""

    if not _self_attention(q, k, v):
        return False

    B, H, L, D = q.shape

    if not (L >= max(floor, 128) and L % 128 == 0 and D % 64 == 0 and D <= 256):
        return False

    if mask is not None:
        if mask.dtype != torch.bool or mask.ndim > 4:
            return False
        shape = (1,) * (4 - mask.ndim) + tuple(mask.shape)
        if shape[2:] != (L, L) or shape[0] not in (1, B) or shape[1] not in (1, H):
            return False

    return True


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

    The route is chosen from the shapes before any launch, as the JAX
    package chooses between its kernels and XLA. Unmasked, dropout-free
    self-attention of a kernel head dim (32, 64, 128, 192 or 256) in float32
    or bfloat16 takes the kernels at every length. A boolean mask (as an
    additive bias, `_mask_to_bias`) or dropout takes them where JAX's
    `_use_pallas` admits the call: self-attention, :math:`L \bmod 128 = 0`,
    :math:`D \in \{64, 128, 192, 256\}`, :math:`L \geq 512` (128 with
    dropout), a mask that broadcasts along B and H. Everything else (cross
    attention, other head dims or dtypes, float masks, which keep their
    gradient there) takes the plain version, and dropout its Bernoulli
    fallback. A row that a boolean mask masks everywhere gives the mean of
    v on the kernels' route (as on the TPU) and NaN on the plain one (as on
    XLA).

    Arguments:
        q: Queries, with shape :math:`(*, H, L, D)`.
        k: Keys, with shape :math:`(*, H, S, D)`.
        v: Values, with shape :math:`(*, H, S, D)`.
        mask: Optional boolean or additive mask, broadcastable to :math:`(L, S)`.
        dropout_rate: Attention-weight dropout rate.
        generator: The generator of the dropout (the JAX `key`), required
            when `dropout_rate > 0`, on the tensors' device: the kernels'
            hash takes two seed words from it, the Bernoulli fallback its
            mask.
        scale: Logit scale; defaults to :math:`1 / \sqrt{D}`.
        implementation: :py:`None` or `'auto'` (the kernels for CUDA
            tensors, the plain version for CPU tensors, but for dropout at
            the kernels' shapes, where the CPU runs the kernels' plain
            versions, so that one seed drops the same weights on both
            devices), `'kernel'` (raises on the CPU) or `'plain'` (JAX's
            path off the TPU). When autograd records a kernel call (grad
            enabled and any of q, k, v requiring it), the call goes to
            :func:`_flash`, the LSE forward and the backward kernels, as
            JAX's custom vjps run under `jax.grad`; otherwise to the
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

    if dropout_rate > 0 and generator is None:
        raise ValueError("attention dropout requires a `generator`")

    if scale is None:
        scale = 1 / math.sqrt(q.shape[-1])

    masked = mask is not None or dropout_rate > 0
    if masked:
        covered = _use_kernels(q, k, v, mask, floor=128 if dropout_rate > 0 else 512)
    else:
        covered = _self_attention(q, k, v)

    if implementation == "plain" or not covered:
        if dropout_rate > 0:
            return _attention_dropout_plain(q, k, v, mask, dropout_rate, generator, scale)
        return _attention_plain(q, k, v, mask=mask, scale=scale)

    on_card = implementation == "kernel" or q.device.type == "cuda"
    if not on_card and dropout_rate == 0:
        return _attention_plain(q, k, v, mask=mask, scale=scale)

    bias, mode = (None, "one") if mask is None else _mask_to_bias(mask, q)
    seed = _dropout_seed(generator, q.device) if dropout_rate > 0 else None

    if not on_card:
        return _flash(q, k, v, scale, "plain", bias, mode, seed, dropout_rate)

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if masked:
            return _flash(q, k, v, scale, implementation="kernel", bias=bias, mode=mode, seed=seed, rate=dropout_rate)
        return _flash(q, k, v, scale, implementation="kernel")

    if masked:
        return _attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(), scale, bias, mode, seed, dropout_rate)

    kernel = _attention_max_free_kernel if max_free and _max_free_route(q) else _attention_kernel

    return kernel(q.contiguous(), k.contiguous(), v.contiguous(), scale)


def _split_heads(x: Tensor, heads: int) -> Tensor:
    r"""(B, L, H D) -> (B, H, L, D), in x's dtype."""

    return x.unflatten(-1, (heads, -1)).transpose(1, 2)


def _merge_heads(x: Tensor, dtype: torch.dtype) -> Tensor:
    r"""(B, H, L, D) -> (B, L, H D), rounded to `dtype`."""

    return x.to(dtype).transpose(1, 2).flatten(2)


def _flash_blhd_fwd_plain(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float) -> Tensor:
    r"""Plain PyTorch version of `_flash_blhd_fwd_kernel`
    (azula_tpu/ops/attention.py): float32 logits times the scale, the row max,
    exp, the row sum; the exp-weights rounded to the input dtype enter the
    value product with float32 accumulation, and the product is divided by
    the sum, in both dtypes."""

    qh, kh, vh = (_split_heads(t, heads).float() for t in (q, k, v))

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
    qh, kh, vh, oh, gh = (_split_heads(t, heads).float() for t in (q, k, v, o, g))

    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)

    return tuple(_merge_heads(t, dtype) for t in _softmax_grads(qh, kh, vh, oh, gh, p, scale, dtype))


def _flash_blhd_tiled_plain(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float) -> tuple[Tensor, Tensor]:
    r"""The bf16 tensor-core form of `_flash_blhd_fwd_kernel` with its
    rounding points: :func:`_attention_tiled_plain` on the split heads (the
    exp-weights rounded against the running max of the kernel's key tiles).
    Returns o in float32, unrounded, as :math:`(B, L, H D)`, and the float32
    :math:`(B, H, L)` log-sum-exp."""

    o, lse = _attention_tiled_plain(*(_split_heads(t, heads) for t in (q, k, v)), scale)

    return _merge_heads(o, torch.float32), lse


def _flash_blhd_bwd_tiled_plain(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, g: Tensor, lse: Tensor, heads: int, scale: float
) -> tuple[Tensor, Tensor, Tensor]:
    r"""The bf16 tensor-core form of `_flash_blhd_bwd_kernel` with its
    rounding points: :func:`_attention_bwd_plain` on the split heads from the
    forward's :math:`(B, H, L)` log-sum-exp. Returns dq, dk, dv as float32
    sums, before their last rounding, as :math:`(B, L, H D)`."""

    grads = _attention_bwd_plain(*(_split_heads(t, heads) for t in (q, k, v, o)), lse, _split_heads(g, heads), scale,
                                 rounded=False)

    return tuple(_merge_heads(t, torch.float32) for t in grads)


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

    return B, L, heads, D


def _flash_blhd_fwd_kernel(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float) -> tuple[Tensor, Tensor]:
    r"""Launches `csrc/flash_blhd_fwd.cu`; returns o and the float32 (B, H, L)
    row log-sum-exp. In bf16 the tensor-core forward, with the rounding
    points of :func:`_flash_blhd_tiled_plain`, on one block per SM walking
    the query tiles; in float32 the CUDA-core flash step."""

    B, L, H, D = _check_blhd((q, k, v), heads)

    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)

    status = _build.library().azula_flash_blhd_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, L, H, D, scale, _DTYPES[q.dtype], _build.stream(q.device),
    )
    _build.check(status, "flash_blhd_fwd")
    _build.LAUNCHES["flash_blhd_fwd"] += 1

    return o, lse


def _flash_blhd_bwd_kernel(
    q: Tensor, k: Tensor, v: Tensor, o: Tensor, g: Tensor, lse: Tensor, heads: int, scale: float
) -> tuple[Tensor, Tensor, Tensor]:
    r"""Launches `csrc/flash_blhd_bwd.cu`, counted as one launch; returns dq,
    dk, dv. In bf16 the one-pass tensor-core backward of
    `csrc/attention_bwd.cu` on the heads in place (a delta pre-kernel, the
    kernel, whose blocks add their dq tiles to a float32 (B, L, H D)
    accumulator by atomics, and dq's rounding), with the rounding points of
    :func:`_flash_blhd_bwd_tiled_plain`; in float32 the CUDA-core
    FlashAttention-2 pair. The scratch is :func:`_bwd_scratch`'s."""

    B, L, H, D = _check_blhd((q, k, v, o, g), heads)
    if lse.shape != (B, H, L) or lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"the log-sum-exp must be float32 (B, H, L) = {(B, H, L)} on {q.device}")

    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    rows, acc = _bwd_scratch(B, H, L, D, q.dtype)
    delta = torch.empty(rows, dtype=torch.float32, device=q.device)
    dq_acc = torch.empty(acc, dtype=torch.float32, device=q.device) if acc else None

    status = _build.library().azula_flash_blhd_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), None if dq_acc is None else dq_acc.data_ptr(),
        B, L, H, D, scale, _DTYPES[q.dtype], _build.stream(q.device),
    )
    _build.check(status, "flash_blhd_bwd")
    _build.LAUNCHES["flash_blhd_bwd"] += 1

    return dq, dk, dv


class _FlashBLHD(torch.autograd.Function):
    r"""`_flash_blhd` as a node of the autograd graph: the kernels on the
    card, whose forward saves the rows' log-sum-exp for the backward, or the
    plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale, kernel):
        if kernel:
            o, lse = _flash_blhd_fwd_kernel(q, k, v, heads, scale)
            ctx.save_for_backward(q, k, v, o, lse)
        else:
            o = _flash_blhd_fwd_plain(q, k, v, heads, scale)
            ctx.save_for_backward(q, k, v, o)

        ctx.heads, ctx.scale, ctx.kernel = heads, scale, kernel

        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, *lse = ctx.saved_tensors
        g = g.to(q.dtype)  # as `_flash_blhd_bwd` casts the cotangent

        if ctx.kernel:
            dq, dk, dv = _flash_blhd_bwd_kernel(q, k, v, o, g.contiguous(), *lse, ctx.heads, ctx.scale)
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
