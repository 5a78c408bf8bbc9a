r"""Channels-last group normalization, fused with modulation and SiLU, and
the group statistics.

Port of :mod:`azula_tpu.ops.norm` (`group_norm`, `group_norm_silu`,
`_compose_affine`, `group_stats` and its implementations, the analytic
backwards). Every GroupNorm site reduces to

.. math:: y = \mathrm{silu}?((x - \mu) A + Q), \quad A = P / \sqrt{\mathrm{var} + \epsilon}

with per-(batch, channel) :math:`P = \gamma (1 + s)` and
:math:`Q = \beta (1 + s) + t` composed outside the kernel. Statistics are
float32 shifted moments about a pilot row (the first spatial position), which
stay exact when :math:`|\mu| \gg \sigma`; the raw
:math:`E[x^2] - E[x]^2` fold is never formed.

Two versions compute it: the hand-written CUDA kernel
(`csrc/group_norm.cu`) for tensors on the card, and a plain PyTorch version
for tensors on the CPU, at the kernel's rounding points. The kernel and the
statistics kernel are one launch each of thread-block clusters, cut by the
pure Python planner `_gn_plan` (bands of whole groups, or of a group wider
than 512 channels a cluster of its bands; clusters; the rows a block keeps
in shared memory), which the CPU tests hold. The backward is
JAX's `_gn_fused_bwd` in plain PyTorch, with the statistics that the
forward saves from :func:`group_stats`.

:func:`group_stats` gives per-(batch, group) float32 (mean, variance). Its
implementations are JAX's (`twopass`, `pilot`, `guarded`, `raw`, `lazy`),
as plain PyTorch, and the statistics kernel (`csrc/group_stats.cu`, the
port of `_stats_pallas`), whose arithmetic `_stats_kernel_plain` repeats.
`'auto'` is the kernel on the card and `lazy` on the CPU: the JAX package
keeps `lazy` because its raw fold fuses with the producer of `x` under XLA,
which no kernel can; in eager PyTorch every input is already in memory, and
the kernel reads it once, exactly centered. JAX's environment overrides
(`AZULA_GN_STATS`, `AZULA_GN_LAZY_MIN_BYTES`) are not ported. The backward
is JAX's analytic `_stats_bwd`.
"""

from __future__ import annotations

__all__ = [
    "group_norm",
    "group_norm_silu",
    "group_stats",
    "stats_kernel_eligible",
]

import functools
import math
import torch

from torch import Tensor
from torch.autograd.function import once_differentiable
from typing import NamedTuple

from . import _build
from ..utils import profiling

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _compose_affine(
    x: Tensor,
    groups: int,
    scale: Tensor | None,
    bias: Tensor | None,
    mod_scale: Tensor | None,
    mod_shift: Tensor | None,
) -> tuple[Tensor, Tensor, Tensor]:
    r"""Flattens `x` to a contiguous (B, HW, C) and composes the per-(batch,
    channel) float32 affine P, Q (B, C) from the layer parameters and the
    optional modulation (each (B, C)-broadcastable)."""

    B, *_, C = x.shape

    if C % groups:
        raise ValueError(f"channels ({C}) must be divisible by groups ({groups})")

    P = torch.ones(1, C, dtype=torch.float32, device=x.device)
    Q = torch.zeros(1, C, dtype=torch.float32, device=x.device)

    if scale is not None:
        P = P * scale.float()
    if bias is not None:
        Q = Q + bias.float()

    if mod_scale is not None:
        m = (1.0 + mod_scale.float()).reshape(B, C)
        P = P * m
        Q = Q * m
    if mod_shift is not None:
        Q = Q + mod_shift.float().reshape(B, C)

    P = P.expand(B, C).contiguous()
    Q = Q.expand(B, C).contiguous()

    return x.reshape(B, -1, C).contiguous(), P, Q


def _group_norm_plain(
    x: Tensor, P: Tensor, Q: Tensor, groups: int, eps: float, silu: bool, rows: int | None = None
) -> Tensor:
    r"""Plain PyTorch version, with the kernel's rounding points: the
    pilot-shifted sums of `_stats_pilot`, taken per block of `rows` rows
    (the planner's, by default) and added in block order, as a cluster folds
    them; then the fold about each group's first pilot and the elementwise
    pass of `_gn_fused_xla` (azula_tpu/ops/norm.py), in float32 throughout.
    Where a group spans bands, each channel's sums still fold over its
    band's blocks in block order: the split by bands adds no rounding point
    (the group's channels are summed in another order than the kernel's
    block-wide fold, as at any width)."""

    B, HW, C = x.shape
    n = HW * (C // groups)
    if rows is None:
        rows = _gn_plan(B, HW, C, groups, x.element_size()).rows

    xf = x.float()
    shift = xf[:, :1, :]  # (B, 1, C) pilot per channel
    t1 = t2 = 0.0
    for d in torch.split(xf - shift, rows, dim=1):
        t1 = t1 + d.sum(dim=1)
        t2 = t2 + d.square().sum(dim=1)
    t1, t2 = t1.reshape(B, groups, -1), t2.reshape(B, groups, -1)
    K = shift.reshape(B, groups, -1)

    # the fold is taken about each group's first pilot, so that every sum is
    # O(n * std) and the mean is rounded once, at the end
    dK = K - K[..., :1]
    dm = (t1 + HW * dK).sum(dim=-1) / n  # (B, G) mean - first pilot
    mean = K[..., 0] + dm

    # sum (x - mean)^2 = sum d^2 + 2 sum_c e_c t1_c + HW sum_c e_c^2, e_c = K_c - mean
    e = dK - dm[..., None]
    var = (t2.sum(dim=-1) + 2 * (e * t1).sum(dim=-1) + HW * e.square().sum(dim=-1)) / n
    var = var.clamp_min(0.0)

    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(C // groups, dim=-1)[:, None, :]  # (B, 1, C)
    mean_c = mean.repeat_interleave(C // groups, dim=-1)[:, None, :]

    a = inv_c * P[:, None, :]

    # (x - mean) A + Q rather than the JAX package's x A + (Q - mean A): the
    # same function, rounded at the scale of y rather than of x
    y = (xf - mean_c) * a + Q[:, None, :]
    if silu:
        y = y * torch.sigmoid(y)

    return y.to(x.dtype)


# The kernels' launch (csrc/group_stats.cuh): blocks of 512 threads, clusters
# of at most 16 blocks (above 8, the non-portable sizes), bands of at most
# 512 channels; and the planner's aims, from timings on the H100
# (chip_smoke.py's phase 3, which holds the plan against its neighbours)
_THREADS = 512
_WARPS = _THREADS // 32
_MAX_CLUSTER = 16
_MAX_BAND = 512
_MAX_SHARED = 232448  # bytes of shared memory a block can take (227 KB)
_WAVE = 128  # blocks that keep the card's 132 SMs busy
_BAND_BYTES = 128  # the band row: at least whole 128-byte lines of x
_NARROW_BAND_BYTES = 64  # ... or half of one, where that alone fills a wave
_WIDE_BAND_BYTES = 512  # ... or the whole row up to this, where the batch alone fills a wave
_BLOCK_BYTES = 384 * 1024  # a block's share of x
_SPLIT_BYTES = 96 * 1024  # a unit above this takes two blocks, which share an SM
_STAGE_BYTES = 64 * 1024  # the statistics kernel's stage
_MIN_ROWS = 64  # no block of fewer rows, unless the unit has fewer


class _GNPlan(NamedTuple):
    r"""How the GroupNorm and statistics kernels cut x (B, HW, C): bands of
    `band` channels (whole groups), each (batch row, band) a cluster of
    `cluster` blocks of `rows` rows; a GroupNorm block keeps `resident` of
    its rows in shared memory (`smem` bytes in all), and a statistics block
    streams its rows through a stage of `stage` rows. A group wider than
    `band` (C / G = span * band) is one unit of its span bands: its cluster
    of `cluster` blocks holds cluster / span blocks of `rows` rows for each
    band (`_span`)."""

    band: int
    cluster: int
    rows: int
    resident: int
    stage: int
    smem: int


def _vector(band: int, itemsize: int) -> int:
    r"""The kernels' vector: the widest of at most 16 bytes dividing the band."""

    return next(v for v in (16 // itemsize, 4, 2, 1) if band % v == 0)


def _row_threads(band: int, itemsize: int) -> int:
    r"""The rows a block's threads take at once: 512 over the band's
    vectors rounded up to a power of two."""

    return _THREADS // (1 << (math.ceil(band / _vector(band, itemsize)) - 1).bit_length())


def _span(band: int, cpg: int) -> int:
    r"""The bands of one group of `cpg` channels: 1 where a band holds whole
    groups."""

    return cpg // band if cpg > band else 1


def _shared_bytes(band: int, resident: int, itemsize: int, span: int = 1) -> int:
    r"""A GroupNorm block's dynamic shared memory, as `csrc/group_norm.cu`
    computes it: the resident rows, the scratch (the fold's float32 values
    where they outgrow it, more of them where a group spans `span` bands),
    the published sums, the pilot row."""

    def align16(n):
        return -(-n // 16) * 16

    ty = _row_threads(band, itemsize)
    rows = _WARPS if _THREADS // ty < 32 else ty
    floats = 3 * span * band + 5 * band + 3 * _WARPS if span > 1 else 7 * band
    scratch = align16(max(rows * band * 8, floats * 4))
    return align16(resident * band * itemsize) + scratch + align16(band * 8) + align16(band * 4)


def _plan(HW: int, band: int, cluster: int, itemsize: int, span: int = 1) -> _GNPlan:
    r"""The plan of bands of `band` channels on clusters of up to `cluster`
    blocks a band (`span` bands a cluster where a group spans them), each
    block keeping as many of its rows as its shared memory holds."""

    row_bytes = band * itemsize
    rows = math.ceil(HW / cluster)
    cluster = math.ceil(HW / rows)
    ty = _row_threads(band, itemsize)
    room = (_MAX_SHARED - _shared_bytes(band, 0, itemsize, span)) // 16 * 16
    resident = min(rows, max(2 * ty, room // row_bytes))
    stage = min(rows, max(2 * ty, _STAGE_BYTES // row_bytes))
    return _GNPlan(band, span * cluster, rows, resident, stage, _shared_bytes(band, resident, itemsize, span))


@functools.lru_cache(maxsize=None)
def _gn_plan(B: int, HW: int, C: int, G: int, itemsize: int, stats: bool = False) -> _GNPlan:
    r"""The GroupNorm kernel's plan for x (B, HW, C) of `itemsize` bytes an
    element and `G` groups, or with `stats` the statistics kernel's.

    The band is the narrowest run of whole groups (at most 512 channels)
    whose row takes at least `_BAND_BYTES`, or the widest up to
    `_WIDE_BAND_BYTES` where the batch alone gives a wave of units; where
    such a band leaves the card short of a wave of blocks, the narrowest
    of at least `_NARROW_BAND_BYTES` that gives one. A unit (HW rows of a
    band) takes a cluster of one block per `_BLOCK_BYTES`, or two where it
    holds more than `_SPLIT_BYTES` (GroupNorm's only: the statistics
    kernel keeps no rows, and split it runs slower) or the units alone
    fill less than a wave, rounded up to a power of two, at most 16, and
    no block under `_MIN_ROWS` rows. A GroupNorm block keeps as many of its
    rows as its shared memory holds; the rest are read again after the
    fold, from L2 where they stayed.

    A group wider than 512 channels takes bands of the widest divisor of
    its channels up to 512, `span` of them a group, and its unit (HW rows
    of the group) a cluster of span times the blocks a band would take, at
    most 16 in all. The kernels refuse a plan whose cluster holds more than
    16 blocks: a group of more than 16 bands (at most 8192 channels, fewer
    where no divisor lies near 512), which no model of the zoo has."""

    def cluster_of(band):
        unit, units = HW * band * itemsize, B * (C // band)
        n = max(math.ceil(unit / _BLOCK_BYTES), 2 if (unit > _SPLIT_BYTES and not stats) or units < _WAVE else 1)
        return max(1, min(1 << (n - 1).bit_length(), _MAX_CLUSTER, HW // _MIN_ROWS))

    def blocks(band):
        return B * (C // band) * cluster_of(band)

    cpg = C // G
    if cpg > _MAX_BAND:
        band = max(d for d in range(1, _MAX_BAND + 1) if cpg % d == 0)
        span = cpg // band
        return _plan(HW, band, max(1, min(cluster_of(band), _MAX_CLUSTER // span)), itemsize, span)

    bands = [g * cpg for g in range(1, G + 1) if G % g == 0 and g * cpg <= _MAX_BAND]
    if B >= _WAVE:
        band = max((b for b in bands if b * itemsize <= _WIDE_BAND_BYTES), default=bands[0])
    else:
        band = min((b for b in bands if b * itemsize >= _BAND_BYTES), default=bands[-1])
        if blocks(band) < _WAVE:
            band = min((b for b in bands if b * itemsize >= _NARROW_BAND_BYTES and blocks(b) >= _WAVE), default=band)

    return _plan(HW, band, cluster_of(band), itemsize)


def _check_groups(B: int, HW: int, C: int, groups: int, itemsize: int) -> None:
    r"""Raises unless the kernels take `groups` groups of x (B, HW, C):
    a group wider than 512 channels must fit a cluster (`_gn_plan`)."""

    if C % groups:
        raise ValueError(f"channels ({C}) must be divisible by groups ({groups})")
    plan = _gn_plan(B, HW, C, groups, itemsize)
    if plan.cluster > _MAX_CLUSTER:
        raise ValueError(
            f"unsupported channels per group: C={C}, groups={groups} takes {plan.cluster} blocks a cluster "
            f"(bands of {plan.band}); the kernels take groups of at most {_MAX_CLUSTER} bands"
        )


@_build.forward_only("group_norm", "under grad, call group_norm or group_norm_silu: their backward is the analytic one")
def _group_norm_kernel(
    x: Tensor, P: Tensor, Q: Tensor, groups: int, eps: float, silu: bool, plan: _GNPlan | None = None
) -> Tensor:
    r"""Launches `csrc/group_norm.cu` on a CUDA tensor (B, HW, C), with the
    planner's plan. No caller on the model path gives `plan`: it is the hook
    through which `chip_smoke.py`'s phase 3 times other plans (designs (a)
    and (b) at HW = 65536, the planner's neighbours) against the planner's."""

    if x.device.type != "cuda":
        raise ValueError(f"the group-norm kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the group-norm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("the group-norm kernel takes a contiguous (B, HW, C) tensor")

    B, HW, C = x.shape

    _check_groups(B, HW, C, groups, x.element_size())
    for name, t in (("P", P), ("Q", Q)):
        if t.shape != (B, C) or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 (B, C) tensor on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("the group-norm kernel needs a 16-byte aligned input")

    plan = plan or _gn_plan(B, HW, C, groups, x.element_size())
    y = torch.empty_like(x)

    status = _build.library().azula_group_norm(
        x.data_ptr(), P.data_ptr(), Q.data_ptr(), y.data_ptr(),
        B, HW, C, groups, plan.band, plan.cluster, plan.rows, plan.resident,
        eps, int(silu), _DTYPES[x.dtype], _build.stream(x.device),
    )
    _build.check(status, "group_norm")
    _build.launched("group_norm_silu" if silu else "group_norm", y)

    return y


# --- group statistics --------------------------------------------------------


def _stats_twopass(x: Tensor, groups: int) -> tuple[Tensor, Tensor]:
    r"""Mean, then the centered sum of squares: exact at any magnitude, two
    reads of the input."""

    B, HW, C = x.shape
    n = HW * (C // groups)

    xf = x.float()
    mean = xf.sum(dim=1).reshape(B, groups, -1).sum(dim=-1) / n  # (B, G)

    mc = mean.repeat_interleave(C // groups, dim=-1)[:, None, :]
    d2 = (xf - mc).square().sum(dim=1)
    var = (d2.reshape(B, groups, -1).sum(dim=-1) / n).clamp_min(0.0)

    return mean, var


def _stats_pilot(x: Tensor, groups: int) -> tuple[Tensor, Tensor]:
    r"""One pass of shifted moments about the first spatial row (the pilot),
    each term of the recombination O(n var): exact at any magnitude."""

    B, HW, C = x.shape
    n = HW * (C // groups)

    xf = x.float()
    shift = xf[:, :1, :]
    d = xf - shift
    t1 = d.sum(dim=1).reshape(B, groups, -1)
    t2 = d.square().sum(dim=1).reshape(B, groups, -1)
    Kg = shift.reshape(B, groups, -1)

    mean = (t1 + HW * Kg).sum(dim=-1) / n

    # sum (x - mean)^2 = sum d^2 + 2 sum_c e_c t1_c + HW sum_c e_c^2, e_c = K_c - mean
    e = Kg - mean[..., None]
    var = (t2.sum(dim=-1) + 2 * (e * t1).sum(dim=-1) + HW * e.square().sum(dim=-1)) / n

    return mean, var.clamp_min(0.0)


def _stats_guarded(x: Tensor, groups: int, stride: int = 16) -> tuple[Tensor, Tensor]:
    r"""The raw fold, with the variance replaced by shifted moments of a
    `stride`-subsampled view where it falls below its float32 noise floor."""

    B, HW, C = x.shape
    n = HW * (C // groups)

    xf = x.float()
    g1 = xf.sum(dim=1).reshape(B, groups, -1).sum(dim=-1)
    g2 = xf.square().sum(dim=1).reshape(B, groups, -1).sum(dim=-1)
    mean = g1 / n
    var_raw = g2 / n - mean.square()

    xs = xf[:, ::stride, :]
    m_rows = xs.shape[1]
    m = m_rows * (C // groups)
    shift = xs[:, :1, :]
    d = xs - shift
    t1 = d.sum(dim=1).reshape(B, groups, -1)
    t2 = d.square().sum(dim=1).reshape(B, groups, -1)
    Kg = shift.reshape(B, groups, -1)
    mean_sub = (t1 + m_rows * Kg).sum(dim=-1) / m
    e = Kg - mean_sub[..., None]
    var_sub = (t2.sum(dim=-1) + 2 * (e * t1).sum(dim=-1) + m_rows * e.square().sum(dim=-1)) / m

    floor = 1e-5 * mean.square()
    var = torch.where(var_raw > floor, var_raw, var_sub.clamp_min(0.0))

    return mean, var.clamp_min(0.0)


def _stats_raw(x: Tensor, groups: int) -> tuple[Tensor, Tensor]:
    r"""One pass of raw moments: E[x^2] - E[x]^2, cancellation-prone."""

    B, HW, C = x.shape
    n = HW * (C // groups)

    xf = x.float()
    mean = xf.sum(dim=1).reshape(B, groups, -1).sum(dim=-1) / n
    g2 = xf.square().sum(dim=1).reshape(B, groups, -1).sum(dim=-1)

    return mean, (g2 / n - mean.square()).clamp_min(0.0)


# the lazy fold keeps the raw variance only where every group has
# var > _RESCUE_FLOOR * mean^2 (|mean| / std < ~32), and takes the pilot pass
# below _LAZY_MIN_BYTES of input, as the JAX package's defaults
_RESCUE_FLOOR = 1e-3
_LAZY_MIN_BYTES = 1 << 24


def _stats_lazy(x: Tensor, groups: int) -> tuple[Tensor, Tensor]:
    r"""The raw fold with an exact rescue (JAX's `_stats_lazy`).

    JAX branches with `lax.cond`; here both branches run and a select keeps
    one, as JAX's `cond` does under `vmap`: the same values, at two-pass
    cost, and no sync with the host on the card.
    """

    if x.numel() * x.element_size() < _LAZY_MIN_BYTES:
        return _stats_pilot(x, groups)

    mean, var_raw = _stats_raw(x, groups)

    B, HW, C = x.shape
    n = HW * (C // groups)

    mc = mean.repeat_interleave(C // groups, dim=-1)[:, None, :]
    d2 = (x.float() - mc).square().sum(dim=1)
    rescue = (d2.reshape(B, groups, -1).sum(dim=-1) / n).clamp_min(0.0)

    ok = (var_raw > _RESCUE_FLOOR * mean.square()).all()

    return mean, torch.where(ok, var_raw, rescue)


def _stats_block(HW: int, C: int) -> int | None:
    r"""The spatial tile of JAX's TPU statistics kernel: `HW` when the whole
    row fits its VMEM cap, else the largest multiple-of-8 divisor of `HW`
    under the cap, or `None` when there is none."""

    cap = max(128, (1 << 19) // C)
    if HW <= cap:
        return HW

    for s in range(cap - cap % 8, 7, -8):
        if HW % s == 0:
            return s

    return None


def stats_kernel_eligible(shape: tuple[int, ...]) -> bool:
    r"""Whether JAX's TPU statistics kernel (`_stats_pallas`) covers a
    `(B, HW, C)` shape: JAX takes its two-pass XLA fold elsewhere.

    The card's kernel has neither the TPU's lane rule (`C % 128 == 0`) nor
    its tiling rule: it covers every shape whose groups fit a cluster
    (`_check_groups`).
    """

    _, HW, C = shape
    S_BLK = _stats_block(HW, C)

    return C % 128 == 0 and S_BLK is not None and (S_BLK == HW or (S_BLK % 8 == 0 and HW % S_BLK == 0))


def _stats_kernel_plain(x: Tensor, groups: int, rows: int) -> tuple[Tensor, Tensor]:
    r"""Plain PyTorch version of the statistics kernel, with its arithmetic:
    x shifted by the pilot row K (`x[:, 0]`); per block of `rows` rows and
    per channel, the mean and the centered sum of squares of x - K; the
    blocks combined by Chan's formula in block order, as a cluster folds
    them (the last block may be short), then the channels about the group's
    first pilot (where a group spans bands, its channels fold over their
    own band's blocks just so)."""

    B, HW, C = x.shape
    cpg = C // groups

    xf = x.float()
    K = xf[:, :1, :]

    n = m = M2 = None
    for t in torch.split(xf - K, rows, dim=1):
        nb, mb = float(t.shape[1]), t.mean(dim=1)
        M2b = (t - mb[:, None]).square().sum(dim=1)
        if n is None:
            n, m, M2 = nb, mb, M2b
            continue
        total = n + nb
        delta = mb - m
        w = nb / total
        m = m + delta * w
        M2 = M2 + M2b + delta * delta * n * w
        n = total

    Kg = K[:, 0].reshape(B, groups, cpg)
    e = (Kg - Kg[..., :1]) + m.reshape(B, groups, cpg)  # channel mean - the group's first pilot
    dm = e.mean(dim=-1)
    mean = Kg[..., 0] + dm
    var = (M2.reshape(B, groups, cpg).sum(dim=-1) + HW * (e - dm[..., None]).square().sum(dim=-1)) / (HW * cpg)

    return mean, var.clamp_min(0.0)


@_build.forward_only("group_stats", "under grad, call group_stats: its backward is the analytic one")
def _stats_kernel(x: Tensor, groups: int) -> tuple[Tensor, Tensor]:
    r"""Launches `csrc/group_stats.cu` on a CUDA tensor (B, HW, C), with the
    planner's plan."""

    if x.device.type != "cuda":
        raise ValueError(f"the group-statistics kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the group-statistics kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("the group-statistics kernel takes a contiguous (B, HW, C) tensor")

    B, HW, C = x.shape

    _check_groups(B, HW, C, groups, x.element_size())
    if x.data_ptr() % 16:
        raise ValueError("the group-statistics kernel needs a 16-byte aligned input")

    plan = _gn_plan(B, HW, C, groups, x.element_size(), stats=True)
    out = torch.empty(2, B, groups, dtype=torch.float32, device=x.device)

    status = _build.library().azula_group_stats(
        x.data_ptr(), out.data_ptr(), B, HW, C, groups, plan.band, plan.cluster, plan.rows, plan.stage,
        _DTYPES[x.dtype], _build.stream(x.device),
    )
    _build.check(status, "group_stats")
    _build.launched("group_stats", out)

    return out[0], out[1]


_STATS = {
    "lazy": _stats_lazy,
    "pilot": _stats_pilot,
    "raw": _stats_raw,
    "guarded": _stats_guarded,
    "twopass": _stats_twopass,
    "kernel": _stats_kernel,
    "plain": lambda x, groups: _stats_kernel_plain(x, groups, _gn_plan(*x.shape, groups, x.element_size(), True).rows),
}


def _stats_impl(x: Tensor, groups: int, implementation: str | None) -> tuple[Tensor, Tensor]:
    if implementation in (None, "auto"):
        implementation = "kernel" if x.device.type == "cuda" else "lazy"

    if implementation not in _STATS:
        raise ValueError(f"unknown group_stats implementation '{implementation}'")

    return _STATS[implementation](x, groups)


class _GroupStats(torch.autograd.Function):
    r"""`group_stats` with JAX's analytic vjp (`_stats_bwd`):
    d mean / dx = 1 / n and d var / dx = 2 (x - mean) / n within each group."""

    @staticmethod
    def forward(ctx, x, groups, implementation):
        mean, var = _stats_impl(x, groups, implementation)
        ctx.groups = groups
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, g_mean, g_var):
        x, mean = ctx.saved_tensors
        B, HW, C = x.shape
        cpg = C // ctx.groups
        n = HW * cpg

        a = (g_mean / n).repeat_interleave(cpg, dim=-1)[:, None, :]
        b = (2.0 * g_var / n).repeat_interleave(cpg, dim=-1)[:, None, :]
        mc = mean.repeat_interleave(cpg, dim=-1)[:, None, :]

        return (a + b * (x.float() - mc)).to(x.dtype), None, None


def group_stats(x: Tensor, groups: int, implementation: str | None = None) -> tuple[Tensor, Tensor]:
    r"""Per-(batch, group) float32 (mean, variance) of a channels-last tensor.

    Arguments:
        x: The input, with shape :math:`(B, HW, C)`.
        groups: The number of groups :math:`G` (must divide :math:`C`).
        implementation: :py:`None` or `'auto'` (the kernel for a CUDA tensor,
            `'lazy'` for a CPU tensor), `'kernel'` (raises on the CPU),
            `'plain'` (the kernel's arithmetic in PyTorch), or one of the
            JAX package's `'lazy'`, `'raw'`, `'pilot'`, `'guarded'` and
            `'twopass'`.

    Returns:
        Tensors `(mean, var)`, each with shape :math:`(B, G)`.
    """

    if x.shape[-1] % groups:
        raise ValueError(f"channels ({x.shape[-1]}) must be divisible by groups ({groups})")

    with profiling.annotate("azula.ops.group_stats"):
        return _GroupStats.apply(x, groups, implementation)


def _gn_forward(
    x: Tensor, P: Tensor, Q: Tensor, groups: int, eps: float, silu: bool, implementation: str | None
) -> Tensor:
    if implementation in (None, "auto"):
        implementation = "kernel" if x.device.type == "cuda" else "plain"

    if implementation == "kernel":
        return _group_norm_kernel(x, P, Q, groups, eps, silu)
    if implementation == "plain":
        return _group_norm_plain(x, P, Q, groups, eps, silu)

    raise ValueError(f"unknown group-norm implementation '{implementation}'")


class _GroupNorm(torch.autograd.Function):
    r"""The fused GroupNorm with JAX's custom vjp (`_gn_fused_fwd`,
    `_gn_fused_bwd`): the forward saves `group_stats(x, groups)` (on the card,
    the statistics kernel), and the backward is the standard GroupNorm
    gradient through y = silu?(P u + Q), u = (x - mean) / sqrt(var + eps),
    in float32 PyTorch, as JAX computes it in XLA."""

    @staticmethod
    def forward(ctx, x, P, Q, groups, eps, silu, implementation):
        y = _gn_forward(x, P, Q, groups, eps, silu, implementation)
        mean, var = _stats_impl(x, groups, None)
        ctx.groups, ctx.eps, ctx.silu = groups, eps, silu
        ctx.save_for_backward(x, P, Q, mean, var)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, P, Q, mean, var = ctx.saved_tensors
        B, HW, C = x.shape
        cpg = C // ctx.groups
        n = HW * cpg

        inv_c = torch.rsqrt(var + ctx.eps).repeat_interleave(cpg, dim=-1)[:, None, :]  # (B, 1, C)
        mean_c = mean.repeat_interleave(cpg, dim=-1)[:, None, :]
        P, Q = P[:, None, :], Q[:, None, :]

        u = (x.float() - mean_c) * inv_c  # normalized activations
        g = g.float()

        if ctx.silu:
            yv = P * u + Q
            sig = torch.sigmoid(yv)
            g = g * sig * (1.0 + yv * (1.0 - sig))

        g_P = (g * u).sum(dim=1)
        g_Q = g.sum(dim=1)

        gu = g * P

        def gmean(v):  # mean over each (batch, group), per channel
            s = v.sum(dim=1).reshape(B, ctx.groups, cpg).sum(dim=-1) / n
            return s.repeat_interleave(cpg, dim=-1)[:, None, :]

        g_x = inv_c * (gu - gmean(gu) - u * gmean(gu * u))

        return g_x.to(x.dtype), g_P, g_Q, None, None, None, None


def _gn_fused(
    x: Tensor,
    P: Tensor,
    Q: Tensor,
    groups: int,
    eps: float,
    silu: bool,
    implementation: str | None,
) -> Tensor:
    # the autograd function only where autograd records the call: its
    # forward also takes the statistics for the backward
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, P, Q)):
        return _GroupNorm.apply(x, P, Q, groups, eps, silu, implementation)

    return _gn_forward(x, P, Q, groups, eps, silu, implementation)


def _gn_work(x: Tensor, *params: Tensor | None) -> tuple[tuple[int, ...], int, int]:
    r"""A GroupNorm call's nominal work: shape :math:`(B, HW, C)`, no FLOPs
    counted (it is bound by its bytes), x read once, the output written once,
    and the affine and modulation parameters that it is given read once."""

    B, C = x.shape[0], x.shape[-1]
    nbytes = 2 * x.numel() * x.element_size() + sum(p.numel() * p.element_size() for p in params if p is not None)

    return (B, x.numel() // (B * C), C), 0, nbytes


def group_norm(
    x: Tensor,
    groups: int,
    eps: float = 1e-5,
    scale: Tensor | None = None,
    bias: Tensor | None = None,
    mod_scale: Tensor | None = None,
    mod_shift: Tensor | None = None,
    implementation: str | None = None,
) -> Tensor:
    r"""Channels-last group normalization with float32 statistics.

    Arguments:
        x: The input, with shape :math:`(B, *, C)` (channels last).
        groups: The number of groups :math:`G` (must divide :math:`C`).
        eps: A numerical stability term.
        scale: Optional per-channel scale :math:`\gamma`, with shape :math:`(C,)`.
        bias: Optional per-channel bias :math:`\beta`, with shape :math:`(C,)`.
        mod_scale: Optional per-batch modulation :math:`s`: the output becomes
            :math:`\mathrm{gn}(x)(1+s)+t`. Shape broadcastable to :math:`(B, C)`.
        mod_shift: Optional per-batch modulation shift :math:`t`.
        implementation: :py:`None` or `'auto'` (the kernel for a CUDA tensor,
            the plain version for a CPU tensor), `'kernel'` (raises on the
            CPU) or `'plain'`.

    Returns:
        The normalized tensor, with shape :math:`(B, *, C)` and the dtype of `x`.
    """

    with profiling.annotate("azula.ops.group_norm", _gn_work, x, scale, bias, mod_scale, mod_shift):
        xf, P, Q = _compose_affine(x, groups, scale, bias, mod_scale, mod_shift)

        return _gn_fused(xf, P, Q, groups, eps, False, implementation).reshape(x.shape)


def group_norm_silu(
    x: Tensor,
    groups: int,
    eps: float = 1e-5,
    scale: Tensor | None = None,
    bias: Tensor | None = None,
    mod_scale: Tensor | None = None,
    mod_shift: Tensor | None = None,
    implementation: str | None = None,
) -> Tensor:
    r"""Fused GroupNorm (+ optional modulation) + SiLU, in one elementwise
    pass after the statistics. Arguments as :func:`group_norm`."""

    with profiling.annotate("azula.ops.group_norm", _gn_work, x, scale, bias, mod_scale, mod_shift):
        xf, P, Q = _compose_affine(x, groups, scale, bias, mod_scale, mod_shift)

        return _gn_fused(xf, P, Q, groups, eps, True, implementation).reshape(x.shape)
