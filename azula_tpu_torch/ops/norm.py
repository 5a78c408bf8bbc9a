r"""Channels-last group normalization, fused with modulation and SiLU.

Port of :mod:`azula_tpu.ops.norm` (`group_norm`, `group_norm_silu`,
`_compose_affine`). Every GroupNorm site reduces to

.. math:: y = \mathrm{silu}?((x - \mu) A + Q), \quad A = P / \sqrt{\mathrm{var} + \epsilon}

with per-(batch, channel) :math:`P = \gamma (1 + s)` and
:math:`Q = \beta (1 + s) + t` composed outside the kernel. Statistics are
float32 shifted moments about a pilot row (the first spatial position), which
stay exact when :math:`|\mu| \gg \sigma`; the raw
:math:`E[x^2] - E[x]^2` fold is never formed.

Two versions compute it: the hand-written CUDA kernel
(`csrc/group_norm.cu`) for tensors on the card, and a plain PyTorch version
for tensors on the CPU.
"""

from __future__ import annotations

__all__ = [
    "group_norm",
    "group_norm_silu",
]

import math
import torch

from torch import Tensor

from . import _build

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
    x: Tensor, P: Tensor, Q: Tensor, groups: int, eps: float, silu: bool
) -> Tensor:
    r"""Plain PyTorch version: the pilot-shifted statistics of `_stats_pilot`
    and the elementwise pass of `_gn_fused_xla` (azula_tpu/ops/norm.py), in
    float32 throughout."""

    B, HW, C = x.shape
    n = HW * (C // groups)

    xf = x.float()
    shift = xf[:, :1, :]  # (B, 1, C) pilot per channel
    d = xf - shift
    t1 = d.sum(dim=1).reshape(B, groups, -1)
    t2 = d.square().sum(dim=1).reshape(B, groups, -1)
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


def _rows_per_block(B: int, HW: int, C: int, itemsize: int) -> int:
    r"""Rows of x summed by one block of the statistics launch: at least
    32 KiB of x (and a whole pass of the block's row threads), with about
    eight blocks per SM of the card over the batch."""

    vec = 16 // itemsize
    while C % vec:
        vec //= 2
    threads_per_row = min(C // vec, 256)
    min_rows = max(256 // threads_per_row, math.ceil(32768 / (C * itemsize)))
    nblk = max(1, min(math.ceil(HW / min_rows), math.ceil(1056 / B)))

    return math.ceil(HW / nblk)


@_build.forward_only("group_norm", "the GroupNorm backward, ROADMAP A16")
def _group_norm_kernel(
    x: Tensor, P: Tensor, Q: Tensor, groups: int, eps: float, silu: bool
) -> Tensor:
    r"""Launches `csrc/group_norm.cu` on a CUDA tensor (B, HW, C)."""

    if x.device.type != "cuda":
        raise ValueError(f"the group-norm kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the group-norm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("the group-norm kernel takes a contiguous (B, HW, C) tensor")

    B, HW, C = x.shape

    if C % groups or C // groups > 256:
        raise ValueError(f"unsupported channels per group: C={C}, groups={groups}")
    for name, t in (("P", P), ("Q", Q)):
        if t.shape != (B, C) or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 (B, C) tensor on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("the group-norm kernel needs a 16-byte aligned input")

    rows = _rows_per_block(B, HW, C, x.element_size())
    nblk = math.ceil(HW / rows)

    y = torch.empty_like(x)
    partial = torch.empty(B, nblk, 2, C, dtype=torch.float32, device=x.device)
    ab = torch.empty(B, 2, C, dtype=torch.float32, device=x.device)

    status = _build.library().azula_group_norm(
        x.data_ptr(), P.data_ptr(), Q.data_ptr(), y.data_ptr(),
        partial.data_ptr(), ab.data_ptr(),
        B, HW, C, groups, rows, eps, int(silu), _DTYPES[x.dtype],
        _build.stream(x.device),
    )
    _build.check(status, "group_norm")
    _build.LAUNCHES["group_norm_silu" if silu else "group_norm"] += 1

    return y


def _gn_fused(
    x: Tensor,
    P: Tensor,
    Q: Tensor,
    groups: int,
    eps: float,
    silu: bool,
    implementation: str | None,
) -> Tensor:
    if implementation in (None, "auto"):
        implementation = "kernel" if x.device.type == "cuda" else "plain"

    if implementation == "kernel":
        return _group_norm_kernel(x, P, Q, groups, eps, silu)
    if implementation == "plain":
        return _group_norm_plain(x, P, Q, groups, eps, silu)

    raise ValueError(f"unknown group-norm implementation '{implementation}'")


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

    xf, P, Q = _compose_affine(x, groups, scale, bias, mod_scale, mod_shift)

    return _gn_fused(xf, P, Q, groups, eps, True, implementation).reshape(x.shape)
