r"""Ring attention: sequence-parallel attention over the ranks of a mesh dim.

Port of :mod:`azula_tpu.parallel.ring`. Queries, keys and values are split
along the sequence over the ranks; each rank keeps its query block and passes
the K/V blocks around the ring (`batch_isend_irecv`). Memory per rank is
:math:`O(L_\mathrm{local})`.

One ring step (:func:`ring_step`) takes one K/V block into the running
:math:`(o, \mathrm{lse})`: one launch of the attention forward's LSE entry
(`csrc/attention_fwd.cu`, the plain `_attention_lse_plain` off the card)
over the block, merged by log-sum-exp. JAX's online softmax
(`ring.py:80-114`) computes the same function and rounds elsewhere: it
carries an unnormalized float32 accumulator and a running max, where this
merges normalized block outputs in the inputs' dtype.

The backward is a `torch.autograd.Function` (torch has no autograd through
point-to-point sends, where JAX differentiates through `ppermute`): for each
block, one launch of the attention backward (`csrc/attention_bwd.cu`,
`_attention_bwd_plain` off the card) with the merged output and log-sum-exp,
which rebuild each block's softmax weights exactly; dq is summed on the
rank, and dk and dv travel on around the ring behind their block and arrive
summed at the rank that owns it. Each step of either pass receives the next
block while the held one is computed; the backward passes the float32 dk,
dv beside each block, 3x the forward's bytes in bf16 and 2x in float32.

:func:`ring_forward` and :func:`ring_backward` are one rank's loops over
the ring, and take the exchange as an argument: :func:`ring_attention_local`
gives them point-to-point sends over a process group, :class:`LoneRank`
drives one rank in one process.

Composition, as in JAX:

- **Masks**: a head-broadcast boolean mask over the global sequence
  (:math:`(L, L)` or :math:`(*, 1, L, L)`, the same on every rank) is cut to
  the local rows, and at each step to the columns of the block held; a
  per-head mask raises.
- **Dropout**: refused, by `MultiheadSelfAttention` as in JAX; Ulysses
  attention (:mod:`azula_tpu_torch.parallel.ulysses`) takes it.

References:
    | Ring Attention with Blockwise Transformers for Near-Infinite Context (Liu et al., 2023)
    | https://arxiv.org/abs/2310.01889
"""

from __future__ import annotations

__all__ = [
    "LoneRank",
    "ring_attention",
    "ring_attention_local",
    "ring_backward",
    "ring_forward",
    "ring_step",
    "ring_step_backward",
]

import math
import torch
import torch.distributed as dist

from collections.abc import Callable
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh

from ..ops.attention import (
    _MASKED_OUT,
    _attention_bwd_kernel,
    _attention_bwd_plain,
    _attention_lse_kernel,
    _attention_lse_plain,
)
from .mesh import axis_group


def ring_step(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    o: Tensor | None,
    lse: Tensor | None,
    scale: float,
    bias: Tensor | None = None,
    mode: str = "one",
) -> tuple[Tensor, Tensor]:
    r"""Takes one K/V block into the running output and log-sum-exp.

    Arguments:
        q: The local queries, with shape :math:`(B, H, L_b, D)`.
        k, v: One block of keys and values, of q's shape.
        o: The running float32 output, normalized over the blocks taken, or
            :py:`None` before the first block.
        lse: The running float32 (B, H, L_b) log-sum-exp, or :py:`None`.
        scale: The logit scale.
        bias: An optional (Gm, L_b, L_b) additive bias of the block, in q's
            dtype (0 where kept, -1e30 where masked).
        mode: The bias's broadcast mode, `'batch'` or `'one'`.

    Returns:
        The new (o, lse). On the card the block's attention is one launch of
        the LSE forward kernel; on the CPU its plain version.
    """

    if q.device.type == "cuda":
        o_blk, lse_blk = _attention_lse_kernel(q, k, v, scale, bias, mode)
    else:
        o_blk, lse_blk = _attention_lse_plain(q, k, v, scale, bias, mode)

    if o is None:
        return o_blk.float(), lse_blk

    new = torch.logaddexp(lse, lse_blk)
    o = o * torch.exp(lse - new)[..., None] + o_blk.float() * torch.exp(lse_blk - new)[..., None]

    return o, new


def ring_step_backward(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    o: Tensor,
    lse: Tensor,
    g: Tensor,
    scale: float,
    bias: Tensor | None = None,
    mode: str = "one",
) -> tuple[Tensor, Tensor, Tensor]:
    r"""The gradients of one ring step's block: dq of the local queries over
    the block, and the block's dk, dv from the local queries, computed with
    the merged output `o` (in q's dtype) and float32 log-sum-exp `lse` of
    all the blocks. On the card one launch of the attention backward
    kernel; on the CPU its plain version."""

    if q.device.type == "cuda":
        return _attention_bwd_kernel(q, k, v, o, lse, g.contiguous(), scale, bias, mode)

    return _attention_bwd_plain(q, k, v, o, lse, g, scale, bias, mode)


def _neighbours(group) -> tuple[int, int, int, int]:
    r"""This rank's index and the group's size, and the global ranks of the
    next and previous ranks on the ring."""

    n, r = dist.get_world_size(group), dist.get_rank(group)

    return r, n, dist.get_global_rank(group, (r + 1) % n), dist.get_global_rank(group, (r - 1) % n)


def _exchange(group) -> Callable:
    r"""The exchange of :func:`ring_forward` over the ranks of `group`: one
    `batch_isend_irecv` to the next rank and from the previous one."""

    _, _, nxt, prv = _neighbours(group)

    def exchange(t: Tensor, tag: int) -> Callable[[], Tensor]:
        buf = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, nxt, group, tag), dist.P2POp(dist.irecv, buf, prv, group, tag)]
        requests = dist.batch_isend_irecv(ops)

        def receive() -> Tensor:
            for req in requests:
                req.wait()
            return buf

        return receive

    return exchange


def _mask_bias(mask: Tensor | None, q: Tensor, r: int) -> tuple[Tensor | None, str]:
    r"""The rows of this rank of a head-broadcast global boolean mask, as a
    float (Bm, 1, L_b, L) bias in q's dtype, and its mode."""

    if mask is None:
        return None, "one"
    if mask.ndim >= 3 and mask.shape[-3] != 1:
        raise ValueError(f"ring attention requires a head-broadcast mask, shape (L, L) or (*, 1, L, L); got {tuple(mask.shape)}")

    B, _, Lb, _ = q.shape
    L = mask.shape[-1]
    shape = (1,) * (4 - mask.ndim) + tuple(mask.shape)
    rows = mask.to(q.device).reshape(shape)[..., r * Lb : (r + 1) * Lb, :]

    if shape[0] not in (1, B) or shape[-2:] != (L, L):
        raise ValueError(f"the mask {tuple(mask.shape)} does not broadcast to (B, 1, L, L)")

    bias = torch.where(rows, 0.0, _MASKED_OUT).to(q.dtype)

    return bias, "batch" if shape[0] > 1 else "one"


def _tile(bias: Tensor | None, j: int, Lb: int) -> Tensor | None:
    r"""The (Bm, L_b, L_b) bias of block j's columns."""

    if bias is None:
        return None
    return bias[:, 0, :, j * Lb : (j + 1) * Lb].contiguous()


def ring_forward(
    q: Tensor,
    kv: Tensor,
    scale: float,
    bias: Tensor | None,
    mode: str,
    rank: int,
    n: int,
    exchange: Callable,
) -> tuple[Tensor, Tensor]:
    r"""One rank's forward over a ring of `n` ranks: `n` ring steps, each
    block passed on to the next rank while it is taken.

    Arguments:
        q: The rank's queries, with shape :math:`(B, H, L_b, D)`.
        kv: The rank's keys and values, stacked: :math:`(2, B, H, L_b, D)`.
        scale: The logit scale.
        bias: The rank's rows of the bias, :math:`(B_m, 1, L_b, L)`, or
            :py:`None`.
        mode: The bias's broadcast mode.
        rank, n: The rank's index on the ring and the ring's size.
        exchange: `exchange(t, tag)` starts sending `t` to the next rank and
            receiving a tensor like it from the previous one, and returns a
            function that waits and returns the received tensor; tag 0 for
            K/V blocks, 1 for their gradients.

    Returns:
        The float32 output and log-sum-exp of the rank's queries.
    """

    Lb = q.shape[2]

    o = lse = None
    for i in range(n):
        if i + 1 < n:
            receive = exchange(kv, 0)
        j = (rank - i) % n  # the block held now came from rank - i
        o, lse = ring_step(q, kv[0], kv[1], o, lse, scale, _tile(bias, j, Lb), mode)
        if i + 1 < n:
            kv = receive()

    return o, lse


def ring_backward(
    q: Tensor,
    kv: Tensor,
    o: Tensor,
    lse: Tensor,
    g: Tensor,
    scale: float,
    bias: Tensor | None,
    mode: str,
    rank: int,
    n: int,
    exchange: Callable,
) -> tuple[Tensor, Tensor]:
    r"""One rank's backward over a ring of `n` ranks, as
    :func:`ring_forward` with the merged output `o` (in q's dtype), its
    float32 log-sum-exp `lse` and the output's cotangent `g`. The next K/V
    block is received while the held one's backward runs; the held block's
    gradients, summed over the ranks before, arrive meanwhile, take this
    rank's and are passed on, and after `n` steps the rank's own block's
    arrive home, summed over every rank.

    Returns:
        The float32 dq of the rank's queries, and the float32
        :math:`(2, B, H, L_b, D)` dk, dv of its block.
    """

    Lb = q.shape[2]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)

    receive_dkv = None
    for i in range(n):
        if i + 1 < n:
            receive_kv = exchange(kv, 0)
        j = (rank - i) % n
        dq_j, dk_j, dv_j = ring_step_backward(q, kv[0], kv[1], o, lse, g, scale, _tile(bias, j, Lb), mode)
        dq += dq_j
        if receive_dkv is None:
            dkv = torch.stack([dk_j, dv_j]).float()
        else:
            # the received buffer is this rank's: the sums of the ranks before
            dkv = receive_dkv()
            dkv[0] += dk_j
            dkv[1] += dv_j
        if n > 1:
            receive_dkv = exchange(dkv, 1)
        if i + 1 < n:
            kv = receive_kv()

    if n > 1:
        dkv = receive_dkv()

    return dq, dkv


class LoneRank:
    r"""The exchange of :func:`ring_forward` and :func:`ring_backward` for one
    rank of a ring driven in one process, without the others: the K/V blocks
    it receives are `blocks`, and the other ranks add nothing to the
    gradients, as if their cotangents were zero. Summing the gradients of
    every rank so driven gives the ring's; :attr:`sent` keeps the gradients
    this rank passed on, :meth:`block_grads` arranges them by block.

    Arguments:
        blocks: The stacked K/V block of each rank, in ring order.
        rank: The rank driven.
    """

    def __init__(self, blocks: list[Tensor], rank: int) -> None:
        self.blocks, self.rank, self.n = blocks, rank, len(blocks)
        self.calls = [0, 0]
        self.sent = []

    def __call__(self, t: Tensor, tag: int) -> Callable[[], Tensor]:
        self.calls[tag] += 1
        i = self.calls[tag]
        if tag == 0:
            received = self.blocks[(self.rank - i) % self.n]
        else:
            self.sent.append(t)
            received = self.sent[0] if i == self.n else torch.zeros_like(t)
        return lambda: received

    def block_grads(self) -> list[Tensor]:
        r"""The gradients this rank passed on, of each block in ring order."""

        out = [None] * self.n
        for i, t in enumerate(self.sent):
            out[(self.rank - i) % self.n] = t
        return out


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, bias, mode, group):
        r, n, _, _ = _neighbours(group)
        q = q.contiguous()

        o, lse = ring_forward(q, torch.stack([k, v]), scale, bias, mode, r, n, _exchange(group))
        o = o.to(q.dtype)

        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.scale, ctx.mode, ctx.group = scale, mode, group

        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse, bias = ctx.saved_tensors
        r, n, _, _ = _neighbours(ctx.group)
        g = g.to(q.dtype)

        dq, dkv = ring_backward(
            q, torch.stack([k, v]), o, lse, g, ctx.scale, bias, ctx.mode, r, n, _exchange(ctx.group)
        )

        return dq.to(q.dtype), dkv[0].to(q.dtype), dkv[1].to(q.dtype), None, None, None, None


def ring_attention_local(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    axis=None,
    scale: float | None = None,
    mask: Tensor | None = None,
) -> Tensor:
    r"""Ring attention on this rank's blocks of the sequence.

    This is the model-layer entry point: a sequence-split backbone (a
    :class:`azula_tpu_torch.nn.dit.DiT` with `implementation='ring'`) runs
    its forward on each rank's tokens, and each
    :class:`~azula_tpu_torch.nn.attention.MultiheadSelfAttention` calls this
    with its local blocks. Rank :math:`r` of the group holds tokens
    :math:`[r L_b, (r + 1) L_b)`.

    Arguments:
        q: Local queries, with shape :math:`(B, H, L_b, D)`.
        k: Local keys, same shape.
        v: Local values, same shape.
        axis: The ranks that split the sequence: a process group, the name
            of a dim of the current mesh, or :py:`None` for all ranks.
        scale: Logit scale; defaults to :math:`1/\sqrt{D}`.
        mask: An optional head-broadcast boolean mask over the *global*
            sequence (:math:`(L, L)` or :math:`(*, 1, L, L)`), the same on
            every rank.

    Returns:
        The local attention output, with shape :math:`(B, H, L_b, D)`.
    """

    if scale is None:
        scale = 1 / math.sqrt(q.shape[-1])

    group = axis_group(axis)
    bias, mode = _mask_bias(mask, q, dist.get_rank(group))

    return _RingAttention.apply(q, k, v, scale, bias, mode, group)


def ring_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    mesh: DeviceMesh | None = None,
    axis: str = "data",
    scale: float | None = None,
    mask: Tensor | None = None,
) -> Tensor:
    r"""Computes exact attention with the sequence split over a mesh dim.

    Every rank passes the whole :math:`(B, H, L, D)` tensors (JAX's global
    arrays); each keeps its block of the sequence and runs
    :func:`ring_attention_local`.

    Arguments:
        q, k, v: Queries, keys and values, with shape :math:`(B, H, L, D)`;
            :math:`L` divides by the dim's size.
        mesh: The mesh. Defaults to :func:`~azula_tpu_torch.parallel.mesh.get_mesh`.
        axis: The mesh dim that splits the sequence.
        scale: Logit scale; defaults to :math:`1/\sqrt{D}`.
        mask: An optional head-broadcast boolean mask over the sequence.

    Returns:
        This rank's block of the output, with shape :math:`(B, H, L / n, D)`:
        the output is split like the inputs.
    """

    group = axis_group(axis, mesh)
    n, r = dist.get_world_size(group), dist.get_rank(group)

    if q.shape[2] % n:
        raise ValueError(f"a sequence of {q.shape[2]} does not split over {n} ranks")

    q, k, v = (t.chunk(n, dim=2)[r] for t in (q, k, v))

    return ring_attention_local(q, k, v, group, scale, mask)
