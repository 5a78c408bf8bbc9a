r"""Ulysses attention: sequence parallelism by head/sequence transposition.

Port of :mod:`azula_tpu.parallel.ulysses`, the complement of
:mod:`azula_tpu_torch.parallel.ring`: instead of passing K/V blocks around
the ring, one `all_to_all_single` (with autograd,
`torch.distributed.nn.functional`) turns each of q, k, v from
*sequence-split* to *head-split*, every rank runs full attention over the
whole sequence for its heads through
:func:`~azula_tpu_torch.ops.attention.dot_product_attention` (the attention
kernels on the card), and one more `all_to_all_single` turns the output back.

Because each rank's attention sees the whole sequence, masks and dropout
compose with no extra machinery: a head-broadcast mask applies as it is, and
dropout draws from a generator folded with the rank (:func:`fold_in`), one
per head shard, as JAX folds its key with the axis index. The port's dropout
draws from `torch.Generator`s and JAX's from threefry keys, so the two
agree in distribution, not in draws.

Ulysses needs the heads to divide by the number of ranks; ring attention
does not.

References:
    | DeepSpeed Ulysses: System Optimizations for Enabling Training of Extreme
      Long Sequence Transformer Models (Jacobs et al., 2023)
    | https://arxiv.org/abs/2309.14509
"""

from __future__ import annotations

__all__ = [
    "fold_in",
    "ulysses_attention",
    "ulysses_attention_local",
]

import math
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh

from ..ops.attention import dot_product_attention
from .mesh import axis_group

_M64 = (1 << 64) - 1


def fold_in(generator: torch.Generator, index: int) -> torch.Generator:
    r"""A new generator on `generator`'s device, seeded from one 62-bit draw
    of `generator` and `index` (the splitmix64 finalizer of their sum): the
    counterpart of `jax.random.fold_in`. Ranks that hold generators in the
    same state draw the same word and fold in their own index."""

    word = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
    z = (word + (index + 1) * 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    z ^= z >> 31

    return torch.Generator(device=generator.device).manual_seed(z)


def _all_to_all(x: Tensor, group) -> Tensor:
    r"""Rank r's chunk i of the leading axis goes to rank i, which puts it at
    its index r."""

    x = x.contiguous()  # so that the output, shaped like it, is too
    return dist_fn.all_to_all_single(torch.empty_like(x), x, group=group)


def ulysses_attention_local(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    axis=None,
    scale: float | None = None,
    mask: Tensor | None = None,
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
) -> Tensor:
    r"""Ulysses attention on this rank's blocks of the sequence.

    The model-layer entry point: a sequence-split backbone (a
    :class:`azula_tpu_torch.nn.dit.DiT` with `implementation='ulysses'`)
    calls this from every
    :class:`~azula_tpu_torch.nn.attention.MultiheadSelfAttention` with its
    local blocks. Rank :math:`r` holds tokens :math:`[r L_b, (r + 1) L_b)`.

    Arguments:
        q: Local queries, with shape :math:`(B, H, L_b, D)`.
        k: Local keys, same shape.
        v: Local values, same shape.
        axis: The ranks that split the sequence: a process group, the name
            of a dim of the current mesh, or :py:`None` for all ranks.
        scale: Logit scale; defaults to :math:`1/\sqrt{D}`.
        mask: An optional head-broadcast boolean mask over the *global*
            sequence, :math:`(L, L)` or :math:`(*, 1, L, L)`, the same on
            every rank.
        dropout_rate: Attention-weight dropout rate.
        generator: The generator of the dropout, in the same state on every
            rank; required for dropout.

    Returns:
        The local attention output, with shape :math:`(B, H, L_b, D)`.
    """

    if scale is None:
        scale = 1 / math.sqrt(q.shape[-1])

    group = axis_group(axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)

    B, H, Lb, D = q.shape
    if H % n:
        raise ValueError(
            f"Ulysses attention needs heads ({H}) divisible by the axis size ({n}); use ring attention otherwise."
        )
    if mask is not None and mask.ndim >= 3 and mask.shape[-3] != 1:
        raise ValueError(
            "Ulysses attention requires a head-broadcast mask, shape (L, L) or (*, 1, L, L), since heads are "
            f"split during the attention product; got {tuple(mask.shape)}."
        )

    def gather_sequence(x: Tensor) -> Tensor:
        # (B, H, L_b, D) -> (n, B, H / n, L_b, D): head group i to rank i;
        # received, block i of the sequence from rank i -> (B, H / n, L, D)
        x = _all_to_all(x.unflatten(1, (n, H // n)).movedim(1, 0), group)
        return x.movedim(0, 2).flatten(2, 3)

    q, k, v = gather_sequence(q), gather_sequence(k), gather_sequence(v)

    if generator is not None and dropout_rate > 0:
        generator = fold_in(generator, r)
    else:
        dropout_rate, generator = 0.0, None

    o = dot_product_attention(q, k, v, mask=mask, dropout_rate=dropout_rate, generator=generator, scale=scale)

    # (B, H / n, L, D) -> (n, B, H / n, L_b, D): block i of the sequence to
    # rank i; received, head group i from rank i -> (B, H, L_b, D)
    o = _all_to_all(o.unflatten(2, (n, Lb)).movedim(2, 0), group)

    return o.movedim(0, 1).flatten(1, 2)


def ulysses_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    mesh: DeviceMesh | None = None,
    axis: str = "data",
    scale: float | None = None,
    mask: Tensor | None = None,
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
) -> Tensor:
    r"""Computes exact attention with the sequence split over a mesh dim,
    re-split over heads by `all_to_all_single` (DeepSpeed-Ulysses).

    Every rank passes the whole :math:`(B, H, L, D)` tensors (JAX's global
    arrays) and keeps its block of the sequence.

    Arguments:
        q, k, v: Queries, keys and values, with shape :math:`(B, H, L, D)`.
        mesh: The mesh. Defaults to :func:`~azula_tpu_torch.parallel.mesh.get_mesh`.
        axis: The mesh dim that splits the sequence.
        scale: Logit scale; defaults to :math:`1/\sqrt{D}`.
        mask: An optional head-broadcast boolean mask over the sequence.
        dropout_rate: Attention-weight dropout rate.
        generator: The generator of the dropout; required for dropout.

    Returns:
        This rank's block of the output, with shape :math:`(B, H, L / n, D)`.
    """

    group = axis_group(axis, mesh)
    n, r = dist.get_world_size(group), dist.get_rank(group)

    if q.shape[2] % n:
        raise ValueError(f"a sequence of {q.shape[2]} does not split over {n} ranks")

    q, k, v = (t.chunk(n, dim=2)[r] for t in (q, k, v))

    return ulysses_attention_local(q, k, v, group, scale, mask, dropout_rate, generator)
