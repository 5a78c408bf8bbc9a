r"""Pipeline parallelism: GPipe-style microbatched execution of a block stack
over a mesh dim.

Port of :mod:`azula_tpu.parallel.pp`. A transformer is a stack of :math:`L`
identical blocks; :func:`pipeline_blocks` places :math:`L/S` consecutive
blocks on each of the :math:`S` ranks of a mesh dim and streams :math:`M`
microbatches through the stages, over the :math:`M + S - 1` ticks of the
classic fill-and-drain schedule. JAX runs the schedule as one
`lax.fori_loop` inside `shard_map` and moves the state with a `ppermute` per
tick; here each rank is a process that runs its stage's ticks in order, and
the state goes to the next stage by point-to-point sends
(`torch.distributed.batch_isend_irecv`).

This trades :math:`(S-1)/(M+S-1)` bubble overhead for an :math:`S`-fold
reduction in per-rank parameter memory: the alternative to tensor
parallelism (:mod:`azula_tpu_torch.parallel.tp`) when a model's blocks fit a
card but the stack does not.

torch has no autograd through `isend`/`irecv`, so the send and the receive
are autograd functions, as the ring's blocks are
(:mod:`azula_tpu_torch.parallel.ring`): a receive's backward sends the
gradient back to the previous stage, and a send's backward receives it from
the next. A send gives a zero marker that is added to the rank's output, so
that the backward reaches every send on every rank.

References:
    | GPipe: Efficient Training of Giant Neural Networks using Pipeline Parallelism (Huang et al., 2019)
    | https://arxiv.org/abs/1811.06965
"""

from __future__ import annotations

__all__ = [
    "LoneStage",
    "pipeline_blocks",
    "pipeline_stage",
    "stack_modules",
]

import copy
import torch
import torch.distributed as dist

from collections.abc import Callable, Sequence
from torch import Tensor, nn
from torch.distributed.device_mesh import DeviceMesh

from ..nn.utils import _leaves, _map
from .tp import _ReduceFromModel


def _rebuild(tree, leaves: list):
    r"""`tree` with its leaves replaced, in order, by `leaves`."""

    it = iter(leaves)
    return _map(lambda _: next(it), tree)


def _tensors(module: nn.Module) -> dict[str, Tensor]:
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def _structure(module: nn.Module) -> tuple:
    return (
        [(name, type(sub)) for name, sub in module.named_modules()],
        [(name, tuple(t.shape), t.dtype) for name, t in _tensors(module).items()],
    )


def stack_modules(modules: Sequence[nn.Module]):
    r"""Stacks structurally identical modules into a pipeline layout.

    Turns a list of :math:`L` modules (e.g. the transformer blocks of a DiT)
    into ``(params, apply)``: ``params`` maps each parameter and buffer name
    to the :math:`L` modules' tensors stacked on a new leading dimension (a
    copy, without gradient), and ``apply(block_params, x, *args, **kwargs)``
    runs one block on its tensors (`torch.func.functional_call` on a
    template of the modules on the meta device) — the form
    :func:`pipeline_blocks` consumes.

    Arguments:
        modules: Structurally identical modules: the same classes, parameter
            and buffer names, shapes and dtypes.

    Returns:
        The ``(params, apply)`` pair.

    Raises:
        ValueError: When the modules are not structurally identical.
    """

    modules = list(modules)
    structure = _structure(modules[0])

    for other in modules[1:]:
        if _structure(other) != structure:
            raise ValueError("modules are not structurally identical")

    with torch.no_grad():
        tensors = [_tensors(m) for m in modules]
        stacked = {name: torch.stack([t[name] for t in tensors]) for name in tensors[0]}

    template = copy.deepcopy(modules[0]).to("meta")

    def apply(block_params, x, *args, **kwargs):
        return torch.func.functional_call(template, block_params, (x, *args), kwargs)

    return stacked, apply


class _GroupExchange:
    r"""The exchange of :func:`pipeline_stage` over the ranks of `group`, in
    stage order: sends go to the next rank, receives come from the previous
    one. Each leaf of a microbatch's state is a message of its own tag, so
    that messages match by microbatch, in the backward too."""

    def __init__(self, group: dist.ProcessGroup) -> None:
        r, n = dist.get_rank(group), dist.get_world_size(group)

        self.group = group
        self.prev = dist.get_global_rank(group, r - 1) if r > 0 else None
        self.next = dist.get_global_rank(group, r + 1) if r + 1 < n else None
        self.pending = []

        # NCCL wants every rank of the group in its first call on it, which
        # a stage's first send or receive is not
        if n > 1 and dist.get_backend(group) == "nccl":
            dist.all_reduce(torch.zeros(1, device="cuda"), group=group)

    @staticmethod
    def _tag(tag: int, leaf: int, count: int, backward: bool) -> int:
        return 2 * (tag * count + leaf) + int(backward)

    def send(self, tensors: list[Tensor], tag: int, backward: bool = False) -> None:
        peer = self.prev if backward else self.next
        tensors = [t.contiguous() for t in tensors]
        ops = [
            dist.P2POp(dist.isend, t, peer, self.group, self._tag(tag, j, len(tensors), backward))
            for j, t in enumerate(tensors)
        ]
        self.pending.append((dist.batch_isend_irecv(ops), tensors))

    def recv(self, likes: list[Tensor], tag: int, backward: bool = False) -> list[Tensor]:
        peer = self.next if backward else self.prev
        bufs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in likes]
        ops = [
            dist.P2POp(dist.irecv, b, peer, self.group, self._tag(tag, j, len(bufs), backward))
            for j, b in enumerate(bufs)
        ]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return bufs

    def flush(self) -> None:
        r"""Waits for the sends posted so far."""

        for works, _ in self.pending:
            for work in works:
                work.wait()
        self.pending.clear()


class LoneStage:
    r"""The exchange of :func:`pipeline_stage` for one stage of a pipeline
    driven in one process, without the others: its receives are the sends
    that the previous stage, driven before it, recorded (`received`), and the
    next stages send back no gradient, as if their cotangents were zero.
    :attr:`sent` keeps the states this stage passed on, by microbatch, for
    the next stage's exchange.

    Arguments:
        received: The previous stage's :attr:`sent`; none for stage 0.
    """

    def __init__(self, received: dict[int, list[Tensor]] | None = None) -> None:
        self.received = {} if received is None else received
        self.sent: dict[int, list[Tensor]] = {}
        self.grads_sent: dict[int, list[Tensor]] = {}

    def send(self, tensors: list[Tensor], tag: int, backward: bool = False) -> None:
        (self.grads_sent if backward else self.sent)[tag] = [t.detach() for t in tensors]

    def recv(self, likes: list[Tensor], tag: int, backward: bool = False) -> list[Tensor]:
        if backward:
            return [torch.zeros_like(t) for t in likes]
        return self.received[tag]

    def flush(self) -> None:
        pass


class _Send(torch.autograd.Function):
    r"""Sends a microbatch's state to the next stage and returns a zero
    marker; the backward receives the state's gradient from the next
    stage."""

    @staticmethod
    def forward(ctx, exchange, tag, anchor, *leaves):
        ctx.exchange, ctx.tag = exchange, tag
        ctx.likes = [(t.shape, t.dtype, t.device) for t in leaves]
        exchange.send([t.detach() for t in leaves], tag)
        return anchor.new_zeros(())

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, _):
        likes = [torch.empty(shape, dtype=dtype, device=device) for shape, dtype, device in ctx.likes]
        grads = ctx.exchange.recv(likes, ctx.tag, backward=True)
        return (None, None, None, *grads)


class _Recv(torch.autograd.Function):
    r"""Receives a microbatch's state from the previous stage; the backward
    sends its gradient back."""

    @staticmethod
    def forward(ctx, exchange, tag, likes, anchor):
        ctx.exchange, ctx.tag = exchange, tag
        return tuple(exchange.recv(likes, tag))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        ctx.exchange.send(list(grads), ctx.tag, backward=True)
        # the sends complete by the end of the backward
        torch.autograd.Variable._execution_engine.queue_callback(ctx.exchange.flush)
        return None, None, None, None


class _Enter(torch.autograd.Function):
    r"""The tensors every stage reads (the input's microbatches on stage 0,
    the constants on all), as they are, with a zero marker added to the
    rank's output; the backward all-reduces their gradients over the stages,
    so that every rank gets the sequential forward's."""

    @staticmethod
    def forward(ctx, group, anchor, *leaves):
        ctx.group = group
        return (anchor.new_zeros(()), *(t.view_as(t) for t in leaves))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, _, *grads):
        out = []
        for g, needed in zip(grads, ctx.needs_input_grad[2:], strict=True):
            if needed and ctx.group is not None:
                g = g.clone()
                dist.all_reduce(g, group=ctx.group)
            out.append(g if needed else None)
        return (None, None, *out)


def pipeline_stage(
    block_fn: Callable,
    local,
    x,
    stage: int,
    stages: int,
    exchange,
    microbatches: int | None = None,
    consts=(),
    group: dist.ProcessGroup | None = None,
):
    r"""Runs one stage of :func:`pipeline_blocks`' schedule: its ticks in
    order, its blocks on the valid ones.

    Arguments:
        block_fn: The per-block function (see :func:`pipeline_blocks`).
        local: The stage's :math:`L/S` blocks, in order: each what
            ``block_fn`` takes as its first argument.
        x: The whole batched input (see :func:`pipeline_blocks`).
        stage: The stage :math:`s`.
        stages: The number of stages :math:`S`.
        exchange: Moves the state between stages: `_GroupExchange` over a
            process group, or :class:`LoneStage` in one process.
        microbatches: The number of microbatches :math:`M` (defaults to
            :math:`S`).
        consts: A tuple or list of what every microbatch shares.
        group: The stages' process group: the output is all-reduced over it,
            with an identity backward, and so are the gradients of `x` and
            `consts`; none for a lone stage.

    Returns:
        With a group of more than one stage, the output on every stage.
        Otherwise this stage's part of it: the output on the last stage,
        zeros of its shapes elsewhere.
    """

    S, s = stages, stage
    M = S if microbatches is None else microbatches

    if group is not None and dist.get_world_size(group) == 1:
        group = None

    B = _leaves(x)[0].shape[0]

    assert B % M == 0, f"batch {B} must divide into {M} microbatches"
    assert all(a.shape[0] == B for a in _leaves(x)), "all state leaves must share the leading batch dimension"

    # autograd reaches the sends and receives through an anchor that requires
    # grad; without grad, they are plain calls
    device = _leaves(x)[0].device
    anchor = torch.zeros((), device=device, requires_grad=True) if torch.is_grad_enabled() else None
    markers = []

    if anchor is not None:
        tensors = [t for t in _leaves((x, consts)) if isinstance(t, Tensor)]
        marker, *entered = _Enter.apply(group, anchor, *tensors)
        markers.append(marker)
        it = iter(entered)
        x, consts = _map(lambda t: next(it) if isinstance(t, Tensor) else t, (x, consts))

    b = B // M
    xm = [_map(lambda a, i=i: a[i * b : (i + 1) * b], x) for i in range(M)]

    def stage_apply(h):
        for block in local:
            h = block_fn(block, h, *consts)
        return h

    outputs = [None] * M

    for t in range(M + S - 1):
        # stage s holds microbatch t - s during ticks s <= t < s + M; it skips
        # the fill and drain ticks outside them (JAX's `lax.cond`)
        if not s <= t < s + M:
            continue

        m = t - s
        if s == 0:
            state = xm[m]
        else:
            # the received state has the shapes and dtypes of the microbatch
            likes = _leaves(xm[m])
            if anchor is None:
                received = exchange.recv(likes, m)
            else:
                received = _Recv.apply(exchange, m, likes, anchor)
            state = _rebuild(xm[m], list(received))

        state = stage_apply(state)

        if s < S - 1:
            if anchor is None:
                exchange.send(_leaves(state), m)
            else:
                markers.append(_Send.apply(exchange, m, anchor, *_leaves(state)))
        else:
            outputs[m] = state

    exchange.flush()

    if s == S - 1:
        out = _rebuild(x, [torch.cat(parts) for parts in zip(*(_leaves(o) for o in outputs), strict=True)])
    else:
        out = _map(lambda a: torch.zeros_like(a, memory_format=torch.contiguous_format), x)

    if markers:
        marker = sum(markers[1:], markers[0])
        out = _map(lambda a: a + marker.to(a.dtype), out)

    if group is not None:
        out = _map(lambda a: _ReduceFromModel.apply(a, group), out)

    return out


def _stages(mesh: DeviceMesh, axis: str, blocks: int) -> tuple[int, int, dist.ProcessGroup]:
    r"""The number of stages :math:`S` on `axis`, this rank's stage and the
    axis's group, for a stack of `blocks` blocks."""

    S = mesh.size(mesh.mesh_dim_names.index(axis))

    assert blocks % S == 0, f"block count {blocks} must divide into {S} stages"

    return S, mesh.get_local_rank(axis), mesh.get_group(axis)


def pipeline_blocks(
    block_fn: Callable,
    params,
    x,
    mesh: DeviceMesh,
    axis: str = "model",
    microbatches: int | None = None,
    consts=(),
):
    r"""Applies a stack of identical blocks to ``x`` as a pipeline over a mesh
    dim.

    Equivalent to ``for i in range(L): x = block_fn(params[i], x, *consts)``
    with the :math:`L` blocks split into :math:`S` contiguous stages, one per
    rank of the ``axis`` dim. Rank :math:`s` keeps a copy of its stage's
    blocks only, so that the caller can free the whole stack.

    Arguments:
        block_fn: The per-block function
            ``block_fn(block_params, x, *consts) -> x``; must preserve the
            structure, shapes and dtypes of ``x``.
        params: A tensor, or a tuple, list or dict of tensors, with a leading
            block dimension :math:`L` (e.g. :func:`stack_modules`'), with
            :math:`L` divisible by the dim's size.
        x: The batched input — a tensor, or a tuple, list or dict of tensors,
            every leaf with a shared leading batch dimension :math:`B`
            divisible by ``microbatches``. Per-microbatch state (a modulation
            vector, a position tensor) rides along as extra leaves and is
            sent stage to stage with the activation.
        mesh: The device mesh.
        axis: The mesh dim to pipeline over.
        microbatches: The number of microbatches :math:`M` (defaults to the
            dim's size). Larger :math:`M` shrinks the pipeline bubble
            :math:`(S-1)/(M+S-1)`.
        consts: A tuple or list of what every microbatch shares (e.g.
            unbatched positions). Every stage reads it as it is — never
            sent — and ``block_fn`` takes it unpacked after the state, so it
            must be a sequence.

    Returns:
        The output, matching the structure and shapes of ``x``, on every rank
        of the dim: the last stage's, all-reduced (zeros elsewhere), with an
        identity backward. The gradients of ``x`` and of ``consts`` are the
        sequential forward's on every rank; those of ``params``, the rank's
        stage's blocks.
    """

    assert isinstance(consts, (tuple, list)), (
        "consts must be a tuple/list (it is unpacked as positional block_fn arguments)"
    )

    L = _leaves(params)[0].shape[0]
    S, s, group = _stages(mesh, axis, L)

    k = L // S
    stage = _map(lambda p: p[s * k : (s + 1) * k].clone(), params)
    local = [_map(lambda p, i=i: p[i], stage) for i in range(k)]

    return pipeline_stage(
        block_fn, local, x, s, S, _GroupExchange(group), microbatches=microbatches, consts=consts, group=group
    )
