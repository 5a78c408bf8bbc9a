r"""Model-family recipes of the parallel layer.

Port of :mod:`azula_tpu.parallel.recipes`. :mod:`azula_tpu_torch.parallel.pp`
provides the generic GPipe machinery (:func:`~azula_tpu_torch.parallel.pp.pipeline_blocks`);
this module binds it and the tensor-parallel rules to model families, so
that a user gets a pipelined forward or a sharded server in one call:

- :func:`pipeline_dit`: the DiT family's patch and position embeddings and
  its output projection are small and run replicated on every stage, while
  the transformer block stack — all of the FLOPs — is pipelined over a mesh
  dim, each rank running its stage's blocks. What varies per microbatch (the token activations and, when batched,
  the modulation and position tensors) is sent stage to stage; what does not
  rides in the ``consts`` of :func:`~azula_tpu_torch.parallel.pp.pipeline_blocks`.
- :func:`flux_serving_shardings` and :func:`serve_flux`: the FLUX.1
  transformer split by Megatron's tensor parallelism over `'model'` and by
  ZeRO-3 over `'data'`, under the DDIM sampler, with classifier-free
  guidance on request.
"""

from __future__ import annotations

__all__ = [
    "pipeline_dit",
    "flux_serving_shardings",
    "serve_flux",
]

import re
import torch

from collections.abc import Callable
from torch import Tensor, nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..nn.dit import DiT
from .mesh import shard_batch
from .pp import _GroupExchange, _stages, pipeline_stage
from .tp import FLUX_TP_RULES, _split_over, shard_module


def _dit_block(block: nn.Module, state: dict, consts: dict) -> dict:
    r"""`pipeline_dit`'s block function: one of the DiT's own blocks on the
    state and the shared tensors, bound by name."""

    bound = {**consts, **state}
    return {**state, "h": block(bound["h"], bound.get("mod"), pos=bound["pos"])}


def pipeline_dit(
    dit: DiT,
    mesh: DeviceMesh,
    axis: str = "model",
    microbatches: int | None = None,
) -> Callable:
    r"""Builds a pipeline-parallel forward for a :class:`azula_tpu_torch.nn.dit.DiT`.

    The returned function matches ``dit(x, mod, pos, cond)`` (the inference
    path: no dropout generator goes through the pipeline) with the
    ``hid_blocks`` transformer blocks split into contiguous stages over the
    ``axis`` ranks of ``mesh``; each rank runs its own stage's blocks, the
    DiT's modules themselves. Differentiable: gradients flow back through the
    sends of the schedule into the input, the replicated projections and the
    rank's stage's blocks, so the recipe serves training as well as serving.

    Arguments:
        dit: The DiT module. The dim's size must divide its block count.
        mesh: The device mesh.
        axis: The mesh dim to pipeline over.
        microbatches: Microbatch count (defaults to the dim's size); the
            leading batch dimension of ``x`` must divide by it.

    Returns:
        ``forward(x, mod=None, pos=None, cond=None)`` — its output equals the
        sequential ``dit`` forward, on every rank of the dim.
    """

    S, s, group = _stages(mesh, axis, len(dit.blocks))

    k = len(dit.blocks) // S
    local = list(dit.blocks)[s * k : (s + 1) * k]
    exchange = _GroupExchange(group)

    def forward(
        x: Tensor,
        mod: Tensor | None = None,
        pos: Tensor | None = None,
        cond: Tensor | None = None,
    ) -> Tensor:
        if cond is not None:
            x = torch.cat((x, cond), dim=-1)

        h = dit.in_proj(x)

        if pos is None:
            pos = torch.arange(h.shape[-2], device=h.device).to(h.dtype)[..., None]

        emb = dit.pos_encoding(pos)
        emb = emb.flatten(-2)
        h = h + dit.pos_proj(emb)

        # Send per-microbatch state; share microbatch-invariant tensors. A
        # tensor is sent only when its leading dimension IS the batch —
        # broadcastable shapes like a (1, D) modulation or an unbatched
        # (L, P) position are microbatch-invariant and ride in consts
        # (matching the sequential forward's broadcasting).
        B = h.shape[0]
        stream = {"h": h}
        consts = {}

        if pos.ndim > 2 and pos.shape[0] == B:
            stream["pos"] = pos
        else:
            consts["pos"] = pos

        if mod is not None:
            if mod.ndim > 1 and mod.shape[0] == B:
                stream["mod"] = mod
            else:
                consts["mod"] = mod

        out = pipeline_stage(
            _dit_block, local, stream, s, S, exchange, microbatches=microbatches, consts=(consts,), group=group
        )

        return dit.out_proj(out["h"])

    return forward


def _largest_dims(shape: tuple[int, ...]) -> list[int]:
    r"""The dimensions of `shape` from the largest, ties from the last: the
    order in which JAX's rule, on its (in, out) weights, meets the dimensions
    of torch's (out, in) ones."""

    return sorted(reversed(range(len(shape))), key=lambda d: shape[d], reverse=True)


def flux_serving_shardings(
    denoiser: nn.Module,
    mesh: DeviceMesh,
    min_size: int = 2**16,
) -> dict:
    r"""Parameter placements that make the 12B Flux MMDiT servable: Megatron
    tensor parallelism composed with ZeRO-3 weight sharding on one
    `('data', 'model')` mesh.

    The FLUX.1 transformer holds ~11.9B parameters (~24 GB in bf16). Per
    parameter, the first rule that matches wins:

    1. :data:`~azula_tpu_torch.parallel.tp.FLUX_TP_RULES` — attention heads
       and FFN hidden dims split over `'model'` (one all-reduce per block in
       the forward); the parameter's largest dimension that the rule leaves
       whole and that divides by the `'data'` size is also split over
       `'data'` (ZeRO-3: each module gathers it for its forward), so that a
       tensor-parallel weight takes :math:`1 / (data \cdot model)` of its
       size on each rank.
    2. Any other parameter of at least ``min_size`` elements splits its
       largest divisible dimension over `'data'`.
    3. Smaller ones (norm scales, small biases) are replicated.

    Arguments:
        denoiser: The Flux denoiser (or any module holding the transformer).
        mesh: A mesh with `('data', 'model')` dims; `'model'` must divide
            the head count (24 for FLUX.1).
        min_size: Parameters smaller than this stay replicated.

    Returns:
        Each parameter's placements by name, one per mesh dim in the mesh's
        order (`Shard`, :class:`~azula_tpu_torch.parallel.tp.Segments` or
        `Replicate`), as DTensor's: JAX's `NamedSharding` specs, in torch's
        (out, in) weight layout.
    """

    names = mesh.mesh_dim_names
    n_data = mesh.size(names.index("data"))

    def placements(**split) -> tuple:
        return tuple(split.get(name, Replicate()) for name in names)

    out = {}
    for name, p in denoiser.named_parameters():
        shape = tuple(p.shape)

        for pattern, spec in FLUX_TP_RULES:
            if re.search(pattern, "." + name):
                # add 'data' on the largest dimension the rule leaves whole
                data = Replicate()
                for d in _largest_dims(shape):
                    if d != spec.dim and shape[d] % n_data == 0:
                        data = Shard(d)
                        break
                out[name] = placements(data=data, model=spec)
                break
        else:
            out[name] = placements()
            if p.numel() >= min_size:
                for d in _largest_dims(shape):
                    if shape[d] % n_data == 0:
                        out[name] = placements(data=Shard(d))
                        break

    return out


def _place(denoiser: nn.Module, mesh: DeviceMesh, min_size: int) -> nn.Module:
    r"""Places `denoiser`'s parameters in place by
    :func:`flux_serving_shardings`: the tensor-parallel split first
    (:func:`~azula_tpu_torch.parallel.tp.shard_module`), then each piece's
    or whole parameter's split over `'data'`, gathered by its module for its
    forward only. No parameter is held twice: each whole one is dropped as
    its piece takes its place. A denoiser placed by an earlier call with the
    same mesh and `min_size` is returned as it is.

    Raises:
        ValueError: When `denoiser` was placed otherwise: by an earlier call
            with another mesh or `min_size`, or by
            :func:`~azula_tpu_torch.parallel.tp.shard_module` or
            :func:`~azula_tpu_torch.parallel.tp.shard_module_fsdp`.
    """

    placed = getattr(denoiser, "_serving_placement", None)

    if placed is not None and placed == (mesh, min_size):
        return denoiser
    if placed is not None or any(hasattr(p, "placement") for p in denoiser.parameters()):
        raise ValueError("the denoiser is already placed otherwise; serve_flux places an unplaced one")

    data = mesh.mesh_dim_names.index("data")
    specs = flux_serving_shardings(denoiser, mesh, min_size)

    denoiser = shard_module(denoiser, mesh, rules=FLUX_TP_RULES, inplace=True)
    denoiser = _split_over(denoiser, {name: spec[data] for name, spec in specs.items()}, mesh, "data")
    denoiser._serving_placement = (mesh, min_size)

    return denoiser


def serve_flux(
    denoiser: nn.Module,
    mesh: DeviceMesh,
    steps: int = 28,
    eta: float = 0.0,
    microbatch: int | None = None,
    min_size: int = 2**16,
) -> Callable:
    r"""Builds the sharded Flux serving path: the TP x ZeRO-3 placement of
    :func:`flux_serving_shardings` under the DDIM sampler and optional
    classifier-free guidance, the batch split over `'data'`.

    The denoiser-side counterpart of a text-to-image pipeline: prompt
    encoding and the VAE decode stay outside (they are small and run
    data-parallel as they are).

    The placement is made in place: `denoiser` itself becomes the placed
    module, whose parameters are this rank's pieces, so that a model that
    fills the card is never held twice. Sample with the unplaced denoiser
    before calling this, if both are wanted. Another call on the placed
    denoiser with the same mesh and ``min_size`` (other steps, chunks) uses
    the placement as it is; with another, or on a denoiser that
    :func:`~azula_tpu_torch.parallel.tp.shard_module` or
    :func:`~azula_tpu_torch.parallel.tp.shard_module_fsdp` placed, it
    raises `ValueError`.

    Arguments:
        denoiser: A :class:`azula_tpu_torch.models.flux.FluxDenoiser` (small
            configurations too — the recipe only assumes the parameter names
            that :data:`~azula_tpu_torch.parallel.tp.FLUX_TP_RULES` match).
        mesh: A `('data', 'model')` mesh; `'model'` must divide the head
            count.
        steps: DDIM steps.
        eta: DDIM stochasticity.
        microbatch: When set, the batch is generated in chunks of this size
            (each rank takes its rows of each) to bound activation memory at
            4k-token sequences; `None` runs the whole batch in one call. Must
            be a multiple of the `'data'` size.
        min_size: Replication threshold forwarded to
            :func:`flux_serving_shardings`.

    Returns:
        ``sample(x1, positive, negative=None, guidance=1.0, generator=None)``
        — ``positive``/``negative`` are conditioning dicts (``prompt_clip``,
        ``prompt_t5``, and optionally the distilled ``guidance`` scalar).
        Without ``negative``, it runs the distilled-guidance path (one
        backbone call a step — FLUX.1-dev). With ``negative``, it runs
        fused-batch classifier-free guidance (``guidance`` is the CFG
        strength :math:`\omega`; the positive/negative pair rides one
        :math:`2B` backbone call). Every rank passes the whole batch and
        gets this rank's rows of the samples, as
        :func:`~azula_tpu_torch.parallel.batch.sample_sharded` gives them
        (:func:`~azula_tpu_torch.parallel.mesh.gather_batch` joins them).
        Chunk :math:`i` samples with ``fold_in(generator, i)``.
    """

    from ..guidance import CFGDenoiser
    from ..sample import DDIMSampler
    from .ulysses import fold_in

    n_data = mesh.size(mesh.mesh_dim_names.index("data"))

    if microbatch is not None:
        assert microbatch % n_data == 0, (microbatch, n_data)

    placed = _place(denoiser, mesh, min_size)

    plain = DDIMSampler(placed, eta=eta, steps=steps)
    fused = DDIMSampler(CFGDenoiser(placed, batched=True), eta=eta, steps=steps)

    def rows(tree: dict | None, batch: int, cut: Callable) -> dict | None:
        r"""`cut` of each batched leaf of `tree`; other leaves as they are."""

        if tree is None:
            return None
        return {k: cut(v) if isinstance(v, Tensor) and v.ndim >= 1 and v.shape[0] == batch else v for k, v in tree.items()}

    def sample_chunk(x1, positive, negative, guidance, generator):
        if negative is None:
            return plain(x1, generator=generator if plain.requires_generator else None, **positive)

        return fused(
            x1,
            generator=generator if fused.requires_generator else None,
            positive=positive,
            negative=negative,
            guidance=guidance,
        )

    def sample(x1, positive, negative=None, guidance=1.0, generator=None):
        B = x1.shape[0]

        def local(leaf):
            return shard_batch(leaf, mesh)

        x1, positive, negative = local(x1), rows(positive, B, local), rows(negative, B, local)

        if microbatch is None or microbatch >= B:
            return sample_chunk(x1, positive, negative, guidance, generator)

        assert B % microbatch == 0, (B, microbatch)

        # chunk i of this rank's rows: its rows of the batch's chunk i
        b, r = x1.shape[0], microbatch // n_data
        outs = []
        for i in range(B // microbatch):

            def chunk(leaf, i=i):
                return leaf[i * r : (i + 1) * r]

            outs.append(
                sample_chunk(
                    chunk(x1),
                    rows(positive, b, chunk),
                    rows(negative, b, chunk),
                    guidance,
                    None if generator is None else fold_in(generator, i),
                )
            )

        return torch.cat(outs)

    return sample
