r"""Device meshes and sharding rules.

Port of :mod:`azula_tpu.parallel.mesh` on `torch.distributed`. JAX builds a
:class:`jax.sharding.Mesh` over the devices of one program and lets XLA emit
the collectives; here each rank is a process that holds one card, the mesh
is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks, and
the collectives are called by the modules of :mod:`azula_tpu_torch.parallel`.

- **data parallel**: the batch axis of sampler state :math:`(B, *)` is split
  over the `'data'` mesh dim; each rank holds its rows (:func:`shard_batch`);
- **tensor parallel**: the `'model'` mesh dim splits backbone matmuls
  (:mod:`azula_tpu_torch.parallel.tp`).

A mesh dim is named by a string, and the process group of a dim is
:func:`axis_group`'s. Entry points run on the card (`'cuda'`, the `nccl`
backend) unless the caller asks for the CPU (`'cpu'`, `gloo`).
"""

from __future__ import annotations

__all__ = [
    "axis_group",
    "data_sharding",
    "gather_batch",
    "get_mesh",
    "initialize_distributed",
    "make_hybrid_mesh",
    "make_mesh",
    "replicated",
    "shard_batch",
]

import datetime
import math
import os
import torch
import torch.distributed as dist

from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..nn.utils import _map

_MESH: DeviceMesh | None = None


def initialize_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    timeout: float | datetime.timedelta | None = None,
    **kwargs,
) -> None:
    r"""Initializes the default process group, the counterpart of
    `jax.distributed.initialize`. Idempotent: a second call does nothing.

    Without arguments, the rank, the world size and the rendezvous come from
    the environment that `torchrun` sets (`RANK`, `WORLD_SIZE`,
    `MASTER_ADDR`, `MASTER_PORT`), and each rank takes the card of its
    `LOCAL_RANK`.

    Arguments:
        backend: `'nccl'` (the default: the card) or `'gloo'` (the CPU).
        init_method: The rendezvous URL, `env://` by default; a `store` in
            `kwargs` takes its place.
        world_size: The number of ranks.
        rank: This process's rank.
        timeout: The collectives' timeout, in seconds or as a timedelta.
        kwargs: Forwarded to `torch.distributed.init_process_group`.
    """

    if dist.is_initialized():
        return

    backend = "nccl" if backend is None else backend
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", 0 if rank is None else rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)

    if "store" not in kwargs:
        kwargs["init_method"] = "env://" if init_method is None else init_method
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if timeout is not None:
        kwargs["timeout"] = timeout if isinstance(timeout, datetime.timedelta) else datetime.timedelta(seconds=timeout)

    dist.init_process_group(backend=backend, **kwargs)


def _device_type(device) -> str:
    if device is None:
        return "cpu" if dist.is_initialized() and dist.get_backend() == "gloo" else "cuda"
    return torch.device(device).type


def _mesh(device, shape: tuple[int, ...], names: tuple[str, ...]) -> DeviceMesh:
    global _MESH

    device_type = _device_type(device)
    if not dist.is_initialized():
        initialize_distributed("gloo" if device_type == "cpu" else "nccl")

    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} != world size {world}")

    _MESH = init_device_mesh(device_type, shape, mesh_dim_names=names)

    return _MESH


def make_mesh(data: int | None = None, model: int = 1, device=None) -> DeviceMesh:
    r"""Creates a `('data', 'model')` mesh over all ranks, rank-major: the
    `'model'` dim is innermost, so that its ranks are neighbours (one host,
    NVLink). It becomes the mesh of :func:`get_mesh`.

    Arguments:
        data: The data-parallel size. Defaults to `world_size / model`.
        model: The tensor-parallel size.
        device: The device type of the mesh, the card (`'cuda'`) unless the
            default process group runs `gloo`, or the caller names another.
    """

    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))
    if data is None:
        data = world // model

    return _mesh(device, (data, model), ("data", "model"))


def make_hybrid_mesh(
    data: int | None = None,
    model: int = 1,
    replica: int | None = None,
    device=None,
) -> DeviceMesh:
    r"""Creates a `('replica', 'data', 'model')` mesh for several hosts: the
    outer `'replica'` dim spans hosts (keep only gradient and EMA
    all-reduces on it), `'data'` and `'model'` stay inside a host.

    Arguments:
        data: The data-parallel size per replica. Defaults to
            `world_size / (replica * model)`.
        model: The tensor-parallel size (innermost).
        replica: The number of replicas. Defaults to the number of hosts,
            `world_size / LOCAL_WORLD_SIZE` (one when `torchrun` did not set
            it), as JAX defaults to its number of processes, each of which
            drives a host's devices.
        device: The device type of the mesh (see :func:`make_mesh`).
    """

    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))
    if replica is None:
        replica = max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
    if data is None:
        data = world // (replica * model)

    return _mesh(device, (replica, data, model), ("replica", "data", "model"))


def get_mesh() -> DeviceMesh:
    r"""Returns the mesh made last by :func:`make_mesh` or
    :func:`make_hybrid_mesh`, or else a new data-parallel mesh over all
    ranks."""

    return make_mesh() if _MESH is None else _MESH


def data_sharding(mesh: DeviceMesh) -> tuple:
    r"""Returns the placements of batched tensors on the mesh: the batch
    split over `'data'`, everything else replicated."""

    return tuple(Shard(0) if name == "data" else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    r"""Returns the placements of a tensor replicated on every rank (the
    parameters under pure data parallelism)."""

    return (Replicate(),) * mesh.ndim


def axis_group(axis=None, mesh: DeviceMesh | None = None) -> dist.ProcessGroup:
    r"""Returns the process group of a mesh dim: `axis` is a process group
    (returned as it is), the name of a dim of `mesh` (by default
    :func:`get_mesh`), or :py:`None` for all ranks."""

    if axis is None:
        return dist.group.WORLD
    if isinstance(axis, str):
        return (get_mesh() if mesh is None else mesh).get_group(axis)
    return axis


def _rows(x: Tensor, rank: int, n: int) -> Tensor:
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {n} ranks")
    return x.chunk(n)[rank]


def shard_batch(x, mesh: DeviceMesh | None = None):
    r"""Returns this rank's rows of the leading (batch) axis of a tensor, or
    of every tensor leaf of a tuple, list or dict, split over the mesh's
    `'data'` dim. Every rank passes the whole batch."""

    if mesh is None:
        mesh = get_mesh()

    rank, n = mesh.get_local_rank("data"), mesh.size(mesh.mesh_dim_names.index("data"))

    return _map(lambda leaf: _rows(leaf, rank, n) if isinstance(leaf, Tensor) else leaf, x)


def gather_batch(x: Tensor, mesh: DeviceMesh | None = None) -> Tensor:
    r"""Returns the whole batch from each rank's rows along the `'data'` dim
    (the inverse of :func:`shard_batch`), on every rank."""

    if mesh is None:
        mesh = get_mesh()

    group = mesh.get_group("data")
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)

    return torch.cat(parts)
