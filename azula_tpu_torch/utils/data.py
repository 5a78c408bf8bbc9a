r"""Host-side input pipeline utilities.

Port of :mod:`azula_tpu.utils.data`. The card must not wait for its input:
batches should already be on it when the train step needs them. These
helpers take a dataset as tensors or numpy arrays, alone or in a tuple, list
or dict with a shared leading (example) dimension, and give torch tensors:

- :func:`batches` — an epoch iterator over host arrays (shuffle, drop-last);
- :func:`prefetch_to_device` — copies the next ``size`` batches to the card
  (from pinned memory, without waiting) while the current step runs, or each
  rank's rows of them on a mesh;
- :func:`epochs` — the composition;
- :func:`process_shard` — this process's slice of a dataset.
"""

from __future__ import annotations

__all__ = [
    "batches",
    "epochs",
    "prefetch_to_device",
    "process_shard",
]

import collections
import itertools
import numpy as np
import torch
import torch.distributed as dist

from collections.abc import Iterable, Iterator
from torch import Tensor

from ..nn.utils import _leaves, _map


def process_shard(data, index: int | None = None, count: int | None = None):
    r"""Returns this process's contiguous shard of a dataset (each process
    feeds its own slice of the global batch).

    Arguments:
        data: Arrays or tensors with a shared leading dimension, alone or in
            a tuple, list or dict.
        index: The process index (defaults to the rank in the default process
            group, or 0 without one).
        count: The process count (defaults to the world size, or 1).
    """

    initialized = dist.is_available() and dist.is_initialized()

    if index is None:
        index = dist.get_rank() if initialized else 0
    if count is None:
        count = dist.get_world_size() if initialized else 1

    n = _leaves(data)[0].shape[0]
    per = n // count

    if per == 0:
        raise ValueError(f"dataset of {n} examples cannot shard over {count} processes")

    return _map(lambda x: x[index * per : (index + 1) * per], data)


def batches(
    data,
    batch_size: int,
    *,
    generator: torch.Generator | None = None,
    drop_last: bool = True,
) -> Iterator:
    r"""Iterates over mini-batches of host arrays.

    Arguments:
        data: Arrays or tensors with a shared leading (example) dimension,
            alone or in a tuple, list or dict.
        batch_size: The batch size.
        generator: An optional generator; when given, examples are shuffled
            by `torch.randperm` (the JAX `key`).
        drop_last: Whether to drop the final ragged batch (keeps shapes
            static).
    """

    n = _leaves(data)[0].shape[0]

    if drop_last and batch_size > n:
        raise ValueError(
            f"batch_size {batch_size} exceeds the dataset size {n}; with "
            "drop_last this would yield no batches"
        )

    if generator is not None:
        perm = torch.randperm(n, generator=generator, device=generator.device).cpu().numpy()
    else:
        perm = np.arange(n)

    stop = n - batch_size + 1 if drop_last else n

    for start in range(0, stop, batch_size):
        idx = perm[start : start + batch_size]
        yield _map(lambda x: x[torch.from_numpy(idx)] if isinstance(x, Tensor) else x[idx], data)


def _put(batch, device: torch.device, mesh):
    r"""`batch` as tensors on `device` (this rank's rows on a mesh), copied
    from pinned host memory without waiting when `device` is a card."""

    batch = _map(lambda x: x if x is None else torch.as_tensor(x), batch)

    if mesh is not None:
        from ..parallel.mesh import shard_batch

        batch = shard_batch(batch, mesh)

    def put(x):
        if x is None:
            return x
        if device.type == "cuda" and x.device.type == "cpu":
            return x.pin_memory().to(device, non_blocking=True)
        return x.to(device)

    return _map(put, batch)


def prefetch_to_device(
    iterator: Iterable,
    size: int = 2,
    device=None,
    mesh=None,
) -> Iterator:
    r"""Stages batches on the card ahead of consumption.

    A copy from pinned host memory with ``non_blocking=True`` returns before
    it is done, so holding a small queue of batches already sent overlaps
    the host-to-card copies with the running step. With a ``mesh``, each
    rank copies only its rows of the batch, split over its `'data'` dim
    (:func:`~azula_tpu_torch.parallel.mesh.shard_batch`).

    Arguments:
        iterator: An iterator of host batches.
        size: The queue depth (2 is enough to hide the copy).
        device: The target device. Defaults to the mesh's device type, else
            the card (`'cuda'`).
        mesh: An optional :class:`~torch.distributed.device_mesh.DeviceMesh`.
    """

    if device is None:
        device = "cuda" if mesh is None else mesh.device_type
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def put(batch):
        return _put(batch, device, mesh)

    it = iter(iterator)

    if size <= 0:  # prefetching disabled: plain staging
        for batch in it:
            yield put(batch)
        return

    queue = collections.deque()
    done = object()  # exhaustion sentinel (None is a valid batch)

    for batch in itertools.islice(it, size):
        queue.append(put(batch))

    while queue:
        yield queue.popleft()

        batch = next(it, done)
        if batch is not done:
            queue.append(put(batch))


def epochs(
    data,
    batch_size: int,
    *,
    generator: torch.Generator,
    num_epochs: int | None = None,
    device=None,
    mesh=None,
    prefetch: int = 2,
) -> Iterator:
    r"""Shuffled, device-prefetched epochs over a host dataset.

    .. code-block:: python

        for batch in epochs(x_train, 256, generator=g, num_epochs=16):
            loss = state.step(batch)

    Arguments:
        data: Host arrays with a shared leading dimension.
        batch_size: The batch size.
        generator: The generator of the per-epoch shuffles: epoch :math:`e`
            shuffles with ``fold_in(generator, e)``
            (:func:`~azula_tpu_torch.parallel.ulysses.fold_in`, the JAX
            `jax.random.fold_in(key, e)`).
        num_epochs: The number of epochs (:py:`None` for an endless stream).
        device: The device of the staged batches (see
            :func:`prefetch_to_device`).
        mesh: An optional mesh, whose `'data'` dim splits each batch.
        prefetch: The device-side queue depth.
    """

    from ..parallel.ulysses import fold_in

    def stream():
        counter = itertools.count() if num_epochs is None else range(num_epochs)
        for epoch in counter:
            yield from batches(data, batch_size, generator=fold_in(generator, epoch))

    return prefetch_to_device(stream(), size=prefetch, device=device, mesh=mesh)
