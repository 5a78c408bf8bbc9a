r"""Data-parallel sampling and training.

Port of :mod:`azula_tpu.parallel.batch`, with the data-parallel train step
that JAX gets from :func:`azula_tpu.train.make_train_step` under a sharded
batch. Every rank draws the whole batch's noise from one seeded generator,
as JAX draws it before sharding, and keeps its own rows: the ranks together
compute what one rank computes on the whole batch.
"""

from __future__ import annotations

__all__ = [
    "ShardedTrainState",
    "average_gradients",
    "make_train_step_sharded",
    "sample_sharded",
]

import torch
import torch.distributed as dist

from collections.abc import Callable, Sequence
from torch import Tensor, nn
from torch.distributed.device_mesh import DeviceMesh

from ..train import TrainState
from .mesh import get_mesh, shard_batch


def sample_sharded(
    sampler,
    shape: Sequence[int],
    generator: torch.Generator | None = None,
    mesh: DeviceMesh | None = None,
    mean: float | Tensor = 0.0,
    var: float | Tensor = 1.0,
    dtype: torch.dtype = torch.float32,
    **kwargs,
) -> Tensor:
    r"""Draws a batch of samples with the batch axis split over `'data'`.

    Every rank draws the whole initial noise :math:`x_1` from `generator`
    and samples its own rows; gathered (:func:`~azula_tpu_torch.parallel.mesh.gather_batch`),
    the rows are `sampler(x1)`. Batched conditioning (a tensor whose leading
    axis is :math:`B`) is split alongside; the rest is replicated.

    Arguments:
        sampler: A :class:`azula_tpu_torch.sample.Sampler`.
        shape: The batch shape :math:`(B, *)`; :math:`B` divides by the
            `'data'` size.
        generator: The generator of the initial noise, seeded alike on every
            rank, on the card unless the caller asks for the CPU. A
            stochastic sampler's reverse process draws each rank's rows from
            it as well: the same distribution as one rank's, not its draws.
        mesh: The mesh. Defaults to :func:`~azula_tpu_torch.parallel.mesh.get_mesh`.
        mean, var, dtype: Forwarded to `sampler.init`.
        kwargs: Conditioning forwarded to the denoiser at every step.

    Returns:
        This rank's rows of the samples, with shape :math:`(B / n, *)`.
    """

    if mesh is None:
        mesh = get_mesh()

    x1 = sampler.init(shape, mean=mean, var=var, dtype=dtype, generator=generator)
    x1 = shard_batch(x1, mesh)

    def place(leaf):
        if isinstance(leaf, Tensor) and leaf.ndim >= 1 and leaf.shape[0] == shape[0]:
            return shard_batch(leaf, mesh)
        return leaf

    kwargs = {k: place(v) for k, v in kwargs.items()}

    return sampler(x1, generator=generator if sampler.requires_generator else None, **kwargs)


def average_gradients(module: nn.Module, group: dist.ProcessGroup) -> None:
    r"""Averages the gradients of `module`'s parameters over `group`, in one
    all-reduce, as DDP does. Parameters that FSDP splits over this group
    (:func:`~azula_tpu_torch.parallel.tp.shard_module_fsdp`) are left as
    they are: their gather's backward has averaged them already."""

    grads = [
        p.grad for p in module.parameters()
        if p.grad is not None and getattr(p, "fsdp_group", None) is not group
    ]
    if not grads or dist.get_world_size(group) == 1:
        return

    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)

    for g, part in zip(grads, flat.split([g.numel() for g in grads]), strict=True):
        g.copy_(part.view_as(g))


class ShardedTrainState(TrainState):
    r"""The training state of data-parallel training over the `'data'` dim:
    each rank takes its rows of the batch, and the gradients are averaged
    across ranks before the optimizer's update (:func:`average_gradients`).

    Each rank passes the whole batch and draws the whole batch's noise from
    the generator, so that after each step the parameters are those of one
    rank training on the whole batch (up to the order of float sums).

    Arguments:
        denoiser: The denoiser to train, updated in place on every rank.
        optimizer: A `torch.optim` optimizer over its parameters.
        mesh: The mesh. Defaults to :func:`~azula_tpu_torch.parallel.mesh.get_mesh`.
    """

    def __init__(self, denoiser, optimizer: torch.optim.Optimizer, mesh: DeviceMesh | None = None) -> None:
        super().__init__(denoiser, optimizer)

        self.mesh = get_mesh() if mesh is None else mesh
        self.group = self.mesh.get_group("data")

    def _normal(self, generator: torch.Generator | None, like: Tensor) -> Tensor:
        return torch.randn(like.shape, dtype=like.dtype, device=like.device, generator=generator)

    def step(self, x: Tensor, t: Tensor, generator: torch.Generator | None = None, **kwargs) -> Tensor:
        r"""Takes one step on this rank's rows of the batch.

        Arguments:
            x: The whole clean batch :math:`x`, with shape :math:`(B, *)`.
            t: The whole batch's times, with shape :math:`(B)`.
            generator: The generator of the perturbation noise, seeded alike
                on every rank.
            kwargs: Conditioning; batched tensors are split like `x`.

        Returns:
            The loss of the whole batch, detached.
        """

        B = x.shape[0]
        z = self._normal(generator, x)
        x, t, z = shard_batch((x, t, z), self.mesh)
        kwargs = {
            k: shard_batch(v, self.mesh) if isinstance(v, Tensor) and v.ndim and v.shape[0] == B else v
            for k, v in kwargs.items()
        }

        loss = self.denoiser._loss(x, t, z, **kwargs)
        loss.backward()
        average_gradients(self.denoiser, self.group)

        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.steps += 1

        loss = loss.detach().clone()
        dist.all_reduce(loss, group=self.group)

        return loss / dist.get_world_size(self.group)


def make_train_step_sharded(
    denoiser, optimizer: torch.optim.Optimizer, mesh: DeviceMesh | None = None
) -> Callable[..., Tensor]:
    r"""Builds a data-parallel denoising score-matching train step:
    :meth:`ShardedTrainState.step` of a new state.

    .. code-block:: python

        optimizer = torch.optim.AdamW(denoiser.parameters(), **OPTAX_ADAMW)
        step = make_train_step_sharded(denoiser, optimizer, make_mesh())
        loss = step(x, t, generator)  # the whole batch on every rank
    """

    return ShardedTrainState(denoiser, optimizer, mesh).step
