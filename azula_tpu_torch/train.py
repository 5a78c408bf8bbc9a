r"""Training utilities.

Port of :mod:`azula_tpu.train`. In PyTorch the training state is the module
itself plus a `torch.optim` optimizer: parameters are updated in place, so
there is no parameter pytree to thread through a jitted step.

:data:`OPTAX_ADAMW` states, in one place, the `torch.optim.AdamW` settings
that compute the update of the JAX package's optimizer, `optax.adamw(1e-4)`:
optax decays the weights by 1e-4 where PyTorch's default is 1e-2; the betas
and eps agree, and both decay every parameter.
"""

from __future__ import annotations

__all__ = [
    "OPTAX_ADAMW",
    "TrainState",
    "ema_update",
    "make_train_step",
]

import torch

from collections.abc import Callable
from torch import Tensor, nn

from .denoise import Denoiser

# `optax.adamw(learning_rate=1e-4)`'s defaults as `torch.optim.AdamW` arguments
OPTAX_ADAMW = dict(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)  # noqa: C408


class TrainState:
    r"""Bundles the training state: the denoiser (its parameters updated in
    place), the optimizer and the number of steps taken.

    Arguments:
        denoiser: The denoiser to train.
        optimizer: A `torch.optim` optimizer over the denoiser's parameters.
    """

    def __init__(self, denoiser: Denoiser, optimizer: torch.optim.Optimizer) -> None:
        self.denoiser = denoiser
        self.optimizer = optimizer
        self.steps = 0

    def step(self, x: Tensor, t: Tensor, generator: torch.Generator | None = None, **kwargs) -> Tensor:
        r"""Takes one denoising score-matching step: the loss, its backward,
        the optimizer's update, and the gradients cleared.

        Arguments:
            x: A clean batch :math:`x`, with shape :math:`(B, *)`.
            t: The times :math:`t`, with shape :math:`(B)`.
            generator: The generator of the loss's perturbation noise.
            kwargs: Optional keyword arguments of the loss (conditioning).

        Returns:
            The loss, detached.
        """

        loss = self.denoiser.loss(x, t, generator=generator, **kwargs)
        loss.backward()

        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.steps += 1

        return loss.detach()


def make_train_step(denoiser: Denoiser, optimizer: torch.optim.Optimizer) -> Callable[..., Tensor]:
    r"""Builds a denoising score-matching train step.

    .. code-block:: python

        optimizer = torch.optim.AdamW(denoiser.parameters(), **OPTAX_ADAMW)
        step = make_train_step(denoiser, optimizer)
        loss = step(x, t, generator)

    Arguments:
        denoiser: The denoiser to train, updated in place.
        optimizer: A `torch.optim` optimizer over its parameters.

    Returns:
        :meth:`TrainState.step` of a new state over both.
    """

    return TrainState(denoiser, optimizer).step


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, rate: float = 0.999) -> None:
    r"""Exponential-moving-average update of a module's parameters, in place:
    :math:`\theta_\mathrm{ema} \gets r \, \theta_\mathrm{ema} + (1 - r) \, \theta`.

    Arguments:
        ema: The averaged copy, updated in place.
        model: The module of the same structure being trained.
        rate: The decay rate :math:`r`.
    """

    for e, p in zip(ema.parameters(), model.parameters(), strict=True):
        e.mul_(rate).add_(p, alpha=1 - rate)
