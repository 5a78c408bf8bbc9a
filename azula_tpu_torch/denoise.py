r"""Denoisers and posteriors.

A denoiser approximates the posterior :math:`p(X \mid X_t)` of the clean
data given a noisy :math:`x_t \sim \mathcal{N}(\alpha_t X, \sigma_t^2 I)`.

Port of :mod:`azula_tpu.denoise` (`broadcast_scales`, `Posterior`,
`GaussianPosterior`, `Denoiser`).
"""

from __future__ import annotations

__all__ = [
    "Denoiser",
    "GaussianPosterior",
    "Posterior",
    "broadcast_scales",
]

import abc
import math
import torch

from torch import Tensor, nn

from .noise import Schedule


def broadcast_scales(alpha_t: Tensor, sigma_t: Tensor, x: Tensor) -> tuple[Tensor, Tensor]:
    r"""Right-pads the scale tensors with singleton axes to broadcast against `x`."""

    alpha_t, sigma_t = torch.as_tensor(alpha_t), torch.as_tensor(sigma_t)

    while alpha_t.ndim < x.ndim:
        alpha_t, sigma_t = alpha_t[..., None], sigma_t[..., None]

    return alpha_t, sigma_t


class Posterior(abc.ABC):
    r"""Abstract posterior :math:`q_\phi(X \mid x_t)`."""

    mean: Tensor


class GaussianPosterior(Posterior):
    r"""Creates a Gaussian posterior :math:`\mathcal{N}(X \mid \mu, \sigma^2)`."""

    def __init__(self, mean: Tensor, var: Tensor) -> None:
        self.mean = mean
        self.var = var

    def log_prob(self, x: Tensor) -> Tensor:
        r"""Returns the log-density :math:`\log \mathcal{N}(x \mid \mu, \sigma^2)`."""

        return -((x - self.mean) ** 2 / self.var + torch.log(self.var) + math.log(2 * math.pi)) / 2


class Denoiser(nn.Module, abc.ABC):
    r"""Abstract denoiser module."""

    schedule: Schedule

    @abc.abstractmethod
    def forward(self, x_t: Tensor, t: Tensor, **kwargs) -> Posterior:
        r"""
        Arguments:
            x_t: A noisy tensor :math:`x_t`, with shape :math:`(B, *)`.
            t: The time :math:`t`, with shape :math:`()` or :math:`(B)`.
            kwargs: Optional keyword arguments (conditioning).

        Returns:
            The posterior :math:`q_\phi(X \mid x_t)`.
        """

        pass
