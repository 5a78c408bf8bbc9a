r"""Tweedie Moment Projected Diffusion (TMPD).

Port of :mod:`azula_tpu.guidance.tmpd`: a diagonal posterior-variance
estimate from a vector-Jacobian product with an all-ones vector.

References:
    | Tweedie Moment Projected Diffusions For Inverse Problems (Boys et al., 2023)
    | https://arxiv.org/abs/2310.06721
"""

from __future__ import annotations

__all__ = [
    "TMPDenoiser",
]

import torch

from collections.abc import Callable
from torch import Tensor

from ..denoise import Denoiser, DiracPosterior
from ..noise import Schedule
from ._common import vjp


class TMPDenoiser(Denoiser):
    r"""Creates a TMPD denoiser module.

    Arguments:
        denoiser: A denoiser :math:`q_\phi(X \mid X_t)`.
        y: An observation :math:`y \sim \mathcal{N}(A x, \Sigma_y)`.
        A: The (linear) forward operator :math:`x \mapsto A x`.
        var_y: The noise variance :math:`\Sigma_y`.
    """

    def __init__(self, denoiser: Denoiser, y: Tensor, A: Callable[[Tensor], Tensor], var_y: float | Tensor) -> None:
        super().__init__()

        self.denoiser = denoiser

        self.y = y
        self.A = A
        self.var_y = var_y

    @property
    def schedule(self) -> Schedule:
        return self.denoiser.schedule

    def forward(self, x_t: Tensor, t: Tensor, **kwargs) -> DiracPosterior:
        alpha_t, sigma_t = self.schedule(t)
        gamma_t = sigma_t**2 / alpha_t

        x_hat, vjp_den = vjp(lambda x: self.denoiser(x, t, **kwargs).mean, x_t, "TMPDenoiser")
        y_hat, At = vjp(self.A, x_hat, "TMPDenoiser")

        var_Ax = self.A(gamma_t * vjp_den(At(torch.ones_like(y_hat))))

        grad = (self.y - y_hat) / (self.var_y + var_Ax)
        grad = gamma_t * vjp_den(At(grad), last=True)

        return DiracPosterior(mean=x_hat + grad)
