r"""Jacobian-Free Posterior Sampling (JFPS).

Port of :mod:`azula_tpu.guidance.jfps`: the covariance algebra
:math:`(\Sigma_x^{-1} + \Sigma_t^{-1})^{-1}`, products through the forward
operator and a solve in observation space.
"""

from __future__ import annotations

__all__ = [
    "JFPSDenoiser",
]

from collections.abc import Callable
from torch import Tensor
from typing import Literal

from ..denoise import Denoiser, DiracPosterior
from ..linalg.covariance import Covariance, IsotropicCovariance
from ..noise import Schedule
from ._common import jvp, make_solver, vjp


class JFPSDenoiser(Denoiser):
    r"""Creates a JFPS denoiser module.

    Arguments:
        denoiser: A denoiser :math:`q_\phi(X \mid X_t)`.
        y: An observation :math:`y \sim \mathcal{N}(A(x), \Sigma_y)`, with shape :math:`(*, D)`.
        A: The forward operator :math:`x \mapsto A(x)`.
        cov_y: The noise covariance :math:`\Sigma_y`.
        cov_x: The signal covariance :math:`\Sigma_x`.
        solver: The linear solver name (`'cg'` or `'gmres'`).
        iterations: The number of solver iterations.
    """

    def __init__(
        self,
        denoiser: Denoiser,
        y: Tensor,
        A: Callable[[Tensor], Tensor],
        cov_y: Covariance,
        cov_x: Covariance,
        solver: Literal["cg", "gmres"] = "cg",
        iterations: int = 1,
    ) -> None:
        super().__init__()

        self.denoiser = denoiser

        self.y = y
        self.A = A
        self.cov_y = cov_y
        self.cov_x = cov_x
        self.solve = make_solver(solver, iterations)

    @property
    def schedule(self) -> Schedule:
        return self.denoiser.schedule

    def forward(self, x_t: Tensor, t: Tensor, **kwargs) -> DiracPosterior:
        alpha_t, sigma_t = self.schedule(t)

        q = self.denoiser(x_t, t, **kwargs)
        x_hat = q.mean.detach()

        y_hat, At = vjp(self.A, x_hat, "JFPSDenoiser")

        cov_t = IsotropicCovariance(sigma_t**2 / alpha_t**2)
        cov_x = (self.cov_x.inv + cov_t.inv).inv

        def cov_y(v):
            return self.cov_y(v) + jvp(self.A, x_hat, cov_x(At(v)))

        grad = self.y - y_hat
        grad = self.solve(A=cov_y, b=grad)
        grad = At(grad)
        grad = cov_x(grad)

        return DiracPosterior(mean=x_hat + grad)
