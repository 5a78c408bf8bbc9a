r"""Moment Matching Posterior Sampling (MMPS).

Port of :mod:`azula_tpu.guidance.mmps`: the denoiser's Jacobian (a
vector-Jacobian product of :math:`\hat{x}` against :math:`x_t`) defines the
action of :math:`\Sigma_x`; each solver iteration takes one product through
the whole backbone, and one more follows the solve.

References:
    | Learning Diffusion Priors from Observations by Expectation Maximization (Rozet et al., 2024)
    | https://arxiv.org/abs/2405.13712
"""

from __future__ import annotations

__all__ = [
    "MMPSDenoiser",
]

from collections.abc import Callable
from torch import Tensor
from typing import Literal

from ..denoise import Denoiser, DiracPosterior
from ..linalg.covariance import Covariance
from ..noise import Schedule
from ._common import jvp, make_solver, vjp


class MMPSDenoiser(Denoiser):
    r"""Creates a MMPS denoiser module.

    Arguments:
        denoiser: A denoiser :math:`q_\phi(X \mid X_t)`.
        y: An observation :math:`y \sim \mathcal{N}(A(x), \Sigma_y)`, with shape :math:`(*, D)`.
        A: The forward operator :math:`x \mapsto A(x)`.
        cov_y: The noise covariance :math:`\Sigma_y`.
        solver: The linear solver name (`'cg'` or `'gmres'`).
        iterations: The number of solver iterations.
    """

    def __init__(
        self,
        denoiser: Denoiser,
        y: Tensor,
        A: Callable[[Tensor], Tensor],
        cov_y: Covariance,
        solver: Literal["cg", "gmres"] = "gmres",
        iterations: int = 1,
    ) -> None:
        super().__init__()

        self.denoiser = denoiser

        self.y = y
        self.A = A
        self.cov_y = cov_y
        self.solve = make_solver(solver, iterations)

    @property
    def schedule(self) -> Schedule:
        return self.denoiser.schedule

    def forward(self, x_t: Tensor, t: Tensor, **kwargs) -> DiracPosterior:
        alpha_t, sigma_t = self.schedule(t)
        gamma_t = sigma_t**2 / alpha_t

        x_hat, vjp_den = vjp(lambda x: self.denoiser(x, t, **kwargs).mean, x_t, "MMPSDenoiser")
        y_hat, vjp_A = vjp(self.A, x_hat, "MMPSDenoiser")

        def cov_x(v):
            return gamma_t * vjp_den(v)

        def cov_y(v):
            return self.cov_y(v) + jvp(self.A, x_hat, cov_x(vjp_A(v)))

        grad = self.y - y_hat
        grad = self.solve(A=cov_y, b=grad)
        grad = gamma_t * vjp_den(vjp_A(grad), last=True)

        return DiracPosterior(mean=x_hat + grad)
