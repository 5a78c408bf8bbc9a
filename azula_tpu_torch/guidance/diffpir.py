r"""Diffusion Plug-and-Play Image Restoration (DiffPIR).

Port of :mod:`azula_tpu.guidance.diffpir`.

References:
    | Denoising Diffusion Models for Plug-and-Play Image Restoration (Zhu et al., 2023)
    | https://arxiv.org/abs/2305.08995
"""

from __future__ import annotations

__all__ = [
    "DiffPIRDenoiser",
]

from collections.abc import Callable
from torch import Tensor
from typing import Literal

from ..denoise import Denoiser, DiracPosterior
from ..noise import Schedule
from ._common import make_solver, vjp


class DiffPIRDenoiser(Denoiser):
    r"""Creates a DiffPIR denoiser module: a proximal data-fit solve
    :math:`(A^\top \Sigma_y^{-1} A + \lambda / \rho_t)^{-1}` around the inner
    denoiser's mean.

    Arguments:
        denoiser: A denoiser :math:`q_\phi(X \mid X_t)`.
        y: An observation :math:`y \sim \mathcal{N}(A x, \Sigma_y)`, with shape :math:`(*, D)`.
        A: The (linear) forward operator :math:`x \mapsto A x`.
        var_y: The noise variance :math:`\Sigma_y`.
        lmbda: The regularization strength :math:`\lambda \in \mathbb{R}_+`.
        solver: The linear solver name (`'cg'` or `'gmres'`).
        iterations: The number of solver iterations.
    """

    def __init__(
        self,
        denoiser: Denoiser,
        y: Tensor,
        A: Callable[[Tensor], Tensor],
        var_y: float | Tensor,
        lmbda: float = 10.0,
        solver: Literal["cg", "gmres"] = "gmres",
        iterations: int = 1,
    ) -> None:
        super().__init__()

        self.denoiser = denoiser

        self.y = y
        self.A = A
        self.var_y = var_y
        self.lmbda = lmbda
        self.solve = make_solver(solver, iterations)

    @property
    def schedule(self) -> Schedule:
        return self.denoiser.schedule

    def forward(self, x_t: Tensor, t: Tensor, **kwargs) -> DiracPosterior:
        alpha_t, sigma_t = self.schedule(t)
        rho_t = (sigma_t / alpha_t) ** 2

        q = self.denoiser(x_t, t, **kwargs)
        x_hat = q.mean.detach()

        y_hat, At = vjp(self.A, x_hat, "DiffPIRDenoiser")

        def AtA_I(v):
            return At(self.A(v) / self.var_y) + self.lmbda * v / rho_t

        grad = (self.y - y_hat) / self.var_y
        grad = At(grad)
        grad = self.solve(A=AtA_I, b=grad)

        return DiracPosterior(mean=x_hat + grad)
