r"""Pseudo-inverse Guided Diffusion Model (PGDM).

Port of :mod:`azula_tpu.guidance.pgdm`: the correction is a vector-Jacobian
product through the denoiser.

References:
    | Pseudoinverse-Guided Diffusion Models for Inverse Problems (Song et al., 2023)
    | https://openreview.net/forum?id=9_gsMA8MRKQ
"""

from __future__ import annotations

__all__ = [
    "PGDMSampler",
]

import torch

from collections.abc import Callable
from torch import Tensor

from ..denoise import Denoiser
from ..sample import DDIMSampler
from ._common import vjp


class PGDMSampler(DDIMSampler):
    r"""Creates a PGDM sampler.

    Arguments:
        denoiser: A denoiser :math:`q_\phi(X \mid X_t)`.
        y: An observation :math:`y \sim \mathcal{N}(A(x), \Sigma_y)`.
        A: The forward operator :math:`x \mapsto A(x)`.
        A_inv: The pseudo-inverse operator :math:`y \mapsto A^\dagger(y)`.
        kwargs: Keyword arguments passed to :class:`azula_tpu_torch.sample.DDIMSampler`.
    """

    def __init__(
        self,
        denoiser: Denoiser,
        y: Tensor,
        A: Callable[[Tensor], Tensor],
        A_inv: Callable[[Tensor], Tensor],
        **kwargs,
    ) -> None:
        super().__init__(denoiser, **kwargs)

        self.y = y
        self.A = A
        self.A_inv = A_inv

    def step(self, x_t, t, s, generator=None, **kwargs):
        alpha_s, sigma_s = self.denoiser.schedule(s)
        alpha_t, sigma_t = self.denoiser.schedule(t)

        tau = 1 - (alpha_t / alpha_s * sigma_s / sigma_t) ** 2
        tau = torch.clip(self.eta * tau, min=0, max=1)
        eps = self._noise(generator, x_t)

        x_hat, pullback = vjp(lambda x: self.denoiser(x, t, **kwargs).mean, x_t, "PGDMSampler")

        # DDIM transition
        x_s = alpha_s * x_hat
        x_s = x_s + sigma_s * torch.sqrt(1 - tau) / sigma_t * (x_t - alpha_t * x_hat)
        x_s = x_s + sigma_s * torch.sqrt(tau) * eps

        # PiGDM correction
        grad = self.A_inv(self.y) - self.A_inv(self.A(x_hat))
        grad = pullback(grad, last=True)

        return x_s + alpha_s * alpha_t * grad
