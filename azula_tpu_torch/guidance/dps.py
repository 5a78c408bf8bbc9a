r"""Diffusion Posterior Sampling (DPS).

Port of :mod:`azula_tpu.guidance.dps`: the gradient of the data-fit norm
through the denoiser, taken in an autograd island.

References:
    | Diffusion Posterior Sampling for General Noisy Inverse Problems (Chung et al., 2022)
    | https://arxiv.org/abs/2209.14687
"""

from __future__ import annotations

__all__ = [
    "DPSSampler",
]

import torch

from collections.abc import Callable
from torch import Tensor

from ..denoise import Denoiser
from ..sample import DDPMSampler
from ._common import require_autograd


class DPSSampler(DDPMSampler):
    r"""Creates a DPS sampler.

    Arguments:
        denoiser: A denoiser :math:`q_\phi(X \mid X_t)`.
        y: An observation :math:`y \sim \mathcal{N}(A(x), \Sigma_y)`.
        A: The forward operator :math:`x \mapsto A(x)`.
        zeta: The guidance strength :math:`\zeta`.
        kwargs: Keyword arguments passed to :class:`azula_tpu_torch.sample.DDPMSampler`.
    """

    def __init__(
        self,
        denoiser: Denoiser,
        y: Tensor,
        A: Callable[[Tensor], Tensor],
        zeta: float = 1.0,
        **kwargs,
    ) -> None:
        super().__init__(denoiser, **kwargs)

        self.y = y
        self.A = A
        self.zeta = zeta

    def step(self, x_t, t, s, generator=None, **kwargs):
        alpha_s, sigma_s = self.denoiser.schedule(s)
        alpha_t, sigma_t = self.denoiser.schedule(t)

        tau = 1 - (alpha_t / alpha_s * sigma_s / sigma_t) ** 2
        eps = self._noise(generator, x_t)

        require_autograd("DPSSampler")
        with torch.enable_grad():
            x = x_t.detach().requires_grad_()
            x_hat = self.denoiser(x, t, **kwargs).mean
            error = self.y - self.A(x_hat)
            (grad,) = torch.autograd.grad(torch.linalg.vector_norm(error.reshape(-1)), x)
        x_hat = x_hat.detach()

        # DDPM transition
        x_s = alpha_s * x_hat
        x_s = x_s + sigma_s * torch.sqrt(1 - tau) / sigma_t * (x_t - alpha_t * x_hat)
        x_s = x_s + sigma_s * torch.sqrt(tau) * eps

        # DPS correction
        return x_s - self.zeta * grad
