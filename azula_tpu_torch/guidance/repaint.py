r"""RePaint.

Port of :mod:`azula_tpu.guidance.repaint`. Each resampling iteration draws
three normals in the JAX package's order: the DDIM step's, the observation's
and the re-noising's.

References:
    | RePaint: Inpainting using Denoising Diffusion Probabilistic Models (Lugmayr et al., 2022)
    | https://arxiv.org/abs/2201.09865
"""

from __future__ import annotations

__all__ = [
    "RePaintSampler",
]

import torch

from torch import Tensor

from ..denoise import Denoiser
from ..sample import DDIMSampler


class RePaintSampler(DDIMSampler):
    r"""Creates a RePaint inpainting sampler.

    Arguments:
        denoiser: A denoiser :math:`q_\phi(X \mid X_t)`.
        y: An observation :math:`y = m \odot x`.
        mask: The observation mask :math:`m` (boolean).
        iterations: The number of RePaint resampling iterations per step.
        kwargs: Keyword arguments passed to :class:`azula_tpu_torch.sample.DDIMSampler`.
    """

    def __init__(self, denoiser: Denoiser, y: Tensor, mask: Tensor, iterations: int = 3, **kwargs) -> None:
        super().__init__(denoiser, **kwargs)

        self.y = y
        self.mask = mask
        self.iterations = iterations

    @property
    def requires_generator(self) -> bool:
        return True

    def step(self, x_t, t, s, generator=None, **kwargs):
        alpha_s, sigma_s = self.denoiser.schedule(s)
        alpha_t, sigma_t = self.denoiser.schedule(t)

        x_s = x_t

        for _ in range(self.iterations):
            x_s = super().step(x_t, t, s, generator=generator, **kwargs)
            x_s = torch.where(
                self.mask,
                alpha_s * self.y + sigma_s * self._normal(generator, self.y.shape, x_s),
                x_s,
            )

            x_t = alpha_t / alpha_s * x_s + alpha_t * torch.sqrt(
                (sigma_t / alpha_t) ** 2 - (sigma_s / alpha_s) ** 2
            ) * self._normal(generator, x_s.shape, x_s)

        return x_s
