r"""Twisted Diffusion Sampling (TDS).

Port of :mod:`azula_tpu.guidance.tds`: a twisted sequential Monte Carlo
sampler whose log-weights ride along the trajectory, with adaptive
multinomial resampling (only when the effective sample size falls below a
threshold). Resampling stays on the device: both branches are computed and
one is selected by `torch.where`, so no step waits for the card.

References:
    | Practical and Asymptotically Exact Conditional Sampling in Diffusion Models (Wu et al., 2023)
    | https://arxiv.org/abs/2306.17775
"""

from __future__ import annotations

__all__ = [
    "TDSSampler",
]

import math
import torch

from collections.abc import Callable
from torch import Tensor

from ..denoise import Denoiser
from ..sample import Sampler
from ..utils.profiling import annotate
from ._common import require_autograd


def _normal_log_prob(x: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    return -(((x - loc) / scale) ** 2 + torch.log(scale**2) + math.log(2 * math.pi)) / 2


def _log_ess(log_w: Tensor) -> Tensor:
    r"""Effective sample size :math:`(\sum_k w_k)^2 / \sum_k w_k^2` in log space."""

    return 2 * torch.logsumexp(log_w, dim=0) - torch.logsumexp(2 * log_w, dim=0)


class TDSSampler(Sampler):
    r"""Creates a TDS (twisted sequential Monte Carlo) sampler.

    Arguments:
        denoiser: A denoiser :math:`q_\phi(X \mid X_t)`.
        twist: A twisting function :math:`\log p(y \mid \hat{x}, t)` taking
            :math:`(\hat{x}, \sigma_t / \alpha_t)`.
        resample_threshold: Resample when the effective sample size falls
            below this fraction of the particle count. `1.0` resamples every
            step; `0.0` never.
        return_weights: If :py:`True`, calling the sampler returns
            `(particles, log_weights)` instead of the bare particles.
        kwargs: Keyword arguments passed to :class:`azula_tpu_torch.sample.Sampler`.
    """

    def __init__(
        self,
        denoiser: Denoiser,
        twist: Callable[[Tensor, Tensor], Tensor],
        resample_threshold: float = 0.5,
        return_weights: bool = False,
        **kwargs,
    ) -> None:
        super().__init__(**kwargs)

        self.denoiser = denoiser
        self.twist = twist
        self.resample_threshold = resample_threshold
        self.return_weights = return_weights

    @property
    def requires_generator(self) -> bool:
        return True

    def _resample(self, log_w: Tensor, generator: torch.Generator | None) -> Tensor:
        r"""K ancestor indices drawn from the weights :math:`\mathrm{softmax}(\log w)`
        (the JAX package's `jax.random.categorical`)."""

        p = torch.softmax(log_w.float(), dim=0)

        return torch.multinomial(p, log_w.shape[0], replacement=True, generator=generator)

    def _trajectory(self, x: Tensor, generator: torch.Generator | None, **kwargs):
        r"""Runs the particle system. `x` holds :math:`K` particles with shape
        :math:`(K, *)`."""

        require_autograd("TDSSampler")

        time = self._time(x)
        K = x.shape[0]
        ancestors = torch.arange(K, device=x.device)
        threshold = math.log(self.resample_threshold * K) if self.resample_threshold > 0 else -math.inf
        tracker = self._tracker()

        log_w = torch.zeros(K, dtype=x.dtype, device=x.device)

        for i in range(self.steps):
            with annotate("azula.sample.step"):
                t, s = time[i], time[i + 1]

                alpha_s, sigma_s = self.denoiser.schedule(s)
                alpha_t, sigma_t = self.denoiser.schedule(t)

                # the twisted score through the denoiser
                with torch.enable_grad():
                    x_t = x.detach().requires_grad_()
                    x_hat = self.denoiser(x_t, t, **kwargs).mean
                    log_p_y = self.twist(x_hat, sigma_t / alpha_t)
                    (score_y,) = torch.autograd.grad(log_p_y.sum(), x_t)
                x_hat, log_p_y = x_hat.detach(), log_p_y.detach()

                # the twist factor at the current time joins the weights
                log_p_y = log_p_y.reshape(K, -1).sum(dim=-1)
                log_w = log_p_y + log_w

                # adaptive resampling, both branches on the device
                resample = _log_ess(log_w) < threshold
                idx = torch.where(resample, self._resample(log_w, generator), ancestors)
                x, x_hat, log_p_y, score_y = x[idx], x_hat[idx], log_p_y[idx], score_y[idx]
                log_w = torch.where(resample, torch.zeros_like(log_w), log_w[idx])

                # the proposal: a DDPM transition, twisted
                def ddpm_loc_scale(mean):
                    eps = (x - alpha_t * mean) / sigma_t
                    tau = (alpha_t / alpha_s * sigma_s / sigma_t) ** 2
                    return alpha_s * mean + sigma_s * torch.sqrt(tau) * eps, sigma_s * torch.sqrt(1 - tau)

                # no twist on the last transition, whose scale collapses to
                # sigma_min (as in the JAX package)
                shift = sigma_t**2 / alpha_t if i < self.steps - 1 else torch.zeros_like(sigma_t)

                loc, scale = ddpm_loc_scale(x_hat)
                loc_y, scale_y = ddpm_loc_scale(x_hat + shift * score_y)

                x_s = loc_y + scale_y * self._normal(generator, x.shape, x)

                # the incremental weight q(x_s | x_t) / [q_y(x_s | x_t) p(y | x_t)]
                log_q_xs = _normal_log_prob(x_s, loc, scale).reshape(K, -1).sum(dim=-1)
                log_q_xs_y = _normal_log_prob(x_s, loc_y, scale_y).reshape(K, -1).sum(dim=-1)

                log_w = log_w + log_q_xs - log_q_xs_y - log_p_y
                x = x_s

            if tracker is not None:
                tracker(i, x)

        if self.return_weights:
            # the terminal twist factor completes the weights
            alpha_0, sigma_0 = self.denoiser.schedule(time[-1])
            x_hat = self.denoiser(x, time[-1], **kwargs).mean
            log_p_y = self.twist(x_hat, sigma_0 / alpha_0)
            log_w = log_w + log_p_y.reshape(K, -1).sum(dim=-1)

            return x, log_w

        return x
