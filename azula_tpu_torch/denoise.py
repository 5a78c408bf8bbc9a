r"""Denoisers and posteriors.

A denoiser approximates the posterior :math:`p(X \mid X_t)` of the clean
data given a noisy :math:`x_t \sim \mathcal{N}(\alpha_t X, \sigma_t^2 I)`.

Port of :mod:`azula_tpu.denoise` (`broadcast_scales`, `Posterior`,
`DiracPosterior`, `GaussianPosterior`, `Denoiser`, `SimpleDenoiser`,
`KarrasDenoiser`, with their training losses).

The losses draw the perturbation noise from a `torch.Generator` where JAX
takes a key; the two never give the same numbers, so the noise is drawn in
one line and the rest of each loss is a private method that takes it.
"""

from __future__ import annotations

__all__ = [
    "Denoiser",
    "DiracPosterior",
    "GaussianPosterior",
    "KarrasDenoiser",
    "Posterior",
    "SimpleDenoiser",
    "broadcast_scales",
    "time_scales",
]

import abc
import math
import torch

from torch import Tensor, nn

from .nn.utils import get_module_dtype
from .noise import Schedule


def broadcast_scales(alpha_t: Tensor, sigma_t: Tensor, x: Tensor) -> tuple[Tensor, Tensor]:
    r"""Right-pads the scale tensors with singleton axes to broadcast against `x`."""

    alpha_t, sigma_t = torch.as_tensor(alpha_t), torch.as_tensor(sigma_t)

    while alpha_t.ndim < x.ndim:
        alpha_t, sigma_t = alpha_t[..., None], sigma_t[..., None]

    return alpha_t, sigma_t


def time_scales(schedule: Schedule, t: Tensor | float, x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    r"""The time `t` as a tensor on `x`'s device and the scales
    :math:`\alpha_t, \sigma_t` of `schedule` at it, typed as JAX types them.

    An array `t` (a tensor, a NumPy array or scalar, a list) keeps its own
    dtype and its scales are padded to broadcast against `x`
    (`broadcast_scales`), so that the coefficients computed from them promote
    against `x` as JAX's arrays do: a float32 `t` with a bf16 `x` gives
    float32. A Python `int` or `float`, weakly typed in JAX, is computed in
    float32 and its scales stay 0-d, so that the coefficients take `x`'s
    dtype where they meet `x`, as JAX's weakly typed scalars do.
    """

    # NumPy's float64 scalar is a Python float, but JAX types it strongly
    if isinstance(t, (int, float)) and not hasattr(t, "dtype"):
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        return t, *schedule(t)

    t = torch.as_tensor(t, device=x.device)
    return t, *broadcast_scales(*schedule(t), x)


class Posterior(abc.ABC):
    r"""Abstract posterior :math:`q_\phi(X \mid x_t)`."""

    mean: Tensor


class DiracPosterior(Posterior):
    r"""Creates a Dirac delta posterior :math:`\delta(X - \mu)`."""

    def __init__(self, mean: Tensor) -> None:
        self.mean = mean


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


class SimpleDenoiser(Denoiser):
    r"""Creates a denoiser with simple (:math:`x`-prediction) preconditioning.

    .. math:: \mu_\phi(x_t) = b_\phi(c_\mathrm{in}(t) \, x_t, c_\mathrm{time}(t))

    with :math:`c_\mathrm{in} = 1/\sqrt{\alpha_t^2 + \sigma_t^2}` and
    :math:`c_\mathrm{time} = \log(\sigma_t / \alpha_t)`. The backbone runs in
    its own dtype (`get_module_dtype`).

    Arguments:
        backbone: A noise/time conditional network :math:`b_\phi(x_t, t)`.
        schedule: A noise schedule.
    """

    def __init__(self, backbone: nn.Module, schedule: Schedule) -> None:
        super().__init__()

        self.backbone = backbone
        self.schedule = schedule

    def forward(self, x_t: Tensor, t: Tensor, **kwargs) -> DiracPosterior:
        t, alpha_t, sigma_t = time_scales(self.schedule, t, x_t)

        c_in = torch.rsqrt(alpha_t**2 + sigma_t**2)
        c_time = torch.log(sigma_t / alpha_t).reshape(t.shape)

        dtype = get_module_dtype(self.backbone)

        output = self.backbone((c_in * x_t).to(dtype), c_time.to(dtype), **kwargs).to(x_t.dtype)

        return DiracPosterior(mean=output)

    def loss(
        self,
        x: Tensor,
        t: Tensor,
        generator: torch.Generator | None = None,
        max_weight: float = 1e4,
        **kwargs,
    ) -> Tensor:
        r"""Returns the weighted denoising score-matching loss

        .. math:: \frac{\alpha_t^2 + \sigma_t^2}{\sigma_t^2} || \mu_\phi(x_t) - x ||^2

        with the weight clipped at `max_weight`.

        Arguments:
            x: A clean tensor :math:`x`, with shape :math:`(B, *)`.
            t: The time :math:`t`, with shape :math:`(B)`.
            generator: The generator of the perturbation noise (the JAX `key`).
            max_weight: The largest weight.
            kwargs: Optional keyword arguments (conditioning).
        """

        z = torch.randn(x.shape, dtype=x.dtype, device=x.device, generator=generator)

        return self._loss(x, t, z, max_weight, **kwargs)

    def _loss(self, x: Tensor, t: Tensor, z: Tensor, max_weight: float = 1e4, **kwargs) -> Tensor:
        alpha_t, sigma_t = broadcast_scales(*self.schedule(t), x)

        x_t = alpha_t * x + sigma_t * z
        q = self(x_t, t, **kwargs)

        w_t = torch.clamp((alpha_t / sigma_t) ** 2 + 1, max=max_weight)

        return torch.mean(w_t * torch.square(q.mean - x))


class KarrasDenoiser(Denoiser):
    r"""Creates a Gaussian denoiser with EDM-style preconditioning.

    .. math:: \mu_\phi(x_t) = c_\mathrm{skip}(t) \, x_t +
        c_\mathrm{out}(t) \, b_\phi(c_\mathrm{in}(t) \, x_t, c_\mathrm{time}(t))

    with scale-generalized coefficients

    .. math::
        c_\mathrm{in} = \frac{1}{\sqrt{\alpha_t^2 + \sigma_t^2}}, \quad
        c_\mathrm{out} = \frac{\sigma_t}{\sqrt{\alpha_t^2 + \sigma_t^2}}, \quad
        c_\mathrm{skip} = \frac{\alpha_t}{\alpha_t^2 + \sigma_t^2}, \quad
        c_\mathrm{time} = \log \frac{\sigma_t}{\alpha_t}

    The backbone runs in its own dtype (`get_module_dtype`); the
    preconditioning runs in the dtype of `t` and promotes against
    :math:`x_t` (`time_scales`).

    References:
        | Elucidating the Design Space of Diffusion-Based Generative Models (Karras et al., 2022)
        | https://arxiv.org/abs/2206.00364

    Arguments:
        backbone: A noise/time conditional network :math:`b_\phi(x_t, t)`.
        schedule: A noise schedule.
    """

    def __init__(self, backbone: nn.Module, schedule: Schedule) -> None:
        super().__init__()

        self.backbone = backbone
        self.schedule = schedule

    def forward(self, x_t: Tensor, t: Tensor, **kwargs) -> DiracPosterior:
        t, alpha_t, sigma_t = time_scales(self.schedule, t, x_t)

        c_in = torch.rsqrt(alpha_t**2 + sigma_t**2)
        c_out = sigma_t * torch.rsqrt(alpha_t**2 + sigma_t**2)
        c_skip = alpha_t / (alpha_t**2 + sigma_t**2)
        c_time = torch.log(sigma_t / alpha_t).reshape(t.shape)

        dtype = get_module_dtype(self.backbone)

        output = self.backbone((c_in * x_t).to(dtype), c_time.to(dtype), **kwargs).to(x_t.dtype)

        return DiracPosterior(mean=c_skip * x_t + c_out * output)

    def loss(self, x: Tensor, t: Tensor, generator: torch.Generator | None = None, **kwargs) -> Tensor:
        r"""Returns the weighted denoising score-matching loss

        .. math:: \frac{\alpha_t^2 + \sigma_t^2}{\sigma_t^2} || \mu_\phi(x_t) - x ||^2

        Arguments:
            x: A clean tensor :math:`x`, with shape :math:`(B, *)`.
            t: The time :math:`t`, with shape :math:`(B)`.
            generator: The generator of the perturbation noise (the JAX `key`).
            kwargs: Optional keyword arguments (conditioning).
        """

        z = torch.randn(x.shape, dtype=x.dtype, device=x.device, generator=generator)

        return self._loss(x, t, z, **kwargs)

    def _loss(self, x: Tensor, t: Tensor, z: Tensor, **kwargs) -> Tensor:
        alpha_t, sigma_t = broadcast_scales(*self.schedule(t), x)

        x_t = alpha_t * x + sigma_t * z
        q = self(x_t, t, **kwargs)

        w_t = (alpha_t / sigma_t) ** 2 + 1

        return torch.mean(w_t * torch.square(q.mean - x))
