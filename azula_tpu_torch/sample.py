r"""Reverse diffusion samplers.

Port of :mod:`azula_tpu.sample` (the `Sampler` base and `DDIMSampler`). The
JAX package compiles the trajectory to one `lax.scan`; here it is a Python
loop over `step`. Randomness comes from an explicit `torch.Generator`.
"""

from __future__ import annotations

__all__ = [
    "DDIMSampler",
    "Sampler",
]

import abc
import torch

from collections.abc import Sequence
from torch import Tensor

from .denoise import Denoiser
from .nn.utils import _linspace


class Sampler(abc.ABC):
    r"""Abstract reverse diffusion sampler.

    Arguments:
        start: The starting time :math:`t_T`.
        stop: The stopping time :math:`t_0`.
        steps: The number of discretization steps :math:`T`.
    """

    denoiser: Denoiser

    def __init__(self, start: float = 1.0, stop: float = 0.0, steps: int = 64) -> None:
        self.start = start
        self.stop = stop
        self.steps = steps

    @property
    def timesteps(self) -> Tensor:
        r"""The :math:`T + 1` times from :math:`t_T` to :math:`t_0`, float32."""

        return _linspace(self.start, self.stop, self.steps + 1, torch.float32)

    @property
    def requires_generator(self) -> bool:
        r"""Whether the sampler draws noise during the reverse process."""

        return False

    def init(
        self,
        shape: Sequence[int],
        mean: float | Tensor = 0.0,
        var: float | Tensor = 1.0,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: torch.Generator | None = None,
    ) -> Tensor:
        r"""Draws an initial noisy tensor :math:`x_{t_T}`.

        .. math:: x_{t_T} \sim \mathcal{N}(\alpha_{t_T} \mathbb{E}[X],
            \alpha_{t_T}^2 \mathbb{V}[X] + \sigma_{t_T}^2 I)

        Arguments:
            shape: The shape :math:`(*)` of the tensor.
            mean: The mean :math:`\mathbb{E}[X]` of :math:`p(X)`.
            var: The variance :math:`\mathbb{V}[X]` of :math:`p(X)`.
            dtype: The data type of the tensor.
            device: The device of the tensor. Defaults to the generator's
                device, or to the card when no generator is given.
            generator: The generator of the noise (the JAX `key`).
        """

        if device is None:
            device = generator.device if generator is not None else torch.device("cuda")

        t_T = self.timesteps[0].to(device)
        alpha_T, sigma_T = self.denoiser.schedule(t_T)

        mean_T = (alpha_T * mean).to(dtype)
        std_T = torch.sqrt(alpha_T**2 * var + sigma_T**2).to(dtype)

        eps = torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)

        return mean_T + std_T * eps

    def __call__(self, x: Tensor, generator: torch.Generator | None = None, **kwargs) -> Tensor:
        r"""Simulates the reverse process from :math:`t_T` to :math:`t_0`.

        Run it under `torch.no_grad()` or `torch.inference_mode()` unless
        gradients through the whole trajectory are wanted.

        Arguments:
            x: A noisy tensor :math:`x_{t_T}`, with shape :math:`(*)`.
            generator: The generator of the reverse-process noise. Required
                for stochastic samplers.
            kwargs: Optional keyword arguments (conditioning), passed to the
                denoiser at every step.

        Returns:
            The clean(er) tensor :math:`x_{t_0}`, with shape :math:`(*)`.
        """

        if self.requires_generator and generator is None:
            raise ValueError(f"{type(self).__name__} is stochastic: a `generator` is required.")

        # in float32, then cast, as JAX builds the grid: a bf16 linspace
        # rounds its points one by one, and at 250 steps gives zero-length steps
        time = _linspace(self.start, self.stop, self.steps + 1, torch.float32, x.device).to(x.dtype)

        for i in range(self.steps):
            x = self.step(x, time[i], time[i + 1], generator=generator, **kwargs)

        return x

    def step(
        self,
        x_t: Tensor,
        t: Tensor,
        s: Tensor,
        generator: torch.Generator | None = None,
        **kwargs,
    ) -> Tensor:
        r"""Simulates the reverse process from :math:`t` to :math:`s < t`.

        Arguments:
            x_t: The current tensor :math:`x_t`, with shape :math:`(*)`.
            t: The current time :math:`t`, with shape :math:`()`.
            s: The target time :math:`s`, with shape :math:`()`.
            generator: The generator of the transition noise.
            kwargs: Optional keyword arguments (conditioning).

        Returns:
            The new tensor :math:`x_s \sim q(X_s \mid x_t)`, with shape :math:`(*)`.
        """

        raise NotImplementedError()

    def _noise(self, generator: torch.Generator | None, like: Tensor) -> Tensor:
        if generator is None:
            return torch.zeros_like(like)

        return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


class DDIMSampler(Sampler):
    r"""Creates a DDIM sampler with stochasticity :math:`\eta`.

    :math:`\eta = 1` is equivalent to DDPM; :math:`\eta = 0` to Euler.
    """

    def __init__(self, denoiser: Denoiser, eta: float = 0.0, **kwargs) -> None:
        super().__init__(**kwargs)

        self.denoiser = denoiser
        self.eta = eta

    @property
    def requires_generator(self) -> bool:
        return self.eta > 0

    def step(self, x_t, t, s, generator=None, **kwargs):
        alpha_s, sigma_s = self.denoiser.schedule(s)
        alpha_t, sigma_t = self.denoiser.schedule(t)

        tau = 1 - (alpha_t / alpha_s * sigma_s / sigma_t) ** 2
        tau = torch.clip(self.eta * tau, min=0, max=1)

        q_t = self.denoiser(x_t, t, **kwargs)

        x_s = alpha_s * q_t.mean
        x_s = x_s + sigma_s * torch.sqrt(1 - tau) / sigma_t * (x_t - alpha_t * q_t.mean)
        x_s = x_s + sigma_s * torch.sqrt(tau) * self._noise(generator, x_t)

        return x_s
