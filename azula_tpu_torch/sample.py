r"""Reverse diffusion samplers.

Port of :mod:`azula_tpu.sample`: DDPM, DDIM, Euler, Heun, Itô, the
Adams-Bashforth multistep family (zAB, vAB, zEAB, xEAB, REAB) and
predictor-corrector. The JAX package compiles the trajectory to one
`lax.scan`; here it is a Python loop over `step`. Randomness comes from an
explicit `torch.Generator`, drawn through `_normal`, the one place where
the tests inject JAX's draws. The multistep samplers' coefficient tables are
computed on the host in NumPy float64, as JAX computes them, and go to the
device once per trajectory.
"""

from __future__ import annotations

__all__ = [
    "DDIMSampler",
    "DDPMSampler",
    "EulerSampler",
    "HeunSampler",
    "ItoSampler",
    "PCSampler",
    "REABSampler",
    "Sampler",
    "vABSampler",
    "xEABSampler",
    "zABSampler",
    "zEABSampler",
]

import abc
import math
import numpy as np
import sys
import torch

from collections.abc import Sequence
from torch import Tensor

from .denoise import Denoiser
from .nn.utils import _linspace
from .utils.profiling import _mark, _ready, _seconds, annotate


class _Progress:
    r"""Sampling progress line with rate and ETA, printed to stderr after
    each step: the steps queued, the rate at which the device completes
    them and the time until it completes the last. On a CUDA device an event
    is recorded after each step and queried without a wait, so the line
    never waits for the card; on the CPU, where a step is done when it
    returns, the host clock times it."""

    def __init__(self, total: int) -> None:
        self.total = total
        self.marks = []  # `profiling._mark` after each step
        self.done = 0  # steps the device has completed

    def __call__(self, i: int, x: Tensor) -> None:
        marks = self.marks
        marks.append(_mark(x))

        while self.done < len(marks) and _ready(marks[self.done]):
            self.done += 1

        done = self.done
        dt = _seconds(marks[0], marks[done - 1]) if done > 1 else 0.0
        rate = (done - 1) / dt if dt > 0 else float("nan")
        eta = (self.total - done) / rate if rate > 0 else float("nan")

        i = i + 1
        end = "\n" if i >= self.total else ""
        print(
            f"\rsampling {i}/{self.total} ({rate:5.2f} steps/s, ETA {eta:4.0f}s)",
            end=end,
            file=sys.stderr,
            flush=True,
        )


class Sampler(abc.ABC):
    r"""Abstract reverse diffusion sampler.

    Arguments:
        start: The starting time :math:`t_T`.
        stop: The stopping time :math:`t_0`.
        steps: The number of discretization steps :math:`T`.
        progress: Whether to print a progress line (rate and ETA) to stderr.
    """

    denoiser: Denoiser

    def __init__(self, start: float = 1.0, stop: float = 0.0, steps: int = 64, progress: bool = False) -> None:
        self.start = start
        self.stop = stop
        self.steps = steps
        self.progress = progress

    @property
    def timesteps(self) -> Tensor:
        r"""The :math:`T + 1` times from :math:`t_T` to :math:`t_0`, float32."""

        return _linspace(self.start, self.stop, self.steps + 1, torch.float32)

    @property
    def timesteps_np(self) -> np.ndarray:
        r"""The times on the host in float64, for coefficient tables."""

        return np.linspace(self.start, self.stop, self.steps + 1, dtype=np.float64)

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

        Run it under `torch.no_grad()` unless gradients through the whole
        trajectory are wanted. The guidance methods that differentiate
        through the denoiser (MMPS, DPS, PGDM, TMPD, TDS) need autograd, so
        they raise under `torch.inference_mode()`.

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

        return self._trajectory(x, generator, **kwargs)

    def _time(self, x: Tensor) -> Tensor:
        # in float32, then cast, as JAX builds the grid: a bf16 linspace
        # rounds its points one by one, and at 250 steps gives zero-length steps
        return _linspace(self.start, self.stop, self.steps + 1, torch.float32, x.device).to(x.dtype)

    def _tracker(self) -> _Progress | None:
        return _Progress(self.steps) if self.progress else None

    def _trajectory(self, x: Tensor, generator: torch.Generator | None, **kwargs) -> Tensor:
        time = self._time(x)
        tracker = self._tracker()

        for i in range(self.steps):
            with annotate("azula.sample.step"):
                x = self.step(x, time[i], time[i + 1], generator=generator, **kwargs)
            if tracker is not None:
                tracker(i, x)

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

    def _normal(self, generator: torch.Generator | None, shape: Sequence[int], like: Tensor) -> Tensor:
        r"""Standard normal draws of `shape` in `like`'s dtype and on its
        device: every draw of the samplers and guidance methods goes
        through here."""

        return torch.randn(tuple(shape), generator=generator, dtype=like.dtype, device=like.device)

    def _noise(self, generator: torch.Generator | None, like: Tensor) -> Tensor:
        if generator is None:
            return torch.zeros_like(like)

        return self._normal(generator, like.shape, like)


class DDPMSampler(Sampler):
    r"""Creates a DDPM (ancestral) sampler.

    .. math:: x_s \gets \alpha_s \mathbb{E}[X \mid x_t]
        + \sigma_s \sqrt{1 - \tau} \, \frac{x_t - \alpha_t \mathbb{E}[X \mid x_t]}{\sigma_t}
        + \sigma_s \sqrt{\tau} \, \varepsilon,
        \quad \tau = 1 - \frac{\alpha_t^2}{\alpha_s^2} \frac{\sigma_s^2}{\sigma_t^2}
    """

    def __init__(self, denoiser: Denoiser, **kwargs) -> None:
        super().__init__(**kwargs)

        self.denoiser = denoiser

    @property
    def requires_generator(self) -> bool:
        return True

    def step(self, x_t, t, s, generator=None, **kwargs):
        alpha_s, sigma_s = self.denoiser.schedule(s)
        alpha_t, sigma_t = self.denoiser.schedule(t)

        tau = 1 - (alpha_t / alpha_s * sigma_s / sigma_t) ** 2

        q_t = self.denoiser(x_t, t, **kwargs)

        x_s = alpha_s * q_t.mean
        x_s = x_s + sigma_s * torch.sqrt(1 - tau) / sigma_t * (x_t - alpha_t * q_t.mean)
        x_s = x_s + sigma_s * torch.sqrt(tau) * self._noise(generator, x_t)

        return x_s


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


class EulerSampler(Sampler):
    r"""Creates an explicit Euler (1st order probability-flow ODE) sampler."""

    def __init__(self, denoiser: Denoiser, **kwargs) -> None:
        super().__init__(**kwargs)

        self.denoiser = denoiser

    def step(self, x_t, t, s, generator=None, **kwargs):
        alpha_s, sigma_s = self.denoiser.schedule(s)
        alpha_t, sigma_t = self.denoiser.schedule(t)

        q_t = self.denoiser(x_t, t, **kwargs)
        z_t = (x_t - alpha_t * q_t.mean) / sigma_t
        x_s = alpha_s / alpha_t * x_t + alpha_s * (sigma_s / alpha_s - sigma_t / alpha_t) * z_t

        return x_s


class HeunSampler(Sampler):
    r"""Creates an explicit Heun (2nd order, two denoiser calls per step) sampler."""

    def __init__(self, denoiser: Denoiser, **kwargs) -> None:
        super().__init__(**kwargs)

        self.denoiser = denoiser

    def step(self, x_t, t, s, generator=None, **kwargs):
        alpha_s, sigma_s = self.denoiser.schedule(s)
        alpha_t, sigma_t = self.denoiser.schedule(t)

        q_t = self.denoiser(x_t, t, **kwargs)
        z_t = (x_t - alpha_t * q_t.mean) / sigma_t
        x_s = alpha_s / alpha_t * x_t + alpha_s * (sigma_s / alpha_s - sigma_t / alpha_t) * z_t

        q_s = self.denoiser(x_s, s, **kwargs)
        z_s = (x_s - alpha_s * q_s.mean) / sigma_s
        z_t = (z_t + z_s) / 2
        x_s = alpha_s / alpha_t * x_t + alpha_s * (sigma_s / alpha_s - sigma_t / alpha_t) * z_t

        return x_s


class ItoSampler(Sampler):
    r"""Creates an Itô SDE sampler with stochasticity :math:`\eta` and
    temperature :math:`\tau`."""

    def __init__(self, denoiser: Denoiser, eta: float = 1.0, temperature: float = 1.0, **kwargs) -> None:
        super().__init__(**kwargs)

        self.denoiser = denoiser
        self.eta = eta
        self.temperature = temperature

    @property
    def requires_generator(self) -> bool:
        return self.eta > 0

    def step(self, x_t, t, s, generator=None, **kwargs):
        alpha_s, sigma_s = self.denoiser.schedule(s)
        alpha_t, sigma_t = self.denoiser.schedule(t)

        q_t = self.denoiser(x_t, t, **kwargs)

        x_s = alpha_s / alpha_t * x_t
        x_s = x_s + (1 + self.eta**2) / self.temperature * (sigma_s / sigma_t - alpha_s / alpha_t) * (
            x_t - alpha_t * q_t.mean
        )
        x_s = x_s + self.eta * alpha_s * torch.sqrt(
            torch.abs((sigma_t / alpha_t) ** 2 - (sigma_s / alpha_s) ** 2)
        ) * self._noise(generator, x_s)

        return x_s


def _trapezoid(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    r"""`np.trapezoid(y, x, axis=-1)` for a 1-d `x`, in NumPy's own order of
    operations (the function is missing from NumPy before 2.0)."""

    return np.add.reduce(np.diff(x) * (y[..., 1:] + y[..., :-1]) / 2.0, axis=-1)


def _ab_coefficients(u: np.ndarray, order: int, kind: str) -> np.ndarray:
    r"""Precomputes (exponential) Adams-Bashforth coefficient rows for every
    step, in NumPy float64, as the JAX package does.

    Arguments:
        u: The integration variable, with shape :math:`(T + 1,)`, float64.
        order: The method order :math:`n`.
        kind: One of `'poly'`, `'exp'`, `'exp_neg'`, `'rosenbrock'`.

    Returns:
        Coefficient rows, with shape :math:`(T, \text{order})`. Row :math:`i` is
        zero-padded at the front; entry :math:`\text{order} - n + j` multiplies
        the :math:`j`-th oldest of the last :math:`n` history entries.
    """

    T = len(u) - 1
    table = np.zeros((T, order), dtype=np.float64)

    for i in range(T):
        n = min(order, i + 1)
        k = np.arange(n)

        # Vandermonde matrix u_i^k
        V = u[i + 1 - n : i + 1] ** k[:, None]

        if kind == "poly":
            # integral of v^k from u_i to u_{i+1}
            b = u[i + 1] ** (k + 1) / (k + 1) - u[i] ** (k + 1) / (k + 1)
        elif kind == "exp":
            # integral of exp(v) v^k from u_i to u_{i+1}
            k_fact = np.cumprod(np.clip(k, 1, None))
            b = (
                (-1.0) ** k
                * k_fact
                * (
                    np.exp(u[i + 1]) * np.cumsum((-u[i + 1]) ** k / k_fact)
                    - np.exp(u[i]) * np.cumsum((-u[i]) ** k / k_fact)
                )
            )
        elif kind == "exp_neg":
            # integral of exp(-v) v^k from u_i to u_{i+1}
            k_fact = np.cumprod(np.clip(k, 1, None))
            b = -k_fact * (
                np.exp(-u[i + 1]) * np.cumsum(u[i + 1] ** k / k_fact)
                - np.exp(-u[i]) * np.cumsum(u[i] ** k / k_fact)
            )
        elif kind == "rosenbrock":
            # integral of exp(v) / (1 + exp(2v)) v^k from u_i to u_{i+1}
            v = np.linspace(u[i], u[i + 1], 256 + 1)
            y = np.exp(v) / (1 + np.exp(2 * v)) * (v ** k[:, None])
            b = _trapezoid(y, v)
        else:
            raise ValueError(f"unknown coefficient kind '{kind}'")

        table[i, order - n :] = np.linalg.solve(V, b)

    return table


class _MultistepSampler(Sampler):
    r"""Shared machinery of the multistep (AB/EAB/REAB) samplers: a history of
    the last :math:`\text{order}` derivatives, the newest at index
    :math:`\text{order} - 1`, and one row of the host's float64 coefficient
    table per step."""

    _kind: str

    def __init__(self, denoiser: Denoiser, order: int = 2, **kwargs) -> None:
        super().__init__(**kwargs)

        self.denoiser = denoiser
        self.order = order

    def _u(self, alpha: np.ndarray, sigma: np.ndarray) -> np.ndarray:
        raise NotImplementedError()

    def _integral_scale(self, alpha: np.ndarray, sigma: np.ndarray) -> np.ndarray:
        r"""The per-step factor the update applies to the integral, folded
        into the float64 table on the host: the exponential integrators'
        coefficients can reach :math:`e^{|u|} \sim 10^3` with heavy
        cancellation before this factor shrinks them back."""

        raise NotImplementedError()

    def _derivative(self, x_t, mean, alpha_t, sigma_t):
        raise NotImplementedError()

    def _update(self, x_t, integral, alpha_t, sigma_t, alpha_s, sigma_s):
        r"""`integral` arrives pre-multiplied by :meth:`_integral_scale`."""

        raise NotImplementedError()

    def _table(self) -> np.ndarray:
        r"""The coefficient rows, scaled, in float64: the schedule runs on a
        float64 CPU tensor of the host's times."""

        times = self.timesteps_np
        alpha, sigma = self.denoiser.schedule(torch.from_numpy(times))
        alpha = np.broadcast_to(np.asarray(alpha, np.float64), times.shape)
        sigma = np.broadcast_to(np.asarray(sigma, np.float64), times.shape)

        table = _ab_coefficients(self._u(alpha, sigma), self.order, self._kind)

        return table * self._integral_scale(alpha, sigma)[:, None]

    def _trajectory(self, x: Tensor, generator: torch.Generator | None, **kwargs) -> Tensor:
        table = torch.as_tensor(self._table(), dtype=x.dtype, device=x.device)

        time = self._time(x)
        alpha, sigma = self.denoiser.schedule(time)
        alpha = torch.broadcast_to(torch.as_tensor(alpha, dtype=x.dtype), time.shape)
        sigma = torch.broadcast_to(torch.as_tensor(sigma, dtype=x.dtype), time.shape)

        history = torch.zeros((self.order, *x.shape), dtype=x.dtype, device=x.device)
        tracker = self._tracker()

        for i in range(self.steps):
            with annotate("azula.sample.step"):
                q_t = self.denoiser(x, time[i], **kwargs)
                d_t = self._derivative(x, q_t.mean, alpha[i], sigma[i])

                history = torch.cat((history[1:], d_t.to(x.dtype)[None]))
                integral = torch.tensordot(table[i], history, dims=1)

                x = self._update(x, integral, alpha[i], sigma[i], alpha[i + 1], sigma[i + 1])
            if tracker is not None:
                tracker(i, x)

        return x


class zABSampler(_MultistepSampler):
    r"""Creates an Adams-Bashforth multistep sampler with noise (:math:`z`)
    prediction, equivalent to the k-diffusion LMS sampler.

    Arguments:
        denoiser: A denoiser :math:`q_\phi(X \mid X_t)`.
        order: The order :math:`n` of the multistep method.
    """

    _kind = "poly"

    def _u(self, alpha, sigma):
        return sigma / alpha

    def _integral_scale(self, alpha, sigma):
        return alpha[1:]

    def _derivative(self, x_t, mean, alpha_t, sigma_t):
        return (x_t - alpha_t * mean) / sigma_t

    def _update(self, x_t, integral, alpha_t, sigma_t, alpha_s, sigma_s):
        return alpha_s / alpha_t * x_t + integral


class vABSampler(_MultistepSampler):
    r"""Creates an Adams-Bashforth multistep sampler with velocity (:math:`v`)
    prediction."""

    _kind = "poly"

    def _u(self, alpha, sigma):
        return sigma / (alpha + sigma)

    def _integral_scale(self, alpha, sigma):
        return alpha[1:] + sigma[1:]

    def _derivative(self, x_t, mean, alpha_t, sigma_t):
        return 1 / sigma_t * x_t - (1 + alpha_t / sigma_t) * mean

    def _update(self, x_t, integral, alpha_t, sigma_t, alpha_s, sigma_s):
        return (alpha_s + sigma_s) / (alpha_t + sigma_t) * x_t + integral


class zEABSampler(_MultistepSampler):
    r"""Creates an exponential Adams-Bashforth multistep sampler with noise
    (:math:`z`) prediction, a multistep generalization of DPM-Solver."""

    _kind = "exp"

    def _u(self, alpha, sigma):
        return np.log(sigma) - np.log(alpha)

    def _integral_scale(self, alpha, sigma):
        return alpha[1:]

    def _derivative(self, x_t, mean, alpha_t, sigma_t):
        return (x_t - alpha_t * mean) / sigma_t

    def _update(self, x_t, integral, alpha_t, sigma_t, alpha_s, sigma_s):
        return alpha_s / alpha_t * x_t + integral


class xEABSampler(_MultistepSampler):
    r"""Creates an exponential Adams-Bashforth multistep sampler with data
    (:math:`x`) prediction, a multistep generalization of DPM-Solver++."""

    _kind = "exp_neg"

    def _u(self, alpha, sigma):
        return np.log(sigma) - np.log(alpha)

    def _integral_scale(self, alpha, sigma):
        return -sigma[1:]

    def _derivative(self, x_t, mean, alpha_t, sigma_t):
        return mean

    def _update(self, x_t, integral, alpha_t, sigma_t, alpha_s, sigma_s):
        return sigma_s / sigma_t * x_t + integral


class REABSampler(_MultistepSampler):
    r"""Creates a Rosenbrock-type exponential Adams-Bashforth multistep
    sampler, a multistep generalization of DPM-Solver-v3."""

    _kind = "rosenbrock"

    def _u(self, alpha, sigma):
        return np.log(sigma) - np.log(alpha)

    def _integral_scale(self, alpha, sigma):
        # the `alpha_s**2 + sigma_t**2` mix is the JAX package's (and the
        # reference azula's), kept for parity
        return np.sqrt(alpha[1:] ** 2 + sigma[:-1] ** 2)

    def _derivative(self, x_t, mean, alpha_t, sigma_t):
        a_t = sigma_t**2 / (alpha_t**2 + sigma_t**2)
        b_t = sigma_t * torch.rsqrt(alpha_t**2 + sigma_t**2)

        return (1 - a_t) / b_t / alpha_t * x_t - 1 / b_t * mean

    def _update(self, x_t, integral, alpha_t, sigma_t, alpha_s, sigma_s):
        return torch.sqrt((alpha_s**2 + sigma_s**2) / (alpha_t**2 + sigma_t**2)) * x_t + integral


class PCSampler(Sampler):
    r"""Creates a predictor-corrector sampler: `corrections` Langevin-like
    corrector steps of amplitude :math:`\delta` followed by a DDIM-like
    predictor."""

    def __init__(self, denoiser: Denoiser, corrections: int = 1, delta: float = 0.01, **kwargs) -> None:
        super().__init__(**kwargs)

        self.denoiser = denoiser
        self.corrections = corrections
        self.delta = delta

    @property
    def requires_generator(self) -> bool:
        return self.corrections > 0 and self.delta > 0

    def step(self, x_t, t, s, generator=None, **kwargs):
        alpha_s, sigma_s = self.denoiser.schedule(s)
        alpha_t, sigma_t = self.denoiser.schedule(t)

        # corrector
        for _ in range(self.corrections):
            q_t = self.denoiser(x_t, t, **kwargs)
            x_t = (
                alpha_t * q_t.mean
                + math.sqrt(1 - self.delta) * (x_t - alpha_t * q_t.mean)
                + math.sqrt(self.delta) * sigma_t * self._noise(generator, x_t)
            )

        # predictor
        q_t = self.denoiser(x_t, t, **kwargs)
        x_s = alpha_s * q_t.mean + sigma_s / sigma_t * (x_t - alpha_t * q_t.mean)

        return x_s
