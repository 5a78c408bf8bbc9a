r"""Noise schedules.

A noise schedule maps a time :math:`t \in [0, 1]` to the signal scale
:math:`\alpha_t` and the noise scale :math:`\sigma_t` of the perturbation
kernel :math:`p(X_t \mid X) = \mathcal{N}(X_t \mid \alpha_t X, \sigma_t^2 I)`.

Port of :mod:`azula_tpu.noise`: `VESchedule`, `VPSchedule`, `CosineSchedule`,
`RectifiedSchedule`, `DecaySchedule` and `ElucidatedSchedule`. Schedules
compute in the dtype and on the device of `t`; the multistep samplers call
them on a float64 CPU tensor for their coefficient tables, where JAX calls
them on a NumPy array.
"""

from __future__ import annotations

__all__ = [
    "CosineSchedule",
    "DecaySchedule",
    "ElucidatedSchedule",
    "RectifiedSchedule",
    "Schedule",
    "VESchedule",
    "VPSchedule",
]

import abc
import math
import torch

from torch import Tensor


class Schedule(abc.ABC):
    r"""Abstract noise schedule."""

    @abc.abstractmethod
    def __call__(self, t: Tensor) -> tuple[Tensor, Tensor]:
        r"""
        Arguments:
            t: The time :math:`t`, with shape :math:`(*)`.

        Returns:
            The signal and noise scales :math:`\alpha_t` and :math:`\sigma_t`,
            with shape :math:`(*)`.
        """

        pass


class VESchedule(Schedule):
    r"""Creates a variance exploding (VE) noise schedule.

    .. math::
        \alpha_t & = 1 \\
        \sigma_t & = \exp \big( (1 - t) \log \sigma_\min + t \log \sigma_\max \big)

    Arguments:
        sigma_min: The initial noise scale :math:`\sigma_\min \in \mathbb{R}_+`.
        sigma_max: The final noise scale :math:`\sigma_\max \in \mathbb{R}_+`.
    """

    def __init__(self, sigma_min: float = 1e-3, sigma_max: float = 1e3) -> None:
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def __call__(self, t: Tensor) -> tuple[Tensor, Tensor]:
        return self.alpha(t), self.sigma(t)

    def alpha(self, t: Tensor) -> Tensor:
        return torch.ones_like(t)

    def sigma(self, t: Tensor) -> Tensor:
        return torch.exp((1 - t) * math.log(self.sigma_min) + t * math.log(self.sigma_max))


class VPSchedule(Schedule):
    r"""Creates a variance preserving (VP) noise schedule.

    .. math::
        \alpha_t & = \exp \big( t^2 \log \alpha_\min \big) \\
        \sigma_t & = \sqrt{ 1 - \alpha_t^2 + \sigma_\min^2}

    Arguments:
        alpha_min: The final signal scale :math:`\alpha_\min \in ]0,1[`.
        sigma_min: The initial noise scale :math:`\sigma_\min \in ]0,1[`.
    """

    def __init__(self, alpha_min: float = 1e-3, sigma_min: float = 1e-3) -> None:
        self.alpha_min = alpha_min
        self.sigma_min = sigma_min

    def __call__(self, t: Tensor) -> tuple[Tensor, Tensor]:
        return self.alpha(t), self.sigma(t)

    def alpha(self, t: Tensor) -> Tensor:
        return torch.exp(math.log(self.alpha_min) * t**2)

    def sigma(self, t: Tensor) -> Tensor:
        return torch.sqrt(1 - self.alpha(t) ** 2 + self.sigma_min**2)


class CosineSchedule(Schedule):
    r"""Creates a cosine noise schedule.

    .. math::
        \alpha_t & = \cos \big( t \arccos \alpha_\min \big) \\
        \sigma_t & = \sqrt{ 1 - \alpha_t^2 + \sigma_\min^2}

    Arguments:
        alpha_min: The final signal scale :math:`\alpha_\min \in ]0,1[`.
        sigma_min: The initial noise scale :math:`\sigma_\min \in ]0,1[`.
    """

    def __init__(self, alpha_min: float = 1e-3, sigma_min: float = 1e-3) -> None:
        self.alpha_min = alpha_min
        self.sigma_min = sigma_min

    def __call__(self, t: Tensor) -> tuple[Tensor, Tensor]:
        return self.alpha(t), self.sigma(t)

    def alpha(self, t: Tensor) -> Tensor:
        return torch.cos(math.acos(self.alpha_min) * t)

    def sigma(self, t: Tensor) -> Tensor:
        return torch.sqrt(1 - self.alpha(t) ** 2 + self.sigma_min**2)


class RectifiedSchedule(Schedule):
    r"""Creates a rectified (flow matching) noise schedule.

    .. math::
        \alpha_t & = t \, \alpha_\min + (1 - t) \\
        \sigma_t & = t + (1 - t) \, \sigma_\min

    Arguments:
        alpha_min: The final signal scale :math:`\alpha_\min \in ]0,1[`.
        sigma_min: The initial noise scale :math:`\sigma_\min \in ]0,1[`.
    """

    def __init__(self, alpha_min: float = 1e-3, sigma_min: float = 1e-3) -> None:
        self.alpha_min = alpha_min
        self.sigma_min = sigma_min

    def __call__(self, t: Tensor) -> tuple[Tensor, Tensor]:
        return self.alpha(t), self.sigma(t)

    def alpha(self, t: Tensor) -> Tensor:
        return t * self.alpha_min + (1 - t)

    def sigma(self, t: Tensor) -> Tensor:
        return t + (1 - t) * self.sigma_min


class DecaySchedule(Schedule):
    r"""Creates an exponential decay schedule (Flux, Sana).

    .. math::
        \alpha_t & = \tau \, \alpha_\min + (1 - \tau) \\
        \sigma_t & = \tau + (1 - \tau) \, \sigma_\min
        \quad \text{where} \quad \tau = \frac{1 - \gamma^t}{1 - \gamma}

    Arguments:
        alpha_min: The final signal scale :math:`\alpha_\min \in ]0,1[`.
        sigma_min: The initial noise scale :math:`\sigma_\min \in ]0,1[`.
        gamma: The decay factor :math:`\gamma \in ]0,1[`.
    """

    def __init__(self, alpha_min: float = 1e-3, sigma_min: float = 1e-3, gamma: float = 0.1) -> None:
        self.alpha_min = alpha_min
        self.sigma_min = sigma_min
        self.gamma = gamma

    def __call__(self, t: Tensor) -> tuple[Tensor, Tensor]:
        return self.alpha(t), self.sigma(t)

    def tau(self, t: Tensor) -> Tensor:
        return (1 - self.gamma**t) / (1 - self.gamma)

    def alpha(self, t: Tensor) -> Tensor:
        tau = self.tau(t)
        return tau * self.alpha_min + (1 - tau)

    def sigma(self, t: Tensor) -> Tensor:
        tau = self.tau(t)
        return tau + (1 - tau) * self.sigma_min


class ElucidatedSchedule(Schedule):
    r"""Creates an elucidated (EDM / Karras :math:`\rho`-) noise schedule.

    .. math::
        \alpha_t & = 1 \\
        \sigma_t & = \left( \sigma_\min^{1/\rho} + t \,
            (\sigma_\max^{1/\rho} - \sigma_\min^{1/\rho}) \right)^\rho

    Arguments:
        sigma_min: The initial noise scale :math:`\sigma_\min`.
        sigma_max: The final noise scale :math:`\sigma_\max`.
        rho: The interpolation exponent :math:`\rho`.
    """

    def __init__(self, sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0) -> None:
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.rho = rho

    def __call__(self, t: Tensor) -> tuple[Tensor, Tensor]:
        return self.alpha(t), self.sigma(t)

    def alpha(self, t: Tensor) -> Tensor:
        return torch.ones_like(t)

    def sigma(self, t: Tensor) -> Tensor:
        lo = self.sigma_min ** (1 / self.rho)
        hi = self.sigma_max ** (1 / self.rho)

        return (lo + t * (hi - lo)) ** self.rho
