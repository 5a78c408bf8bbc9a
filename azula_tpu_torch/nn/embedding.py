r"""Time conditioning.

Port of :mod:`azula_tpu.nn.embedding`: :class:`TimeEmbedding` maps the
denoiser's scalar :math:`c_\mathrm{time}` to modulation features, and
:class:`Modulated` adapts a `mod`-conditioned backbone (DiT / ViT) to the
denoiser's ``backbone(x_t, t, **kwargs)`` contract.
"""

from __future__ import annotations

__all__ = [
    "Modulated",
    "TimeEmbedding",
]

import torch
import torch.nn.functional as F

from torch import Tensor, nn

from .layers import Linear, SineEncoding
from .utils import default_device


class TimeEmbedding(nn.Module):
    r"""Sinusoidal time encoding followed by a 2-layer MLP.

    Arguments:
        features: The number of output modulation features :math:`D`.
        device: The device of the parameters. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters. Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`).
    """

    def __init__(
        self,
        features: int,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408

        self.encoding = SineEncoding(features)
        self.lin1 = Linear(features, features, **factory)
        self.lin2 = Linear(features, features, **factory)

    def forward(self, t: Tensor) -> Tensor:
        h = self.encoding(t)
        h = F.silu(self.lin1(h))
        return self.lin2(h)


class Modulated(nn.Module):
    r"""Adapts a `mod`-conditioned backbone to the denoiser contract
    ``backbone(x_t, t, **kwargs)``.

    Arguments:
        backbone: A network taking ``(x, mod=..., **kwargs)`` (DiT / ViT).
        mod_features: The number of modulation features :math:`D`.
        device: The device of the time embedding. Defaults to the card (`'cuda'`).
        dtype: The dtype of the time embedding. Defaults to float32.
        generator: The generator of the time embedding's initial parameters.
    """

    def __init__(
        self,
        backbone: nn.Module,
        mod_features: int,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        self.backbone = backbone
        self.time_embedding = TimeEmbedding(mod_features, device=device, dtype=dtype, generator=generator)

    def forward(self, x_t: Tensor, t: Tensor, **kwargs) -> Tensor:
        mod = self.time_embedding(t)

        if mod.ndim == 1:
            mod = mod.expand(x_t.shape[0], mod.shape[-1])

        return self.backbone(x_t, mod=mod, **kwargs)
