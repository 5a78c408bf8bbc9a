r"""Elucidated latent diffusion model (ELDM / EDM2) family.

Port of :mod:`azula_tpu.models.eldm`: the `ElucidatedLatentDenoiser` (EDM
preconditioning in latent space, as :class:`~azula_tpu_torch.models.edm.ElucidatedDenoiser`)
over the :class:`EDM2Precond` backbone, and the `AutoEncoder` wrapper with
per-channel latent shift and scale around an
:class:`~azula_tpu_torch.models.autoencoder.AutoencoderKL` (the
`sd-vae-ft-mse` architecture). The NVlabs/edm2 pickles of `cards.yaml` are
read by `load_model`, which waits for checkpoint files in the repository.
"""

from __future__ import annotations

__all__ = [
    "AutoEncoder",
    "EDM2Precond",
    "EDM2UNet",
    "ElucidatedLatentDenoiser",
]

import torch

from collections.abc import Sequence
from torch import Tensor, nn

from ..edm import ElucidatedDenoiser
from .backbone import EDM2Precond, EDM2UNet


class AutoEncoder(nn.Module):
    r"""Auto-encoder wrapper with per-channel latent statistics: latents are
    :math:`z \cdot \text{scale} + \text{shift}` of the VAE's.

    Arguments:
        vae: A module with `encode(x) -> (mean, std)` and `decode(z) -> x`.
        shift: The per-channel latent shift, with shape :math:`(C,)`.
        scale: The per-channel latent scale, with shape :math:`(C,)`.
    """

    def __init__(self, vae: nn.Module, shift: Tensor | Sequence[float], scale: Tensor | Sequence[float]) -> None:
        super().__init__()

        self.vae = vae

        device = next(vae.parameters()).device
        self.register_buffer("shift", torch.as_tensor(shift, dtype=torch.float32, device=device))
        self.register_buffer("scale", torch.as_tensor(scale, dtype=torch.float32, device=device))

    def _normal(self, generator: torch.Generator | None, like: Tensor) -> Tensor:
        r"""Standard normal draws of `like`'s shape, dtype and device: the
        one draw of :meth:`encode`, where the tests inject JAX's."""

        return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)

    def encode(self, x: Tensor, generator: torch.Generator | None = None) -> Tensor:
        r"""Encodes images, channels-last, to latents sampled from the VAE's
        posterior with draws from `generator` (the JAX `key`)."""

        mean, std = self.vae.encode(x)
        z = mean + std * self._normal(generator, mean)

        return z * self.scale + self.shift

    def decode(self, z: Tensor) -> Tensor:
        r"""Decodes latents to images, channels-last."""

        return self.vae.decode((z - self.shift) / self.scale)


class ElucidatedLatentDenoiser(ElucidatedDenoiser):
    r"""Creates an elucidated latent denoiser: :class:`ElucidatedDenoiser`'s
    preconditioning on latents, over an EDM2 backbone.

    Arguments:
        backbone: A noise conditional network (EDM2 convention).
        schedule: A noise schedule. Defaults to :class:`ElucidatedSchedule`.
    """
