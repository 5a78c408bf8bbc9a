r"""Elucidated latent diffusion model (ELDM / EDM2) family.

Port of :mod:`azula_tpu.models.eldm`: the `ElucidatedLatentDenoiser` (EDM
preconditioning in latent space, as :class:`~azula_tpu_torch.models.edm.ElucidatedDenoiser`)
over the :class:`EDM2Precond` backbone, and the `AutoEncoder` wrapper with
per-channel latent shift and scale around an
:class:`~azula_tpu_torch.models.autoencoder.AutoencoderKL` (the
`sd-vae-ft-mse` architecture), and `load_model`, which reads the
NVlabs/edm2 pickles of `cards.yaml` and the `sd-vae-ft-mse` safetensors.
"""

from __future__ import annotations

__all__ = [
    "AutoEncoder",
    "EDM2Precond",
    "EDM2UNet",
    "ElucidatedLatentDenoiser",
    "load_model",
]

import torch

from collections.abc import Sequence
from torch import Tensor, nn

from ...hub import download
from ...nn.utils import skip_init
from ..edm import ElucidatedDenoiser
from ..utils import load_cards, load_device, load_safetensors, load_weights
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


# the VAE of the EDM2 latent models
VAE_URL = "https://huggingface.co/stabilityai/sd-vae-ft-mse/resolve/main/diffusion_pytorch_model.safetensors"


def load_model(name: str, dtype: torch.dtype | None = None, *, device=None) -> tuple[ElucidatedLatentDenoiser, AutoEncoder]:
    r"""Loads a pretrained EDM2 latent denoiser and its auto-encoder.

    Port of :func:`azula_tpu.models.eldm.load_model`: the NVlabs/edm2 pickle
    is read without the NVlabs source tree
    (:func:`~azula_tpu_torch.models.eldm.convert.build_from_pickle`), its
    encoder's latent statistics give the auto-encoder's shift and scale, and
    the VAE is `stabilityai/sd-vae-ft-mse` from its safetensors file.

    Arguments:
        name: The pretrained model name (see `cards.yaml`).
        dtype: The dtype of the backbones. Defaults to the checkpoints'.
        device: The device of the models. Defaults to the card (`'cuda'`).

    Returns:
        A `(denoiser, autoencoder)` pair.
    """

    from ..autoencoder import AutoencoderKL, canonicalize_vae_keys
    from .convert import build_from_pickle

    device = load_device(device)
    card = load_cards(__name__)[name]

    backbone, shift, scale = build_from_pickle(download(card.url, hash_prefix=card.hash), device=device, dtype=dtype)

    if shift is None or scale is None:
        raise RuntimeError(
            f"checkpoint '{name}' carries no latent encoder statistics (expected an 'encoder' entry with bias/scale buffers)"
        )

    denoiser = ElucidatedLatentDenoiser(backbone=backbone)

    vae = skip_init(AutoencoderKL)
    load_weights(vae, load_safetensors(download(VAE_URL)), canonicalize_vae_keys, device=device, dtype=dtype)

    return denoiser, AutoEncoder(vae=vae, shift=shift, scale=scale)
