r"""Stable Diffusion (SD) family.

Port of :mod:`azula_tpu.models.sd`: the `StableDenoiser` (epsilon- or
velocity-prediction, the checkpoint's discrete timestep found by a
`searchsorted` of the noise ratio in the float32 `sigmas` table), the latent
`AutoEncoder` around an
:class:`~azula_tpu_torch.models.autoencoder.AutoencoderKL`, the CLIP
`TextEncoder`, `ARCHS` / `make_backbone` over the two checkpoint
generations of `cards.yaml`, and `load_model`, which reads the UNet, VAE and
CLIP safetensors and the tokenizer files of a card's repository.

References:
    | High-Resolution Image Synthesis with Latent Diffusion Models (Rombach et al., 2021)
    | https://arxiv.org/abs/2112.10752
"""

from __future__ import annotations

__all__ = [
    "ARCHS",
    "AutoEncoder",
    "SDUNet",
    "StableDenoiser",
    "TextEncoder",
    "load_model",
    "load_unet",
    "make_backbone",
    "sd_sigmas",
]

import numpy as np
import os
import pathlib
import torch

from torch import Tensor, nn

from ...denoise import Denoiser, DiracPosterior, time_scales
from ...hub import download
from ...nn.utils import default_device, get_module_dtype, skip_init, table_device
from ...noise import Schedule, VPSchedule
from ..utils import check_manifest, load_cards, load_device, load_safetensors, load_weights
from .backbone import SDUNet


def sd_sigmas(steps: int = 1000, beta_start: float = 0.00085, beta_end: float = 0.012) -> np.ndarray:
    r"""Returns the SD scaled-linear discrete noise table
    :math:`\sigma_i = \sqrt{1 - \bar\alpha_i}` in float64 on the host (the
    schedule of every SD 1.x/2 checkpoint)."""

    beta = np.linspace(beta_start**0.5, beta_end**0.5, steps, dtype=np.float64) ** 2
    alpha_bar = np.cumprod(1 - beta)

    return np.sqrt(1 - alpha_bar)


class AutoEncoder(nn.Module):
    r"""Latent auto-encoder wrapper around an AutoencoderKL-style module.

    Arguments:
        vae: A module with `encode(x) -> (mean, std)` and `decode(z) -> x`.
        scale: The latent scaling factor (SD: 0.18215).
    """

    def __init__(self, vae: nn.Module, scale: float = 1.0) -> None:
        super().__init__()

        self.vae = vae
        self.scale = scale

    def _normal(self, generator: torch.Generator | None, like: Tensor) -> Tensor:
        r"""Standard normal draws of `like`'s shape, dtype and device: the
        one draw of :meth:`encode`, where the tests inject JAX's."""

        return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)

    def encode(self, x: Tensor, generator: torch.Generator | None = None) -> Tensor:
        r"""Encodes images, channels-last, to scaled latents sampled from the
        VAE's posterior with draws from `generator` (the JAX `key`)."""

        mean, std = self.vae.encode(x)
        z = mean + std * self._normal(generator, mean)

        return z * self.scale

    def decode(self, z: Tensor) -> Tensor:
        r"""Decodes scaled latents to images, channels-last."""

        return self.vae.decode(z / self.scale)


class TextEncoder(nn.Module):
    r"""CLIP text encoder wrapper: the last hidden state of the prompt's ids,
    padded to the tokenizer's `model_max_length` (77).

    Arguments:
        clip: A CLIP text encoder (the last hidden state of ids).
        tokenizer: The matching tokenizer.
    """

    def __init__(self, clip: nn.Module, tokenizer) -> None:
        super().__init__()

        self.clip = clip
        self.tokenizer = tokenizer

    def forward(self, prompt: str | list[str]) -> dict[str, Tensor]:
        if isinstance(prompt, str):
            prompt = [prompt]

        tokens = self.tokenizer(
            prompt,
            truncation=True,
            max_length=self.tokenizer.model_max_length,
            padding="max_length",
            return_tensors="np",
        )

        ids = torch.from_numpy(np.asarray(tokens.input_ids)).to(next(self.clip.parameters()).device)

        return {"prompt_embeds": self.clip(ids)}


class StableDenoiser(Denoiser):
    r"""Creates a stable (latent) denoiser.

    Arguments:
        backbone: A time conditional network (diffusers UNet convention).
        sigmas: The discrete noise table used during training, with shape
            :math:`(T,)`. Defaults to :func:`sd_sigmas`.
        schedule: A noise schedule. Defaults to a :class:`VPSchedule` with
            bounds derived from `sigmas`.
        prediction: The backbone prediction type (`'epsilon'` or `'velocity'`).
    """

    def __init__(
        self,
        backbone: nn.Module,
        sigmas: np.ndarray | None = None,
        schedule: Schedule | None = None,
        prediction: str = "epsilon",
    ) -> None:
        super().__init__()

        if sigmas is None:
            sigmas = sd_sigmas()

        sigmas = np.asarray(sigmas, dtype=np.float64)

        self.backbone = backbone
        self.prediction = prediction

        if schedule is None:
            self.schedule = VPSchedule(alpha_min=float((1 - sigmas[-1] ** 2) ** 0.5), sigma_min=float(sigmas[0]))
        else:
            self.schedule = schedule

        # the table is float32, as in the JAX package: the search of a
        # float32 ratio in it gives JAX's indices
        device = table_device(next(backbone.parameters()).device)
        self.register_buffer("sigmas", torch.as_tensor(sigmas, dtype=torch.float32, device=device), persistent=False)

    def forward(self, z_t: Tensor, t: Tensor, prompt_embeds: Tensor, **kwargs) -> DiracPosterior:
        r"""
        Arguments:
            z_t: A noisy latent tensor, channels-last, with shape :math:`(B, H, W, C)`.
            t: The time :math:`t`, with shape :math:`()` or :math:`(B)`.
            prompt_embeds: The CLIP-encoded prompt, with shape :math:`(B, L, D)`.

        Returns:
            The Dirac delta :math:`\delta(Z - \mu_\phi(z_t \mid y))`.
        """

        _, alpha_t, sigma_t = time_scales(self.schedule, t, z_t)

        if self.prediction == "epsilon":
            c_out = -sigma_t / alpha_t
            c_skip = 1 / alpha_t
        elif self.prediction == "velocity":
            c_out = -sigma_t * torch.rsqrt(alpha_t**2 + sigma_t**2)
            c_skip = alpha_t * torch.rsqrt(alpha_t**2 + sigma_t**2)
        else:
            raise ValueError(f"Unknown prediction type '{self.prediction}'.")

        c_in = torch.rsqrt(alpha_t**2 + sigma_t**2)
        c_time = (sigma_t * torch.rsqrt(alpha_t**2 + sigma_t**2)).reshape(-1).to(self.sigmas.device)
        dtype = torch.promote_types(self.sigmas.dtype, c_time.dtype)  # as jnp.searchsorted promotes
        c_time = torch.searchsorted(self.sigmas.to(dtype), c_time.to(dtype))

        B = z_t.shape[0]
        L, D = prompt_embeds.shape[-2:]

        dtype = get_module_dtype(self.backbone)

        output = self.backbone(
            timestep=torch.broadcast_to(c_time, (B,)),
            sample=(c_in * z_t).to(dtype),
            encoder_hidden_states=torch.broadcast_to(prompt_embeds.to(dtype), (B, L, D)),
            **kwargs,
        ).to(z_t.dtype)

        return DiracPosterior(mean=c_skip * z_t + c_out * output)


# Architecture hyperparameters of the two SD checkpoint generations (fixed per
# generation, as the diffusers pipeline configs give them).
ARCHS = {
    "sd1": dict(  # noqa: C408
        unet=dict(  # noqa: C408
            cross_attention_dim=768,
            attention_head_dim=8,
            use_linear_projection=False,
        ),
        clip=dict(hidden=768, layers=12, heads=12, intermediate=3072, act="quick_gelu"),  # noqa: C408
        scale=0.18215,
    ),
    "sd2": dict(  # noqa: C408
        unet=dict(  # noqa: C408
            cross_attention_dim=1024,
            attention_head_dim=(5, 10, 20, 20),
            use_linear_projection=True,
        ),
        clip=dict(hidden=1024, layers=23, heads=16, intermediate=4096, act="gelu"),  # noqa: C408
        scale=0.18215,
    ),
}


def _arch(name: str) -> dict:
    r"""The architecture of a card name (`'sd_1.5'`, `'sd_2'`, ...) or of a
    generation (`'sd1'`, `'sd2'`)."""

    if name in ARCHS:
        return ARCHS[name]

    return ARCHS["sd2" if name.startswith("sd_2") else "sd1"]


def make_backbone(
    name: str = "sd_1.5", *, device=None, dtype=None, generator: torch.Generator | None = None
) -> SDUNet:
    r"""Initializes the SD UNet of a checkpoint generation.

    Arguments:
        name: A card name (`'sd_1.5'`, `'sd_2'`, ...) or generation (`'sd1'`/`'sd2'`).
        device: The device of the model. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters. Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`);
            defaults to one seeded with 0 on `device`.
    """

    device = default_device(device)

    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)

    return SDUNet(**_arch(name)["unet"], device=device, dtype=dtype, generator=generator)


def _hub_file(repo: str, sub: str) -> pathlib.Path:
    return download(f"https://huggingface.co/{repo}/resolve/main/{sub}")


def load_unet(path: str | os.PathLike, name: str = "sd_2", device=None, dtype: torch.dtype | None = torch.bfloat16) -> SDUNet:
    r"""Loads the UNet of a card's generation from a diffusers
    `unet/diffusion_pytorch_model*.safetensors` file: read by
    :func:`~azula_tpu_torch.models.utils.load_safetensors`, held to the
    card's manifest, and loaded into a UNet built by
    :func:`~azula_tpu_torch.nn.utils.skip_init`.

    Arguments:
        path: The safetensors file.
        name: The card name (`'sd_1.5'`, `'sd_2'`, ...).
        device: The device of the UNet. Defaults to the card (`'cuda'`).
        dtype: Its dtype. None keeps the file's.
    """

    from .backbone import SDUNet

    device = load_device(device)
    state = load_safetensors(path)
    check_manifest(state, "sd", name, "unet")

    return load_weights(skip_init(SDUNet, **_arch(name)["unet"]), state, device=device, dtype=dtype)


def load_model(
    name: str, dtype: torch.dtype | None = torch.bfloat16, *, device=None
) -> tuple[StableDenoiser, AutoEncoder, TextEncoder]:
    r"""Loads a pretrained Stable Diffusion model from a card's repository.

    Port of :func:`azula_tpu.models.sd.load_model`: the UNet, VAE and CLIP
    safetensors are downloaded, read by the port's reader, held to the
    card's manifests, and loaded into modules built by
    :func:`~azula_tpu_torch.nn.utils.skip_init`; the CLIP tokenizer is built
    by `transformers` from the repository's vocabulary files.

    Arguments:
        name: The pretrained model name (see `cards.yaml`).
        dtype: The dtype of the modules (the checkpoints ship float16).
        device: The device of the modules. Defaults to the card (`'cuda'`).

    Returns:
        A `(denoiser, autoencoder, textencoder)` triple.
    """

    from transformers import CLIPTokenizer

    from ..autoencoder import AutoencoderKL, canonicalize_vae_keys
    from ..clip import CLIPTextEncoder, canonicalize_clip_keys

    device = load_device(device)
    card = load_cards(__name__)[name]
    arch = _arch(name)
    variant = f".{card.variant}" if getattr(card, "variant", None) else ""

    unet = load_unet(_hub_file(card.repo, f"unet/diffusion_pytorch_model{variant}.safetensors"), name, device, dtype)
    denoiser = StableDenoiser(backbone=unet, **card.config)

    vae_sd = load_safetensors(_hub_file(card.repo, f"vae/diffusion_pytorch_model{variant}.safetensors"))
    check_manifest(vae_sd, "sd", name, "vae", canonicalize=canonicalize_vae_keys)
    vae = load_weights(skip_init(AutoencoderKL), vae_sd, canonicalize_vae_keys, device=device, dtype=dtype)
    autoencoder = AutoEncoder(vae=vae, scale=arch["scale"])

    clip_sd = load_safetensors(_hub_file(card.repo, f"text_encoder/model{variant}.safetensors"))
    check_manifest(clip_sd, "sd", name, "text_encoder", canonicalize=canonicalize_clip_keys)
    clip = skip_init(CLIPTextEncoder, **arch["clip"])
    load_weights(clip, clip_sd, canonicalize_clip_keys, device=device, dtype=dtype)

    # padded to the encoder's positions (77), which the vocabulary files
    # alone do not give
    tokenizer = CLIPTokenizer(
        vocab_file=str(_hub_file(card.repo, "tokenizer/vocab.json")),
        merges_file=str(_hub_file(card.repo, "tokenizer/merges.txt")),
        model_max_length=clip.position_embedding.weight.shape[0],
    )

    return denoiser, autoencoder, TextEncoder(clip=clip, tokenizer=tokenizer)
