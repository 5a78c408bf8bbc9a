r"""Flux family.

Port of :mod:`azula_tpu.models.flux`: the `FluxDenoiser` (rectified-flow
preconditioning :math:`c_\mathrm{in} = c_\mathrm{skip} = 1/(\alpha+\sigma)`,
:math:`c_\mathrm{out} = -\sigma/(\alpha+\sigma)`), with cached image-coordinate
ids and the distilled-guidance input, over the :class:`FluxTransformer`
backbone; the 2x2 pixel-shuffle latent `AutoEncoder` around an
:class:`~azula_tpu_torch.models.autoencoder.AutoencoderKL`, and the dual
CLIP + T5 `TextEncoder`; and `load_model`, which reads the transformer, VAE,
CLIP and T5 safetensors and the tokenizer files of a card's repository.
"""

from __future__ import annotations

__all__ = [
    "AutoEncoder",
    "FluxDenoiser",
    "FluxTransformer",
    "TextEncoder",
    "load_model",
]

import functools
import numpy as np
import torch

from torch import Tensor, nn

from ...denoise import Denoiser, DiracPosterior, time_scales
from ...nn.utils import get_module_dtype, skip_init
from ...noise import DecaySchedule, Schedule
from ..utils import check_manifest, load_cards, load_device, load_weights
from .backbone import FluxTransformer


class AutoEncoder(nn.Module):
    r"""Latent auto-encoder with 2x2 pixel-shuffle packing: images encode to
    :math:`(B, H/16, W/16, 64)` packed latents.

    Arguments:
        vae: A module with `encode(x) -> (mean, std)` and `decode(z) -> x`.
        shift: The latent shift factor (FLUX.1: 0.1159).
        scale: The latent scale factor (FLUX.1: 0.3611).
    """

    def __init__(self, vae: nn.Module, shift: float = 0.0, scale: float = 1.0) -> None:
        super().__init__()

        self.vae = vae
        self.shift = shift
        self.scale = scale

    def _normal(self, generator: torch.Generator | None, like: Tensor) -> Tensor:
        r"""Standard normal draws of `like`'s shape, dtype and device: the
        one draw of :meth:`encode`, where the tests inject JAX's."""

        return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)

    def encode(self, x: Tensor, generator: torch.Generator | None = None) -> Tensor:
        r"""Encodes images, channels-last, to packed latents sampled from the
        VAE's posterior with draws from `generator` (the JAX `key`)."""

        mean, std = self.vae.encode(x)
        z = mean + std * self._normal(generator, mean)
        z = (z - self.shift) * self.scale

        # 2x2 pixel shuffle: (B, h, w, c) -> (B, h/2, w/2, 4c), channels-last
        B, h, w, c = z.shape
        z = z.reshape(B, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)

        return z.reshape(B, h // 2, w // 2, 4 * c)

    def decode(self, z: Tensor) -> Tensor:
        r"""Decodes packed latents to images, channels-last."""

        B, h, w, c4 = z.shape
        c = c4 // 4

        z = z.reshape(B, h, w, c, 2, 2).permute(0, 1, 4, 2, 5, 3).reshape(B, 2 * h, 2 * w, c)
        z = z / self.scale + self.shift

        return self.vae.decode(z)


class TextEncoder(nn.Module):
    r"""Dual CLIP-pooled + T5 text encoder: CLIP's last hidden state pooled
    at the largest id of each row (its end-of-text token), and T5's last
    hidden state at `max_length` tokens.

    Arguments:
        clip: A CLIP text encoder (the last hidden state of ids).
        clip_tokenizer: The CLIP tokenizer.
        t5: A T5 encoder (the last hidden state of ids).
        t5_tokenizer: The T5 tokenizer.
        max_length: The T5 sequence length.
    """

    def __init__(self, clip: nn.Module, clip_tokenizer, t5: nn.Module, t5_tokenizer, max_length: int = 512) -> None:
        super().__init__()

        self.clip = clip
        self.clip_tokenizer = clip_tokenizer
        self.t5 = t5
        self.t5_tokenizer = t5_tokenizer
        self.max_length = max_length

    def forward(self, prompt: str | list[str]) -> dict[str, Tensor]:
        if isinstance(prompt, str):
            prompt = [prompt]

        clip_tokens = self.clip_tokenizer(
            prompt,
            truncation=True,
            max_length=self.clip_tokenizer.model_max_length,
            padding="max_length",
            return_tensors="np",
        )
        t5_tokens = self.t5_tokenizer(
            prompt,
            truncation=True,
            max_length=self.max_length,
            padding="max_length",
            return_tensors="np",
        )

        ids = torch.from_numpy(np.asarray(clip_tokens.input_ids)).to(next(self.clip.parameters()).device)
        clip_out = self.clip(ids)
        clip_out = clip_out[torch.arange(ids.shape[0], device=ids.device), ids.argmax(dim=-1)]

        ids = torch.from_numpy(np.asarray(t5_tokens.input_ids)).to(next(self.t5.parameters()).device)
        t5_out = self.t5(ids)

        return {"prompt_clip": clip_out, "prompt_t5": t5_out}


class FluxDenoiser(Denoiser):
    r"""Creates a Flux denoiser.

    Arguments:
        backbone: A time conditional network (diffusers Flux convention).
        schedule: A noise schedule. Defaults to :class:`DecaySchedule`.
    """

    def __init__(self, backbone: nn.Module, schedule: Schedule | None = None) -> None:
        super().__init__()

        self.backbone = backbone
        self.schedule = DecaySchedule() if schedule is None else schedule

    @staticmethod
    @functools.cache
    def coordinates(H: int, W: int) -> np.ndarray:
        r"""Cached (0, y, x) image-coordinate ids, with shape :math:`(H W, 3)`,
        float32 on the host."""

        z = np.zeros(1, dtype=np.float32)
        y = np.arange(H, dtype=np.float32)
        x = np.arange(W, dtype=np.float32)

        grid = np.stack(np.meshgrid(z, y, x, indexing="ij"), axis=-1)

        return grid.reshape(-1, 3)

    def forward(
        self,
        z_t: Tensor,
        t: Tensor,
        prompt_clip: Tensor,
        prompt_t5: Tensor,
        guidance: float | Tensor | None = 4.0,
        **kwargs,
    ) -> DiracPosterior:
        r"""
        Arguments:
            z_t: A noisy packed latent, with shape :math:`(B, H, W, 64)`.
            t: The time :math:`t`, with shape :math:`()` or :math:`(B)`.
            prompt_clip: CLIP-pooled prompt, with shape :math:`(B, F)`.
            prompt_t5: T5-encoded prompt, with shape :math:`(B, L, D)`.
            guidance: The distilled guidance strength.

        Returns:
            The Dirac delta :math:`\delta(Z - \mu_\phi(z_t \mid y))`.
        """

        _, alpha_t, sigma_t = time_scales(self.schedule, t, z_t)

        c_in = 1 / (alpha_t + sigma_t)
        c_out = -sigma_t / (alpha_t + sigma_t)
        c_skip = 1 / (alpha_t + sigma_t)
        c_time = (sigma_t / (alpha_t + sigma_t)).reshape(-1)

        B, H, W, C = z_t.shape
        L, D = prompt_t5.shape[-2:]

        # the backbone's inputs, the time, the ids and the guidance included,
        # are rounded to its dtype, as in the JAX package
        dtype = get_module_dtype(self.backbone)
        device = z_t.device

        img_ids = torch.tensor(self.coordinates(H, W), dtype=dtype, device=device)  # a copy of the cached array
        txt_ids = torch.zeros((L, 3), dtype=dtype, device=device)

        if guidance is not None:
            guidance = torch.broadcast_to(torch.as_tensor(guidance, dtype=dtype, device=device), (B,))

        output = self.backbone(
            timestep=torch.broadcast_to(c_time, (B,)).to(dtype),
            hidden_states=(c_in * z_t).to(dtype).reshape(B, H * W, C),
            encoder_hidden_states=torch.broadcast_to(prompt_t5.to(dtype), (B, L, D)),
            pooled_projections=prompt_clip.to(dtype),
            img_ids=img_ids,
            txt_ids=txt_ids,
            guidance=guidance,
            **kwargs,
        )
        output = output.reshape(z_t.shape).to(z_t.dtype)

        return DiracPosterior(mean=c_skip * z_t + c_out * output)


def load_model(
    name: str = "flux_1_dev", dtype: torch.dtype | None = torch.bfloat16, *, device=None
) -> tuple[FluxDenoiser, AutoEncoder, TextEncoder]:
    r"""Loads a pretrained Flux model from a card's repository.

    Port of :func:`azula_tpu.models.flux.load_model`: the (sharded)
    transformer, the VAE and the CLIP and T5 encoders are read from their
    safetensors (:func:`~azula_tpu_torch.models.utils.load_hub_safetensors`),
    held to the card's manifests and loaded into modules built by
    :func:`~azula_tpu_torch.nn.utils.skip_init`; the tokenizers are built by
    `transformers` from the repository's files.

    Arguments:
        name: The pretrained model name (see `cards.yaml`).
        dtype: The dtype of the modules (the checkpoints ship bfloat16).
        device: The device of the modules. Defaults to the card (`'cuda'`).

    Returns:
        A `(denoiser, autoencoder, textencoder)` triple.
    """

    from transformers import CLIPTokenizer, T5TokenizerFast

    from ...hub import download
    from ..utils import load_hub_safetensors
    from ..autoencoder import AutoencoderKL, canonicalize_vae_keys
    from ..clip import CLIPTextEncoder, canonicalize_clip_keys
    from ..t5 import T5Encoder, canonicalize_t5_keys
    from .backbone import FluxTransformer

    device = load_device(device)
    card = load_cards(__name__)[name]
    variant = getattr(card, "variant", None)
    base = f"https://huggingface.co/{card.repo}/resolve/main"

    def load(module, path, component, canonicalize=None):
        state = load_hub_safetensors(card.repo, path, variant)
        check_manifest(state, "flux", name, component, canonicalize=canonicalize)
        return load_weights(module, state, canonicalize, device=device, dtype=dtype)

    # dev is guidance-distilled, schnell is not
    transformer = skip_init(FluxTransformer, guidance_embeds="schnell" not in name)
    load(transformer, "transformer/diffusion_pytorch_model", "transformer")

    # 16 latent channels, no quant convs; the published shift and scale
    vae = skip_init(AutoencoderKL, latent_channels=16, use_quant_conv=False)
    load(vae, "vae/diffusion_pytorch_model", "vae", canonicalize_vae_keys)

    clip = load(skip_init(CLIPTextEncoder), "text_encoder/model", "text_encoder", canonicalize_clip_keys)
    t5 = load(skip_init(T5Encoder), "text_encoder_2/model", "text_encoder_2", canonicalize_t5_keys)

    clip_tokenizer = CLIPTokenizer(
        vocab_file=str(download(f"{base}/tokenizer/vocab.json")),
        merges_file=str(download(f"{base}/tokenizer/merges.txt")),
        model_max_length=clip.position_embedding.weight.shape[0],
    )
    t5_tokenizer = T5TokenizerFast(tokenizer_file=str(download(f"{base}/tokenizer_2/tokenizer.json")))

    return (
        FluxDenoiser(backbone=transformer),
        AutoEncoder(vae=vae, shift=0.1159, scale=0.3611),
        TextEncoder(clip=clip, clip_tokenizer=clip_tokenizer, t5=t5, t5_tokenizer=t5_tokenizer),
    )
