r"""Sana family.

Port of :mod:`azula_tpu.models.sana`: the `SanaDenoiser` (rectified-flow
preconditioning with :math:`c_\mathrm{time} \times 1000`) over the
:class:`SanaTransformer` backbone, the DC-AE (32x downsampling)
`AutoEncoder` wrapper, and the Gemma `TextEncoder` with the instruction
prefix and the selection of the last `max_length` tokens. `ARCHS` and
`CARD_ARCHS` give each card's transformer; `load_model` waits for
checkpoint and tokenizer files in the repository.
"""

from __future__ import annotations

__all__ = [
    "ARCHS",
    "CARD_ARCHS",
    "AutoEncoder",
    "SanaDenoiser",
    "SanaTransformer",
    "TextEncoder",
]

import numpy as np
import torch

from collections.abc import Sequence
from torch import Tensor, nn

from ...denoise import Denoiser, DiracPosterior, time_scales
from ...nn.utils import get_module_dtype
from ...noise import DecaySchedule, Schedule
from .backbone import SanaTransformer

# The prompt-enhancement instruction prefix of the Sana checkpoints, as
# they were trained with it
DEFAULT_INSTRUCTIONS = (
    "Given a user prompt, generate an 'Enhanced prompt' that provides detailed visual descriptions suitable for image generation. Evaluate the level of detail in the user prompt:",
    "- If the prompt is simple, focus on adding specifics about colors, shapes, sizes, textures, and spatial relationships to create vivid and concrete scenes.",
    "- If the prompt is already detailed, refine and enhance the existing details slightly without overcomplicating.",
    "Here are examples of how to transform or refine prompts:",
    "- User Prompt: A cat sleeping -> Enhanced: A small, fluffy white cat curled up in a round shape, sleeping peacefully on a warm sunny windowsill, surrounded by pots of blooming red flowers.",
    "- User Prompt: A busy city street -> Enhanced: A bustling city street scene at dusk, featuring glowing street lamps, a diverse crowd of people in colorful clothing, and a double-decker bus passing by towering glass skyscrapers.",
    "Please generate only the enhanced description for the prompt below and avoid including any additional commentary or evaluations:",
    "User Prompt: ",
)


class AutoEncoder(nn.Module):
    r"""DC-AE auto-encoder wrapper (32x downsampling, a deterministic encoder).

    Arguments:
        ae: A module with `encode(x) -> z` and `decode(z) -> x`.
        scale: The latent scale factor (Sana: 0.41407).
    """

    def __init__(self, ae: nn.Module, scale: float = 1.0) -> None:
        super().__init__()

        self.ae = ae
        self.scale = scale

    def encode(self, x: Tensor) -> Tensor:
        r"""Encodes images (pixel values in [-1, 1]) to scaled latents."""

        return self.ae.encode(x) * self.scale

    def decode(self, z: Tensor) -> Tensor:
        return self.ae.decode(z / self.scale)


class TextEncoder(nn.Module):
    r"""Gemma text encoder with the instruction prefix and the selection of
    the first and the last `max_length - 1` tokens.

    Arguments:
        gemma: A Gemma text model (the last hidden state of ids and a mask).
        tokenizer: The matching tokenizer (padding on the right).
        max_length: The number of prompt tokens kept.
    """

    def __init__(self, gemma: nn.Module, tokenizer, max_length: int = 300) -> None:
        super().__init__()

        self.gemma = gemma
        self.tokenizer = tokenizer
        self.tokenizer.padding_side = "right"
        self.max_length = max_length

    def forward(
        self, prompt: str | Sequence[str], instructions: Sequence[str] = DEFAULT_INSTRUCTIONS
    ) -> dict[str, Tensor]:
        if isinstance(prompt, str):
            prompt = [prompt]

        prompt = [text.lower().strip() for text in prompt]

        if instructions:
            chi = "\n".join(instructions)
            prompt = [chi + text if text else "" for text in prompt]
            max_length_all = self.max_length + len(self.tokenizer.encode(chi)) - 2
        else:
            max_length_all = self.max_length

        tokens = self.tokenizer(
            prompt,
            add_special_tokens=True,
            truncation=True,
            max_length=max_length_all,
            padding="max_length",
            return_tensors="np",
        )

        device = next(self.gemma.parameters()).device
        ids = torch.from_numpy(np.asarray(tokens.input_ids)).to(device)
        mask = torch.from_numpy(np.asarray(tokens.attention_mask)).to(device)

        prompt_embeds = self.gemma(ids, attention_mask=mask)

        select = [0, *range(max_length_all - self.max_length + 1, max_length_all)]

        return {
            "prompt_embeds": prompt_embeds[:, select],
            "prompt_mask": mask[:, select].to(prompt_embeds.dtype),
        }


class SanaDenoiser(Denoiser):
    r"""Creates a Sana denoiser.

    Arguments:
        backbone: A time conditional network (diffusers Sana convention).
        schedule: A noise schedule. Defaults to :class:`DecaySchedule`.
    """

    def __init__(self, backbone: nn.Module, schedule: Schedule | None = None) -> None:
        super().__init__()

        self.backbone = backbone
        self.schedule = DecaySchedule() if schedule is None else schedule

    def forward(
        self, z_t: Tensor, t: Tensor, prompt_embeds: Tensor, prompt_mask: Tensor, **kwargs
    ) -> DiracPosterior:
        r"""
        Arguments:
            z_t: A noisy latent, channels-last, with shape :math:`(B, H, W, C)`.
            t: The time :math:`t`, with shape :math:`()` or :math:`(B)`.
            prompt_embeds: The Gemma-encoded prompt, with shape :math:`(B, L, D)`.
            prompt_mask: The prompt's attention mask, with shape :math:`(B, L)`.

        Returns:
            The Dirac delta :math:`\delta(Z - \mu_\phi(z_t \mid y))`.
        """

        _, alpha_t, sigma_t = time_scales(self.schedule, t, z_t)

        c_in = 1 / (alpha_t + sigma_t)
        c_out = -sigma_t / (alpha_t + sigma_t)
        c_skip = 1 / (alpha_t + sigma_t)
        c_time = 1000 * (sigma_t / (alpha_t + sigma_t)).reshape(-1)

        B = z_t.shape[0]
        L, D = prompt_embeds.shape[-2:]

        # the backbone's inputs, the time and the mask included, are rounded
        # to its dtype, as in the JAX package
        dtype = get_module_dtype(self.backbone)

        output = self.backbone(
            timestep=torch.broadcast_to(c_time, (B,)).to(dtype),
            hidden_states=(c_in * z_t).to(dtype),
            encoder_hidden_states=torch.broadcast_to(prompt_embeds.to(dtype), (B, L, D)),
            encoder_attention_mask=torch.broadcast_to(prompt_mask.to(dtype), (B, L)),
            **kwargs,
        ).to(z_t.dtype)

        return DiracPosterior(mean=c_skip * z_t + c_out * output)


# The transformer of each model size (the diffusers config of the published
# checkpoints). SANA 1.5 adds across-heads q/k RMS normalization; its 4.8B
# model grows the depth (20 -> 60 layers) at the same width.
ARCHS = {
    "0.6b": dict(  # noqa: C408
        num_attention_heads=36,
        attention_head_dim=32,
        num_cross_attention_heads=16,
        cross_attention_head_dim=72,
        num_layers=28,
        mlp_ratio=2.5,
    ),
    "1.6b": dict(  # noqa: C408
        num_attention_heads=70,
        attention_head_dim=32,
        num_cross_attention_heads=20,
        cross_attention_head_dim=112,
        num_layers=20,
        mlp_ratio=2.5,
    ),
    "1.5-1.6b": dict(  # noqa: C408
        num_attention_heads=70,
        attention_head_dim=32,
        num_cross_attention_heads=20,
        cross_attention_head_dim=112,
        num_layers=20,
        mlp_ratio=2.5,
        qk_norm=True,
    ),
    "1.5-4.8b": dict(  # noqa: C408
        num_attention_heads=70,
        attention_head_dim=32,
        num_cross_attention_heads=20,
        cross_attention_head_dim=112,
        num_layers=60,
        mlp_ratio=2.5,
        qk_norm=True,
    ),
}

# The architecture of every card of `cards.yaml`
CARD_ARCHS = {
    "sana_0.6b_512": "0.6b",
    "sana_0.6b_1024": "0.6b",
    "sana_1.6b_512": "1.6b",
    "sana_1.6b_1024": "1.6b",
    "sana_1.6b_2048": "1.6b",
    "sana_1.6b_4096": "1.6b",
    "sana_1.5_1.6b_1024": "1.5-1.6b",
    "sana_1.5_4.8b_1024": "1.5-4.8b",
}
