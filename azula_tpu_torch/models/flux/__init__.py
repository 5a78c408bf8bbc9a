r"""Flux family.

Port of :mod:`azula_tpu.models.flux`: the `FluxDenoiser` (rectified-flow
preconditioning :math:`c_\mathrm{in} = c_\mathrm{skip} = 1/(\alpha+\sigma)`,
:math:`c_\mathrm{out} = -\sigma/(\alpha+\sigma)`), with cached image-coordinate
ids and the distilled-guidance input, over the :class:`FluxTransformer`
backbone. The text encoders, the auto-encoder and `load_model` are not
ported yet.
"""

from __future__ import annotations

__all__ = [
    "FluxDenoiser",
    "FluxTransformer",
]

import functools
import numpy as np
import torch

from torch import Tensor, nn

from ...denoise import Denoiser, DiracPosterior, time_scales
from ...nn.utils import get_module_dtype
from ...noise import DecaySchedule, Schedule
from .backbone import FluxTransformer


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
