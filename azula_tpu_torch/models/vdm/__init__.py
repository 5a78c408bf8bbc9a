r"""Velocity diffusion model (VDM, crowsonkb v-diffusion) family.

Port of :mod:`azula_tpu.models.vdm`: the `VelocityDenoiser` (v-prediction,
:math:`c_\mathrm{time} = \mathrm{atan2}(\sigma, \alpha) \cdot 2 / \pi`)
over the declarative `VDMUNet` of :mod:`.backbone` or the CLIP-conditioned
`CC12M1Model` of :mod:`.cc12m`, `make_model`, and `load_model`, which
reads the checkpoints of `cards.yaml`.

References:
    | https://github.com/crowsonkb/v-diffusion-pytorch
"""

from __future__ import annotations

__all__ = [
    "SPECS",
    "CC12M1Model",
    "VDMSpec",
    "VDMUNet",
    "VelocityDenoiser",
    "load_model",
    "make_model",
]

import math
import torch

from torch import Tensor, nn

from ...denoise import Denoiser, DiracPosterior, time_scales
from ...hub import download
from ...nn.utils import default_device, get_module_dtype, skip_init
from ...noise import Schedule, VPSchedule
from ..ptread import load_pt
from ..utils import check_manifest, load_cards, load_device, load_weights
from .backbone import SPECS, VDMSpec, VDMUNet
from .cc12m import CC12M1Model


class VelocityDenoiser(Denoiser):
    r"""Creates a velocity (v-prediction) denoiser:
    :math:`c_\mathrm{in} = 1 / \sqrt{\alpha^2 + \sigma^2}`,
    :math:`c_\mathrm{out} = -\sigma / \sqrt{\alpha^2 + \sigma^2}`,
    :math:`c_\mathrm{skip} = \alpha / \sqrt{\alpha^2 + \sigma^2}`.

    Arguments:
        backbone: A time conditional network, `backbone(x, t, **kwargs)`.
        schedule: A noise schedule. Defaults to `VPSchedule(1e-2, 1e-2)`.
    """

    def __init__(self, backbone: nn.Module, schedule: Schedule | None = None) -> None:
        super().__init__()

        self.backbone = backbone
        self.schedule = VPSchedule(alpha_min=1e-2, sigma_min=1e-2) if schedule is None else schedule

    def forward(self, x_t: Tensor, t: Tensor, **kwargs) -> DiracPosterior:
        r"""
        Arguments:
            x_t: A noisy tensor, channels-last, with shape :math:`(B, H, W, C)`.
            t: The time :math:`t`, with shape :math:`()` or :math:`(B)`.
            kwargs: The backbone's conditions (CC12M-1's `clip_embed`).

        Returns:
            The Dirac delta :math:`\delta(X - \mu_\phi(x_t))`.
        """

        _, alpha_t, sigma_t = time_scales(self.schedule, t, x_t)

        c_in = torch.rsqrt(alpha_t**2 + sigma_t**2)
        c_out = -sigma_t * torch.rsqrt(alpha_t**2 + sigma_t**2)
        c_skip = alpha_t * torch.rsqrt(alpha_t**2 + sigma_t**2)
        c_time = torch.atan2(sigma_t, alpha_t).reshape(-1) / math.pi * 2

        # the time is rounded to the backbone's dtype before the backbone
        # takes it to float32, as in the JAX package
        dtype = get_module_dtype(self.backbone)

        output = self.backbone((c_in * x_t).to(dtype), c_time.to(dtype), **kwargs).to(x_t.dtype)

        return DiracPosterior(mean=c_skip * x_t + c_out * output)


def make_model(
    model: str = "imagenet_128",
    *,
    device=None,
    dtype=None,
    generator: torch.Generator | None = None,
) -> VelocityDenoiser:
    r"""Initializes a VDM denoiser from its spec's name (`SPECS`), or the
    CLIP-conditioned `CC12M1Model` (`'cc12m_1'`, `'cc12m_1_cfg'`).

    Arguments:
        model: The spec's name.
        device: The device of the model. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters. Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`);
            defaults to one seeded with 0 on `device`.
    """

    device = default_device(device)

    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)

    factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

    if model in ("cc12m_1", "cc12m_1_cfg"):
        backbone = CC12M1Model(**factory)
    else:
        backbone = VDMUNet(SPECS[model], **factory)

    return VelocityDenoiser(backbone)


def load_model(name: str, dtype: torch.dtype | None = None, *, device=None) -> VelocityDenoiser:
    r"""Loads a pretrained v-diffusion denoiser from its checkpoint.

    Port of :func:`azula_tpu.models.vdm.load_model`: the card's file is
    downloaded (and its hash checked), read by
    :func:`~azula_tpu_torch.models.ptread.load_pt`, held to the card's
    manifest, and loaded into a model built by
    :func:`~azula_tpu_torch.nn.utils.skip_init`.

    Arguments:
        name: The pretrained model name (see `cards.yaml`).
        dtype: The dtype of the backbone. Defaults to the checkpoint's.
        device: The device of the model. Defaults to the card (`'cuda'`).
    """

    device = load_device(device)
    card = load_cards(__name__)[name]

    state = load_pt(download(card.url, hash_prefix=card.hash))
    check_manifest(state, "vdm", name, "model")

    denoiser = skip_init(make_model, **card.config)
    load_weights(denoiser.backbone, state, device=device, dtype=dtype)

    return denoiser.to(device)
