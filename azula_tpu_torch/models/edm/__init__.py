r"""Elucidated diffusion model (EDM) family.

Port of :mod:`azula_tpu.models.edm`: the `ElucidatedDenoiser`
(:math:`x`-prediction with :math:`c_\mathrm{in} = 1/\alpha` and
:math:`c_\mathrm{time} = \sigma/\alpha`, rounded to the backbone's dtype)
over the NVlabs preconditioned backbones of :mod:`.backbone`, under the
:class:`~azula_tpu_torch.noise.ElucidatedSchedule` by default, and
`load_model`, which reads the NVlabs pickles of `cards.yaml`
(:mod:`.convert`).

References:
    | Elucidating the Design Space of Diffusion-Based Generative Models (Karras et al., 2022)
    | https://arxiv.org/abs/2206.00364
"""

from __future__ import annotations

__all__ = [
    "DhariwalUNet",
    "EDMPrecond",
    "ElucidatedDenoiser",
    "ElucidatedSchedule",
    "SongUNet",
    "VEPrecond",
    "VPPrecond",
    "load_model",
]

import torch

from torch import Tensor, nn

from ...denoise import Denoiser, DiracPosterior, time_scales
from ...hub import download
from ...nn.utils import get_module_dtype
from ...noise import ElucidatedSchedule, Schedule
from ..utils import load_cards, load_device
from .backbone import DhariwalUNet, EDMPrecond, SongUNet, VEPrecond, VPPrecond


class ElucidatedDenoiser(Denoiser):
    r"""Creates an elucidated denoiser.

    Arguments:
        backbone: A noise conditional network with the EDM calling convention
            `backbone(x, sigma, class_labels=...)`.
        schedule: A noise schedule. Defaults to :class:`ElucidatedSchedule`.
    """

    def __init__(self, backbone: nn.Module, schedule: Schedule | None = None) -> None:
        super().__init__()

        self.backbone = backbone
        self.schedule = ElucidatedSchedule() if schedule is None else schedule

    def forward(self, x_t: Tensor, t: Tensor, label: Tensor | None = None, **kwargs) -> DiracPosterior:
        r"""
        Arguments:
            x_t: A noisy tensor, channels-last, with shape :math:`(B, H, W, C)`.
            t: The time :math:`t`, with shape :math:`()` or :math:`(B)`.
            label: The class label as a one-hot vector, with shape :math:`(*, N)`.

        Returns:
            The Dirac delta :math:`\delta(X - \mu_\phi(x_t \mid c))`.
        """

        t, alpha_t, sigma_t = time_scales(self.schedule, t, x_t)

        c_in = 1 / alpha_t
        c_time = (sigma_t / alpha_t).reshape(t.shape)

        # the noise level is rounded to the backbone's dtype before the
        # precond takes it to float32, as in the JAX package
        dtype = get_module_dtype(self.backbone)

        mean = self.backbone(
            (c_in * x_t).to(dtype),
            c_time.to(dtype),
            class_labels=None if label is None else label.to(dtype),
            **kwargs,
        ).to(x_t.dtype)

        return DiracPosterior(mean=mean)


def load_model(name: str, dtype: torch.dtype | None = None, *, device=None) -> ElucidatedDenoiser:
    r"""Loads a pretrained EDM denoiser from its NVlabs pickle.

    Port of :func:`azula_tpu.models.edm.load_model`: the pickle is read
    without the NVlabs source tree and the architecture's hyperparameters
    come from the pickle itself
    (:func:`~azula_tpu_torch.models.edm.convert.build_from_pickle`).

    Arguments:
        name: The pretrained model name (see `cards.yaml`).
        dtype: The dtype of the backbone. Defaults to the checkpoint's.
        device: The device of the model. Defaults to the card (`'cuda'`).
    """

    from .convert import build_from_pickle

    device = load_device(device)
    card = load_cards(__name__)[name]

    backbone = build_from_pickle(download(card.url, hash_prefix=card.hash), device=device, dtype=dtype)

    return ElucidatedDenoiser(backbone=backbone)
