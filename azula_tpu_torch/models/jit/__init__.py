r"""Just image Transformer (JiT) family.

Port of :mod:`azula_tpu.models.jit`: the `JITDenoiser` (x-prediction on
pixels under the rectified flow, :math:`c_\mathrm{in} = 1 / (\alpha +
\sigma)`, :math:`c_\mathrm{time} = \alpha / (\alpha + \sigma)`, the null
label `num_classes`) over the `JiT` of :mod:`.backbone`, `make_model`, and
`load_model`, which reads the checkpoint archives of `cards.yaml`.

References:
    | Back to Basics: Let Denoising Generative Models Denoise (Li et al., 2025)
    | https://arxiv.org/abs/2511.13720
"""

from __future__ import annotations

__all__ = [
    "JIT_CONFIGS",
    "JITDenoiser",
    "JiT",
    "load_model",
    "make_model",
]

import os
import torch

from torch import Tensor

from ...denoise import Denoiser, DiracPosterior, time_scales
from ...hub import download
from ...nn.utils import default_device, get_module_dtype, skip_init
from ...noise import RectifiedSchedule, Schedule
from ..ptread import load_pt
from ..utils import check_manifest, load_cards, load_device, load_weights
from .backbone import JIT_CONFIGS, JiT


class JITDenoiser(Denoiser):
    r"""Creates a JiT denoiser.

    Arguments:
        backbone: A time and class conditional network, `backbone(x, t, y)`.
        schedule: A noise schedule. Defaults to :class:`RectifiedSchedule`.
        num_classes: The number of classes (the null label's index).
    """

    def __init__(self, backbone: JiT, schedule: Schedule | None = None, num_classes: int = 1000) -> None:
        super().__init__()

        self.backbone = backbone
        self.schedule = RectifiedSchedule() if schedule is None else schedule
        self.num_classes = num_classes

    def forward(self, x_t: Tensor, t: Tensor, label: Tensor | None = None, **kwargs) -> DiracPosterior:
        r"""
        Arguments:
            x_t: A noisy tensor, channels-last, with shape :math:`(B, H, W, 3)`.
            t: The time :math:`t`, with shape :math:`()` or :math:`(B)`.
            label: The class label as an integer, with shape :math:`()` or
                :math:`(B)`; the null label where none.

        Returns:
            The Dirac delta :math:`\delta(X - \mu_\phi(x_t \mid c))`.
        """

        _, alpha_t, sigma_t = time_scales(self.schedule, t, x_t)

        c_in = 1 / (alpha_t + sigma_t)
        c_time = (alpha_t / (alpha_t + sigma_t)).reshape(-1)

        B = x_t.shape[0]
        dtype = get_module_dtype(self.backbone)

        if label is None:
            label = torch.full((B,), self.num_classes, dtype=torch.long, device=x_t.device)
        else:
            label = torch.broadcast_to(torch.as_tensor(label, device=x_t.device), (B,))

        output = self.backbone(
            (c_in * x_t).to(dtype), torch.broadcast_to(c_time, (B,)).to(dtype), y=label, **kwargs
        ).to(x_t.dtype)

        return DiracPosterior(mean=output)


def make_model(
    model: str = "JiT-B/16",
    *,
    device=None,
    dtype=None,
    generator: torch.Generator | None = None,
    **kwargs,
) -> JITDenoiser:
    r"""Initializes a JiT denoiser from its config's name (`JIT_CONFIGS`).

    Arguments:
        model: The config's name.
        device: The device of the model. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters. Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`);
            defaults to one seeded with 0 on `device`.
        kwargs: Overrides of the config (`input_size`, `num_classes`, ...).
    """

    device = default_device(device)

    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)

    backbone = JiT(**{**JIT_CONFIGS[model], **kwargs}, device=device, dtype=dtype, generator=generator)

    return JITDenoiser(backbone, num_classes=backbone.num_classes)


def load_model(name: str, ema: bool = True, dtype: torch.dtype | None = None, *, device=None) -> JITDenoiser:
    r"""Loads a pretrained JiT denoiser from its checkpoint archive.

    Port of :func:`azula_tpu.models.jit.load_model`: the card's archive is
    downloaded and extracted; its `checkpoint-last.pth` is read by
    :func:`~azula_tpu_torch.models.ptread.load_pt`, the EMA (`model_ema1`)
    or trained (`model`) weights taken with their `net.` prefix stripped,
    held to the card's manifest, and loaded into a model built by
    :func:`~azula_tpu_torch.nn.utils.skip_init` (whose RoPE tables are
    computed, not read).

    Arguments:
        name: The pretrained model name (see `cards.yaml`).
        ema: Whether to load the EMA weights.
        dtype: The dtype of the backbone. Defaults to the checkpoint's.
        device: The device of the model. Defaults to the card (`'cuda'`).
    """

    device = load_device(device)
    card = load_cards(__name__)[name]

    archive = download(card.url, hash_prefix=card.hash, extract=True)

    state = load_pt(os.path.join(archive, "checkpoint-last.pth"))
    state = state["model_ema1" if ema else "model"]
    state = {k.removeprefix("net."): v for k, v in state.items()}
    check_manifest(state, "jit", name, "model")

    denoiser = skip_init(make_model, **card.config)
    load_weights(denoiser.backbone, state, device=device, dtype=dtype)

    return denoiser.to(device)
