r"""Ablated diffusion model (ADM / guided-diffusion) family.

Port of :mod:`azula_tpu.models.adm`: the `AblatedDenoiser` wrapper that maps
the continuous-time denoiser API onto the checkpoints' discrete
epsilon-prediction parametrization, `make_model` over the card configs of
`cards.yaml`, and `load_model`, which reads a guided-diffusion checkpoint.

References:
    | Diffusion Models Beat GANs on Image Synthesis (Dhariwal et al., 2021)
    | https://arxiv.org/abs/2105.05233
"""

from __future__ import annotations

__all__ = [
    "ADMUNet",
    "AblatedDenoiser",
    "discrete_sigmas",
    "load_model",
    "make_model",
]

import numpy as np
import torch

from collections.abc import Sequence
from torch import Tensor

from ...denoise import Denoiser, GaussianPosterior, time_scales
from ...hub import download
from ...nn.utils import default_device, get_module_dtype, skip_init, table_device
from ...noise import Schedule, VPSchedule
from ..ptread import load_pt
from ..utils import check_manifest, load_cards, load_device, load_weights
from .backbone import ADMUNet
from .convert import canonicalize_adm_keys


def discrete_sigmas(schedule: str = "linear", steps: int = 1000) -> np.ndarray:
    r"""Returns the discrete noise-level table :math:`\sigma_i = \sqrt{1 -
    \bar\alpha_i}` of the checkpoints' beta schedule, in float64 on the host
    (float64 matters for the cumprod)."""

    if schedule == "linear":
        beta = np.linspace(0.1 / steps, 20.0 / steps, steps, dtype=np.float64)
    elif schedule == "cosine":
        t = np.linspace(0, 1, steps + 1, dtype=np.float64)
        alpha_bar = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        beta = 1 - alpha_bar[1:] / alpha_bar[:-1]
        beta = np.clip(beta, None, 0.999)
    else:
        raise ValueError(f"Unknown discrete schedule '{schedule}'.")

    alpha_bar = np.cumprod(1 - beta)

    return np.sqrt(1 - alpha_bar)


class AblatedDenoiser(Denoiser):
    r"""Creates an ablated (epsilon-prediction) denoiser.

    Continuous time maps to the checkpoint's discrete timestep by searching the
    noise ratio in the `sigmas` table; preconditioning is
    :math:`c_\mathrm{out} = -\sigma/\alpha`, :math:`c_\mathrm{skip} = 1/\alpha`.

    Arguments:
        backbone: A time conditional network.
        schedule: A noise schedule. Defaults to `VPSchedule(1e-2, 1e-2)`.
        clip_mean: Whether the posterior mean is clipped to :math:`[-1, 1]`.
        learn_var: Whether the variance is learned (doubled output channels).
        discrete_schedule: The checkpoint's beta schedule (`'linear'`/`'cosine'`).
        discrete_steps: The checkpoint's number of discrete steps.
    """

    def __init__(
        self,
        backbone: ADMUNet,
        schedule: Schedule | None = None,
        clip_mean: bool = False,
        learn_var: bool = False,
        discrete_schedule: str = "linear",
        discrete_steps: int = 1000,
    ) -> None:
        super().__init__()

        self.backbone = backbone

        if schedule is None:
            self.schedule = VPSchedule(alpha_min=1e-2, sigma_min=1e-2)
        else:
            self.schedule = schedule

        self.clip_mean = clip_mean
        self.learn_var = learn_var

        device = table_device(next(backbone.parameters()).device)
        sigmas = discrete_sigmas(discrete_schedule, discrete_steps)
        self.register_buffer(
            "sigmas",
            torch.as_tensor(sigmas, dtype=torch.float64, device=device),
            persistent=False,
        )

    def discrete_time(self, t: Tensor) -> Tensor:
        r"""The checkpoint's discrete timestep index of each time: a left
        search (as `jnp.searchsorted`) of the noise ratio
        :math:`\sigma_t / \sqrt{\alpha_t^2 + \sigma_t^2}` in the `sigmas`
        table, flattened.

        The ratio is computed in float64. Table entries lie as close as two
        float32 ulps to the ratio of some times (t = 1 and 0.75 of DDIM-4),
        where float32 exp and rsqrt, which differ between the CPU and the
        card, would pick either neighbour; in float64 the pick is the exact
        one on every device.
        """

        alpha_t, sigma_t = self.schedule(torch.as_tensor(t).to(torch.float64))
        c_time = sigma_t / torch.sqrt(alpha_t**2 + sigma_t**2)
        return torch.searchsorted(self.sigmas, c_time.reshape(-1).to(self.sigmas.device))

    def forward(
        self,
        x_t: Tensor,
        t: Tensor,
        label: Tensor | None = None,
        generator: torch.Generator | None = None,
        **kwargs,
    ) -> GaussianPosterior:
        r"""
        Arguments:
            x_t: A noisy tensor, channels-last, with shape :math:`(B, H, W, 3)`.
            t: The time :math:`t`, with shape :math:`()` or :math:`(B)`.
            label: The class label as an integer, with shape :math:`(B)`.

        Returns:
            The Gaussian posterior
            :math:`\mathcal{N}(X \mid \mu_\phi(x_t \mid c), \sigma^2_\phi(x_t \mid c))`.
        """

        _, alpha_t, sigma_t = time_scales(self.schedule, t, x_t)

        c_in = torch.rsqrt(alpha_t**2 + sigma_t**2)
        c_out = -sigma_t / alpha_t
        c_skip = 1 / alpha_t
        c_time = self.discrete_time(t)
        c_var = sigma_t**2 / (alpha_t**2 + sigma_t**2)

        dtype = get_module_dtype(self.backbone)

        output = self.backbone(
            (c_in * x_t).to(dtype),
            c_time,
            y=label,
            generator=generator,
            **kwargs,
        ).to(x_t.dtype)

        if self.learn_var:
            output, log_var = output.chunk(2, dim=-1)
            mean = c_skip * x_t + c_out * output
            var = c_var * torch.exp(log_var)
        else:
            mean = c_skip * x_t + c_out * output
            var = c_var

        if self.clip_mean:
            mean = torch.clip(mean, min=-1.0, max=1.0)

        return GaussianPosterior(mean=mean, var=var)


def make_model(
    # Denoiser
    clip_mean: bool = True,
    learn_var: bool = True,
    # Discrete schedule
    discrete_schedule: str = "linear",
    discrete_steps: int = 1000,
    # Data
    image_channels: int = 3,
    image_size: int = 64,
    # Backbone
    attention_resolutions: Sequence[int] = (32, 16, 8),
    channel_mult: Sequence[int] = (1, 2, 3, 4),
    num_channels: int = 128,
    num_classes: int | None = None,
    *,
    device=None,
    dtype=None,
    generator: torch.Generator | None = None,
    **kwargs,
) -> AblatedDenoiser:
    r"""Initializes an ADM denoiser from card-config hyperparameters.

    Arguments:
        device: The device of the model. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters. Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`);
            defaults to one seeded with 0 on `device`.
    """

    device = default_device(device)

    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)

    # Cards list attention *image sizes*; the backbone wants downsample rates
    ds_rates = {image_size // r for r in attention_resolutions}

    backbone = ADMUNet(
        image_size=image_size,
        in_channels=image_channels,
        out_channels=2 * image_channels if learn_var else image_channels,
        model_channels=num_channels,
        channel_mult=tuple(channel_mult),
        num_classes=num_classes,
        attention_resolutions=ds_rates,
        device=device,
        dtype=dtype,
        generator=generator,
        **kwargs,
    )

    return AblatedDenoiser(
        backbone,
        clip_mean=clip_mean,
        learn_var=learn_var,
        discrete_schedule=discrete_schedule,
        discrete_steps=discrete_steps,
    )


def load_model(name: str, dtype: torch.dtype | None = None, *, device=None) -> AblatedDenoiser:
    r"""Loads a pretrained ADM denoiser from its guided-diffusion checkpoint.

    Port of :func:`azula_tpu.models.adm.load_model`: the card's file is
    downloaded (and its hash checked), read by
    :func:`~azula_tpu_torch.models.ptread.load_pt`, held to the card's
    manifest, and loaded, its keys renamed by
    :func:`~azula_tpu_torch.models.adm.convert.canonicalize_adm_keys`, into
    a model built by :func:`~azula_tpu_torch.nn.utils.skip_init`.

    Arguments:
        name: The pretrained model name (see `cards.yaml`).
        dtype: The dtype of the backbone (e.g. `torch.bfloat16`). Defaults to
            the checkpoint's.
        device: The device of the model. Defaults to the card (`'cuda'`).
    """

    device = load_device(device)
    card = load_cards(__name__)[name]

    state = load_pt(download(card.url, hash_prefix=card.hash))
    check_manifest(state, "adm", name, "model")

    denoiser = skip_init(make_model, **card.config)
    load_weights(denoiser.backbone, state, canonicalize_adm_keys, device=device, dtype=dtype)

    return denoiser.to(device)
