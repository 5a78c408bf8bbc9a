r"""EDM2 magnitude-preserving UNet, channels-last.

Port of :mod:`azula_tpu.models.eldm.backbone`: the architecture inside the
NVlabs/edm2 checkpoints (Karras et al., 2024, "Analyzing and Improving the
Training Dynamics of Diffusion Models"), in which every operation preserves
magnitudes: weight-normalized convolutions (:class:`MPConv`, normalized in
float32 at every call), `mp_silu` / `mp_sum` / `mp_cat` activations and
merges, pixel-normalized encoder states and attention vectors, and learned
scalar gains. There is no GroupNorm and no call to the port's kernels: the
self-attention is inline (float32 softmax), as in JAX.

The state dict's keys are the NVlabs checkpoints' (`enc.64x64_block0.conv_res0.weight`,
`emb_gain`, `out_gain`, the Fourier buffers `emb_fourier.freqs` and
`emb_fourier.phases`), which the JAX package's `convert_eldm_state_dict`
maps onto its own; :mod:`.convert` maps the JAX arrays here.
"""

from __future__ import annotations

__all__ = [
    "EDM2Precond",
    "EDM2UNet",
    "mp_cat",
    "mp_silu",
    "mp_sum",
    "normalize",
]

import math
import torch
import torch.nn.functional as F

from collections.abc import Sequence
from torch import Tensor, nn

from ...nn.utils import default_device
from ..edm.backbone import _nchw


def normalize(x: Tensor, dim: int | Sequence[int] | None = None, eps: float = 1e-4) -> Tensor:
    r"""Magnitude-preserving normalization (NVlabs `normalize`): scales by the
    RMS magnitude over `dim` (all but the first by default) with an epsilon
    floor, in float32."""

    if dim is None:
        dim = tuple(range(1, x.ndim))
    dims = (dim,) if isinstance(dim, int) else tuple(dim)

    h = x.float()
    norm = torch.sqrt(torch.sum(torch.square(h), dim=dims, keepdim=True))

    n_norm = math.prod(x.shape[d] for d in dims)
    norm = eps + norm * math.sqrt(1 / n_norm)

    return (h / norm).to(x.dtype)


def mp_silu(x: Tensor) -> Tensor:
    return F.silu(x) / 0.596


def mp_sum(a: Tensor, b: Tensor, t: float = 0.5) -> Tensor:
    return (a + t * (b - a)) / math.sqrt((1 - t) ** 2 + t**2)


def mp_cat(a: Tensor, b: Tensor, t: float = 0.5) -> Tensor:
    Na, Nb = a.shape[-1], b.shape[-1]
    C = math.sqrt((Na + Nb) / ((1 - t) ** 2 + t**2))
    wa = C / math.sqrt(Na) * (1 - t)
    wb = C / math.sqrt(Nb) * t

    return torch.cat([wa * a, wb * b], dim=-1)


class MPFourier(nn.Module):
    r"""Magnitude-preserving Fourier features; the frequencies and phases
    are the buffers `freqs` and `phases`."""

    def __init__(
        self, num_channels: int, bandwidth: float = 1.0, *, device=None, dtype=None, generator=None
    ) -> None:
        super().__init__()

        freqs = torch.empty(num_channels, device=device, dtype=dtype).normal_(generator=generator)
        phases = torch.empty(num_channels, device=device, dtype=dtype).uniform_(generator=generator)
        self.register_buffer("freqs", 2 * math.pi * freqs * bandwidth)
        self.register_buffer("phases", 2 * math.pi * phases)

    def forward(self, x: Tensor) -> Tensor:
        y = x.float()[..., None] * self.freqs.float()
        y = torch.cos(y + self.phases.float()) * math.sqrt(2)

        return y.to(x.dtype)


class MPConv(nn.Module):
    r"""Weight-normalized convolution (`kernel` of two sizes) or linear
    (`kernel` empty) with magnitude-preserving scaling. The weight is the
    checkpoint's :math:`(C_o, C_i, *k)`, normalized per output channel in
    float32 at every call, then scaled by :math:`g / \sqrt{\text{fan in}}`
    and rounded to the input's dtype."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel: Sequence[int],
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        w = torch.empty((out_channels, in_channels, *kernel), device=device, dtype=dtype)
        self.weight = nn.Parameter(w.normal_(generator=generator))

    def forward(self, x: Tensor, gain: Tensor | float = 1.0) -> Tensor:
        w = normalize(self.weight.float())
        w = w * (gain / math.sqrt(math.prod(w.shape[1:])))
        w = w.to(x.dtype)

        if w.ndim == 2:
            return F.linear(x, w)

        return _nchw(F.conv2d, x, w, padding=w.shape[-1] // 2)


def _resample(x: Tensor, f: Sequence[int], mode: str) -> Tensor:
    if mode == "keep":
        return x

    fv = torch.as_tensor(f, dtype=torch.float32, device=x.device)
    fv = fv / fv.sum()

    C = x.shape[-1]
    pad = (len(f) - 1) // 2
    w = torch.outer(fv, fv).to(x.dtype).repeat(C, 1, 1, 1)

    if mode == "down":
        return _nchw(F.conv2d, x, w, stride=2, padding=pad, groups=C)

    # up: the transposed convolution with the (symmetric) filter, gain 4
    return _nchw(F.conv_transpose2d, x, 4 * w, stride=2, padding=pad, groups=C)


class EDM2Block(nn.Module):
    r"""The EDM2 `Block`: resample, (enc) skip + pixel norm, MP residual
    branch with gained embedding modulation, MP attention, activation
    clipping."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        emb_channels: int,
        flavor: str = "enc",
        resample_mode: str = "keep",
        resample_filter: Sequence[int] = (1, 1),
        attention: bool = False,
        channels_per_head: int = 64,
        res_balance: float = 0.3,
        attn_balance: float = 0.3,
        clip_act: float = 256.0,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.flavor = flavor
        self.resample_mode = resample_mode
        self.resample_filter = tuple(resample_filter)
        self.num_heads = out_channels // channels_per_head if attention else 0
        self.res_balance = res_balance
        self.attn_balance = attn_balance
        self.clip_act = clip_act
        self.out_channels = out_channels

        self.emb_gain = nn.Parameter(torch.zeros((), device=device, dtype=dtype))
        self.conv_res0 = MPConv(out_channels if flavor == "enc" else in_channels, out_channels, (3, 3), **factory)
        self.emb_linear = MPConv(emb_channels, out_channels, (), **factory)
        self.conv_res1 = MPConv(out_channels, out_channels, (3, 3), **factory)
        self.conv_skip = MPConv(in_channels, out_channels, (1, 1), **factory) if in_channels != out_channels else None

        if self.num_heads:
            self.attn_qkv = MPConv(out_channels, 3 * out_channels, (1, 1), **factory)
            self.attn_proj = MPConv(out_channels, out_channels, (1, 1), **factory)

    def forward(self, x: Tensor, emb: Tensor) -> Tensor:
        x = _resample(x, self.resample_filter, self.resample_mode)

        if self.flavor == "enc":
            if self.conv_skip is not None:
                x = self.conv_skip(x)
            x = normalize(x, dim=-1)  # pixel norm over channels

        y = self.conv_res0(mp_silu(x))
        c = self.emb_linear(emb, gain=self.emb_gain) + 1
        y = mp_silu(y * c[:, None, None, :].to(y.dtype))
        y = self.conv_res1(y)

        if self.flavor == "dec" and self.conv_skip is not None:
            x = self.conv_skip(x)

        x = mp_sum(x, y, t=self.res_balance)

        if self.num_heads:
            B, H, W, C = x.shape
            nh = self.num_heads
            ch = C // nh

            # checkpoint channel layout: (head, channel, qkv) over the 3C axis
            y = normalize(self.attn_qkv(x).reshape(B, H * W, nh, ch, 3), dim=3)
            q, k, v = y.unbind(-1)

            logits = torch.einsum("bqhc,bkhc->bhqk", q, k) / math.sqrt(ch)
            w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
            a = torch.einsum("bhqk,bkhc->bqhc", w, v).reshape(B, H, W, C)

            x = mp_sum(x, self.attn_proj(a), t=self.attn_balance)

        if self.clip_act is not None:
            x = torch.clip(x, -self.clip_act, self.clip_act)

        return x


class EDM2UNet(nn.Module):
    r"""The EDM2 UNet (NVlabs `UNet` in networks_edm2.py), channels-last.

    Arguments:
        device: The parameters' device; the card unless another is named.
        dtype, generator: The parameters' dtype and initial-value generator.
        block_kwargs: The blocks' other settings (`resample_filter`,
            `channels_per_head`, `res_balance`, `attn_balance`, `clip_act`).
    """

    def __init__(
        self,
        img_resolution: int,
        img_channels: int,
        label_dim: int = 0,
        model_channels: int = 192,
        channel_mult: Sequence[int] = (1, 2, 3, 4),
        channel_mult_noise: int | None = None,
        channel_mult_emb: int | None = None,
        num_blocks: int = 3,
        attn_resolutions: Sequence[int] = (16, 8),
        label_balance: float = 0.5,
        concat_balance: float = 0.5,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
        **block_kwargs,
    ) -> None:
        super().__init__()

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408
        block_kwargs = {**block_kwargs, **factory}

        cblock = [model_channels * m for m in channel_mult]
        cnoise = model_channels * channel_mult_noise if channel_mult_noise else cblock[0]
        cemb = model_channels * channel_mult_emb if channel_mult_emb else max(cblock)

        self.label_balance = label_balance
        self.concat_balance = concat_balance

        self.out_gain = nn.Parameter(torch.zeros((), device=factory["device"], dtype=dtype))
        self.emb_fourier = MPFourier(cnoise, **factory)
        self.emb_noise = MPConv(cnoise, cemb, (), **factory)
        self.emb_label = MPConv(label_dim, cemb, (), **factory) if label_dim else None

        self.enc = nn.ModuleDict()
        cout = img_channels + 1  # a constant ones-channel is concatenated
        for level, channels in enumerate(cblock):
            res = img_resolution >> level
            if level == 0:
                cin, cout = cout, channels
                self.enc[f"{res}x{res}_conv"] = MPConv(cin, cout, (3, 3), **factory)
            else:
                self.enc[f"{res}x{res}_down"] = EDM2Block(
                    cout, cout, cemb, flavor="enc", resample_mode="down", **block_kwargs
                )
            for idx in range(num_blocks):
                cin, cout = cout, channels
                self.enc[f"{res}x{res}_block{idx}"] = EDM2Block(
                    cin, cout, cemb, flavor="enc", attention=(res in attn_resolutions), **block_kwargs
                )

        skips = [b.out_channels if isinstance(b, EDM2Block) else b.weight.shape[0] for b in self.enc.values()]

        self.dec = nn.ModuleDict()
        for level, channels in reversed(list(enumerate(cblock))):
            res = img_resolution >> level
            if level == len(cblock) - 1:
                self.dec[f"{res}x{res}_in0"] = EDM2Block(cout, cout, cemb, flavor="dec", attention=True, **block_kwargs)
                self.dec[f"{res}x{res}_in1"] = EDM2Block(cout, cout, cemb, flavor="dec", **block_kwargs)
            else:
                self.dec[f"{res}x{res}_up"] = EDM2Block(
                    cout, cout, cemb, flavor="dec", resample_mode="up", **block_kwargs
                )
            for idx in range(num_blocks + 1):
                cin = cout + skips.pop()
                cout = channels
                self.dec[f"{res}x{res}_block{idx}"] = EDM2Block(
                    cin, cout, cemb, flavor="dec", attention=(res in attn_resolutions), **block_kwargs
                )

        self.out_conv = MPConv(cout, img_channels, (3, 3), **factory)

    def forward(self, x: Tensor, noise_labels: Tensor, class_labels: Tensor | None = None) -> Tensor:
        emb = self.emb_noise(self.emb_fourier(noise_labels))

        if self.emb_label is not None and class_labels is not None:
            scale = math.sqrt(class_labels.shape[-1])
            emb = mp_sum(emb, self.emb_label(class_labels.to(emb.dtype) * scale), t=self.label_balance)

        emb = mp_silu(emb).to(x.dtype)

        x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)

        skips = []
        for name, block in self.enc.items():
            x = block(x) if "conv" in name else block(x, emb)
            skips.append(x)

        for name, block in self.dec.items():
            if "block" in name:
                x = mp_cat(x, skips.pop(), t=self.concat_balance)
            x = block(x, emb)

        return self.out_conv(x, gain=self.out_gain)


class EDM2Precond(nn.Module):
    r"""The EDM2 `Precond`: EDM preconditioning around :class:`EDM2UNet`, in
    float32 around the network's dtype; a conditional network without
    labels gets zero one-hots."""

    def __init__(self, unet: EDM2UNet, label_dim: int = 0, sigma_data: float = 0.5) -> None:
        super().__init__()

        self.unet = unet
        self.label_dim = label_dim
        self.sigma_data = sigma_data

    def forward(self, x: Tensor, sigma: Tensor | float, class_labels: Tensor | None = None, **kwargs) -> Tensor:
        sigma = torch.atleast_1d(torch.as_tensor(sigma, dtype=torch.float32, device=x.device)).expand(x.shape[0])
        sigma = sigma[:, None, None, None]

        if self.label_dim and class_labels is None:
            class_labels = torch.zeros((x.shape[0], self.label_dim), dtype=x.dtype, device=x.device)

        sd2 = self.sigma_data**2
        c_skip = sd2 / (sigma**2 + sd2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma**2 + sd2)
        c_in = 1 / torch.sqrt(sd2 + sigma**2)
        c_noise = torch.log(sigma.reshape(-1)) / 4

        out = self.unet((c_in * x.float()).to(x.dtype), c_noise, class_labels=class_labels, **kwargs)

        return c_skip * x.float() + c_out * out.float()
