r"""Variational image autoencoder (AutoencoderKL), channels-last.

Port of :mod:`azula_tpu.models.autoencoder` (diffusers ``AutoencoderKL``
semantics): the latent codec of the Flux family (and of SD and ELDM, not
ported yet). Encoder and decoder resnet towers with a single-head attention
mid block; moments are returned as `(mean, std)`.

Every `GroupNorm(32, C, eps=1e-6)` goes through
:func:`~azula_tpu_torch.ops.norm.group_norm`, on the card the GroupNorm
kernel; SiLU is a separate `F.silu` after it, as the JAX package applies
`jax.nn.silu` after the norm. The mid-block attention is a plain float32
softmax over all positions, as there.

The state dict's keys are the checkpoint's (`vae/` of diffusers) in the
canonical space of :func:`canonicalize_vae_keys`, which is that of the
manifests; the JAX package's `convert_vae_state_dict` loads it as it is.
"""

from __future__ import annotations

__all__ = [
    "AutoencoderKL",
    "canonicalize_vae_keys",
    "from_jax_state_dict",
]

import math
import numpy as np
import re
import torch
import torch.nn.functional as F

from collections.abc import Mapping, Sequence
from torch import Tensor, nn

from ..nn.layers import Conv, GroupNorm, Linear
from ..nn.utils import default_device
from .utils import from_jax_arrays


def _conv(in_ch: int, out_ch: int, k: int = 3, stride: int = 1, padding=None, **factory) -> Conv:
    pad = (k - 1) // 2
    padding = ((pad, pad), (pad, pad)) if padding is None else padding
    return Conv(in_ch, out_ch, kernel_size=(k, k), stride=(stride, stride), padding=padding, **factory)


def _norm(channels: int, device=None, dtype=None, generator=None) -> GroupNorm:
    return GroupNorm(32, channels, eps=1e-6, affine=True, device=device, dtype=dtype)


class VAEResnetBlock(nn.Module):
    r"""GN-SiLU-conv twice with a 1x1 shortcut (no time conditioning), eps 1e-6."""

    def __init__(self, in_channels: int, out_channels: int, **factory) -> None:
        super().__init__()

        self.norm1 = _norm(in_channels, **factory)
        self.conv1 = _conv(in_channels, out_channels, **factory)
        self.norm2 = _norm(out_channels, **factory)
        self.conv2 = _conv(out_channels, out_channels, **factory)

        if in_channels != out_channels:
            self.conv_shortcut = Conv(in_channels, out_channels, kernel_size=(1, 1), **factory)
        else:
            self.conv_shortcut = None

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))

        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)

        return skip + h


class VAEAttention(nn.Module):
    r"""Single-head attention over spatial positions with GroupNorm and a
    residual (the diffusers VAE mid-block attention): logits in the input
    dtype, the softmax in float32."""

    def __init__(self, channels: int, **factory) -> None:
        super().__init__()

        self.group_norm = _norm(channels, **factory)
        self.to_q = Linear(channels, channels, **factory)
        self.to_k = Linear(channels, channels, **factory)
        self.to_v = Linear(channels, channels, **factory)
        self.to_out = nn.ModuleList([Linear(channels, channels, **factory)])

    def forward(self, x: Tensor) -> Tensor:
        B, H, W, C = x.shape

        h = self.group_norm(x).reshape(B, H * W, C)

        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)

        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(C)
        weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        del logits
        a = torch.matmul(weights, v)

        return x + self.to_out[0](a).reshape(B, H, W, C)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, **factory) -> None:
        super().__init__()

        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, **factory) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, **factory)])

    def forward(self, x: Tensor) -> Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class VAEDownBlock(nn.Module):
    r"""`layers` resnets and an optional stride-2 downsampler with asymmetric
    (0, 1) padding (diffusers `DownEncoderBlock2D`)."""

    def __init__(self, in_channels: int, out_channels: int, layers: int, add_downsample: bool, **factory) -> None:
        super().__init__()

        self.resnets = nn.ModuleList([
            VAEResnetBlock(in_channels if i == 0 else out_channels, out_channels, **factory) for i in range(layers)
        ])

        if add_downsample:
            self.downsamplers = nn.ModuleList([
                _conv(out_channels, out_channels, stride=2, padding=((0, 1), (0, 1)), **factory)
            ])
        else:
            self.downsamplers = None

    def forward(self, x: Tensor) -> Tensor:
        for resnet in self.resnets:
            x = resnet(x)

        if self.downsamplers is not None:
            x = self.downsamplers[0](x)

        return x


class VAEUpBlock(nn.Module):
    r"""`layers` resnets and an optional nearest-x2 upsampler followed by a
    convolution (diffusers `UpDecoderBlock2D`)."""

    def __init__(self, in_channels: int, out_channels: int, layers: int, add_upsample: bool, **factory) -> None:
        super().__init__()

        self.resnets = nn.ModuleList([
            VAEResnetBlock(in_channels if i == 0 else out_channels, out_channels, **factory) for i in range(layers)
        ])

        if add_upsample:
            self.upsamplers = nn.ModuleList([_conv(out_channels, out_channels, **factory)])
        else:
            self.upsamplers = None

    def forward(self, x: Tensor) -> Tensor:
        for resnet in self.resnets:
            x = resnet(x)

        if self.upsamplers is not None:
            x = x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
            x = self.upsamplers[0](x)

        return x


class VAEEncoder(nn.Module):
    def __init__(
        self,
        in_channels: int,
        latent_channels: int,
        block_out_channels: Sequence[int],
        layers_per_block: int,
        **factory,
    ) -> None:
        super().__init__()

        n = len(block_out_channels)

        self.conv_in = _conv(in_channels, block_out_channels[0], **factory)

        self.down_blocks = nn.ModuleList()
        ch = block_out_channels[0]
        for i, out_ch in enumerate(block_out_channels):
            self.down_blocks.append(VAEDownBlock(ch, out_ch, layers_per_block, i < n - 1, **factory))
            ch = out_ch

        self.mid_block = VAEMidBlock(ch, **factory)
        self.conv_norm_out = _norm(ch, **factory)
        self.conv_out = _conv(ch, 2 * latent_channels, **factory)

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv_in(x)

        for block in self.down_blocks:
            h = block(h)

        h = self.mid_block(h)
        h = F.silu(self.conv_norm_out(h))

        return self.conv_out(h)


class VAEDecoder(nn.Module):
    def __init__(
        self,
        out_channels: int,
        latent_channels: int,
        block_out_channels: Sequence[int],
        layers_per_block: int,
        **factory,
    ) -> None:
        super().__init__()

        n = len(block_out_channels)
        reversed_out = tuple(reversed(block_out_channels))

        self.conv_in = _conv(latent_channels, reversed_out[0], **factory)
        self.mid_block = VAEMidBlock(reversed_out[0], **factory)

        self.up_blocks = nn.ModuleList()
        ch = reversed_out[0]
        for i, out_ch in enumerate(reversed_out):
            self.up_blocks.append(VAEUpBlock(ch, out_ch, layers_per_block + 1, i < n - 1, **factory))
            ch = out_ch

        self.conv_norm_out = _norm(ch, **factory)
        self.conv_out = _conv(ch, out_channels, **factory)

    def forward(self, z: Tensor) -> Tensor:
        h = self.conv_in(z)
        h = self.mid_block(h)

        for block in self.up_blocks:
            h = block(h)

        h = F.silu(self.conv_norm_out(h))

        return self.conv_out(h)


class AutoencoderKL(nn.Module):
    r"""The KL-regularized image autoencoder, channels-last.

    Defaults correspond to the SD VAE (f8, 4 latent channels); Flux uses
    ``latent_channels=16, use_quant_conv=False``.

    Arguments:
        in_channels: Image channels.
        latent_channels: Latent channels.
        block_out_channels: Channels per resolution level.
        layers_per_block: Encoder resnets per level (the decoder uses one more).
        use_quant_conv: Whether the 1x1 quant convolutions exist.
        device: The parameters' device; the card unless another is named.
        dtype, generator: The parameters' dtype and initial-value generator.
    """

    def __init__(
        self,
        in_channels: int = 3,
        latent_channels: int = 4,
        block_out_channels: Sequence[int] = (128, 256, 512, 512),
        layers_per_block: int = 2,
        use_quant_conv: bool = True,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408

        self.encoder = VAEEncoder(in_channels, latent_channels, block_out_channels, layers_per_block, **factory)
        self.decoder = VAEDecoder(in_channels, latent_channels, block_out_channels, layers_per_block, **factory)

        if use_quant_conv:
            self.quant_conv = Conv(2 * latent_channels, 2 * latent_channels, kernel_size=(1, 1), **factory)
            self.post_quant_conv = Conv(latent_channels, latent_channels, kernel_size=(1, 1), **factory)
        else:
            self.quant_conv = None
            self.post_quant_conv = None

    def encode(self, x: Tensor) -> tuple[Tensor, Tensor]:
        r"""Encodes images to latent moments `(mean, std)`, channels-last."""

        moments = self.encoder(x)

        if self.quant_conv is not None:
            moments = self.quant_conv(moments)

        mean, logvar = moments.chunk(2, dim=-1)
        logvar = logvar.clamp(-30.0, 20.0)

        return mean, torch.exp(0.5 * logvar)

    def decode(self, z: Tensor) -> Tensor:
        r"""Decodes latents to images, channels-last."""

        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)

        return self.decoder(z)


def canonicalize_vae_keys(sd: Mapping) -> dict:
    r"""Renames diffusers `AutoencoderKL` keys to the canonical space of the
    manifests and of this module's state dict, covering both attention key
    generations (`to_q/to_k/to_v/to_out.0` and the legacy
    `query/key/value/proj_attn`). Key-only; values pass through."""

    legacy = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}

    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if len(parts) >= 2 and parts[-2] in legacy:
            k = ".".join(parts[:-2] + [legacy[parts[-2]], parts[-1]])
        k = k.replace("downsamplers.0.conv.", "downsamplers.0.")
        k = k.replace("upsamplers.0.conv.", "upsamplers.0.")
        out[k] = v

    return out


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts the state dict of a JAX `AutoencoderKL` (numpy arrays) to the
    port's layout: GroupNorm `scale` -> `weight`, the attention's `to_out` ->
    `to_out.0`, Linear and convolution weights to PyTorch's layouts.

    Arguments:
        sd: The JAX state dict.
        module: Optionally, the port's module, to hold the result to.
    """

    return from_jax_arrays(sd, module, rename=lambda key: re.sub(r"(^|\.)to_out\.", r"\1to_out.0.", key))
