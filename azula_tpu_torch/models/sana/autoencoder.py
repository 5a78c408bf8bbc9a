r"""DC-AE (deep-compression autoencoder), channels-last.

Port of :mod:`azula_tpu.models.sana.autoencoder` (diffusers ``AutoencoderDC``
semantics, the ``dc-ae-f32c32-sana`` codec of the Sana checkpoints: 32x
spatial downsampling into 32 latent channels):

- ResBlock towers (conv-SiLU-conv with a channel RMSNorm) at high resolution;
- EfficientViT blocks at low resolution: multiscale ReLU attention over a
  fused-QKV channel grouping, linear when :math:`HW > d` and quadratic
  otherwise, accumulated in float32, then a gated MobileNet FFN (GLUMBConv);
- stride-2 convolutions with pixel-unshuffle channel-averaging shortcuts;
- nearest-x2 + convolution upsampling in the decoder (the Sana variant), or
  a pixel-shuffled convolution, each with a channel-duplicating shortcut;
- residual latent projections (group average in, channel duplication out).

The encoder is deterministic. No GroupNorm: no kernel of this port runs
here. The state dict's keys are the checkpoint's (`vae/` of diffusers),
which are the manifests'; the JAX package's `convert_dcae_state_dict` loads
it as it is.
"""

from __future__ import annotations

__all__ = [
    "AutoencoderDC",
    "from_jax_state_dict",
]

import numpy as np
import torch
import torch.nn.functional as F

from collections.abc import Mapping, Sequence
from torch import Tensor, nn

from ...nn.layers import Conv, Linear
from ...nn.utils import default_device
from ..utils import from_jax_arrays
from .backbone import depthwise


def _conv(in_ch: int, out_ch: int, k: int = 3, stride: int = 1, bias: bool = True, **factory) -> Conv:
    pad = (k - 1) // 2
    return Conv(
        in_ch, out_ch, kernel_size=(k, k), stride=(stride, stride), padding=((pad, pad), (pad, pad)), bias=bias,
        **factory,
    )


def _pixel_unshuffle(x: Tensor, r: int) -> Tensor:
    r"""Channels-last pixel unshuffle, :math:`(B, Hr, Wr, C) \to (B, H, W, C r^2)`,
    with torch's channel order :math:`c r^2 + i r + j`."""

    B, Hr, Wr, C = x.shape
    H, W = Hr // r, Wr // r
    x = x.reshape(B, H, r, W, r, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, H, W, C * r * r)


def _pixel_shuffle(x: Tensor, r: int) -> Tensor:
    r"""Channels-last pixel shuffle, :math:`(B, H, W, C r^2) \to (B, Hr, Wr, C)`."""

    B, H, W, Cr2 = x.shape
    C = Cr2 // (r * r)
    x = x.reshape(B, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, C)


class RMSNorm2d(nn.Module):
    r"""Channel RMSNorm with a learned scale and bias (diffusers `RMSNorm`
    with ``elementwise_affine=True, bias=True``): float32 statistics over the
    channel (last) axis, the affine in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None, dtype=None, generator=None) -> None:
        super().__init__()

        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        h = x.float()
        h = (h * torch.rsqrt(torch.square(h).mean(dim=-1, keepdim=True) + self.eps)).to(x.dtype)

        return h * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class DCResBlock(nn.Module):
    r"""conv3x3 - SiLU - conv3x3 (no bias) - RMSNorm, with an identity residual."""

    def __init__(self, in_channels: int, out_channels: int, **factory) -> None:
        super().__init__()

        self.conv1 = _conv(in_channels, in_channels, **factory)
        self.conv2 = _conv(in_channels, out_channels, bias=False, **factory)
        self.norm = RMSNorm2d(out_channels, **factory)

    def forward(self, x: Tensor) -> Tensor:
        return x + self.norm(self.conv2(F.silu(self.conv1(x))))


class DCGLUMBConv(nn.Module):
    r"""Gated MobileNet FFN with a trailing RMSNorm and a residual: 1x1
    expansion (4x), 3x3 depthwise, SiLU-gated GLU, 1x1 projection (no bias),
    RMSNorm."""

    def __init__(self, dim: int, expand_ratio: float = 4.0, **factory) -> None:
        super().__init__()

        hidden = int(dim * expand_ratio)

        self.conv_inverted = Conv(dim, 2 * hidden, kernel_size=(1, 1), **factory)
        self.conv_depth = Conv(1, 2 * hidden, kernel_size=(3, 3), padding=((1, 1), (1, 1)), **factory)
        self.conv_point = Conv(hidden, dim, kernel_size=(1, 1), bias=False, **factory)
        self.norm = RMSNorm2d(dim, **factory)

    def forward(self, x: Tensor) -> Tensor:
        h = F.silu(self.conv_inverted(x))
        h = depthwise(h, self.conv_depth) + self.conv_depth.bias.to(h.dtype)

        h, gate = h.chunk(2, dim=-1)
        h = h * F.silu(gate)

        return x + self.norm(self.conv_point(h))


class SanaMultiscaleAttentionProjection(nn.Module):
    r"""One aggregation scale of the multiscale attention: a k x k depthwise
    convolution over the fused QKV channels, then a grouped (one group per
    d channels) 1x1 convolution; both without bias."""

    def __init__(self, inner_dim: int, num_heads: int, kernel_size: int, **factory) -> None:
        super().__init__()

        channels = 3 * inner_dim
        pad = kernel_size // 2

        self.groups = 3 * num_heads
        self.proj_in = Conv(
            1, channels, kernel_size=(kernel_size, kernel_size), padding=((pad, pad), (pad, pad)), bias=False,
            **factory,
        )
        self.proj_out = Conv(channels // self.groups, channels, kernel_size=(1, 1), bias=False, **factory)

    def forward(self, qkv: Tensor) -> Tensor:
        return depthwise(depthwise(qkv, self.proj_in), self.proj_out, groups=self.groups)


class SanaMultiscaleLinearAttention(nn.Module):
    r"""Multiscale ReLU attention (diffusers `SanaMultiscaleLinearAttention`,
    efficientvit `LiteMLA`): Q, K, V as one fused channel block
    ``[q | k | v]``, each aggregation scale appending a filtered copy; the
    whole regrouped into blocks of :math:`3 d` channels, each split into
    thirds. Linear attention when :math:`HW > d`, quadratic otherwise, both
    accumulated in float32."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        head_dim: int = 32,
        mult: float = 1.0,
        kernel_sizes: Sequence[int] = (5,),
        eps: float = 1e-15,
        **factory,
    ) -> None:
        super().__init__()

        heads = int(in_channels // head_dim * mult)
        inner = heads * head_dim

        self.head_dim = head_dim
        self.eps = eps

        self.to_q = Linear(in_channels, inner, bias=False, **factory)
        self.to_k = Linear(in_channels, inner, bias=False, **factory)
        self.to_v = Linear(in_channels, inner, bias=False, **factory)

        self.to_qkv_multiscale = nn.ModuleList([
            SanaMultiscaleAttentionProjection(inner, heads, k, **factory) for k in kernel_sizes
        ])

        self.to_out = Linear(inner * (1 + len(kernel_sizes)), out_channels, bias=False, **factory)
        self.norm_out = RMSNorm2d(out_channels, **factory)

    def forward(self, x: Tensor) -> Tensor:
        B, H, W, _ = x.shape
        d = self.head_dim
        L = H * W

        qkv = torch.cat([self.to_q(x), self.to_k(x), self.to_v(x)], dim=-1)
        qkv = torch.cat([qkv, *(block(qkv) for block in self.to_qkv_multiscale)], dim=-1)

        # regroup: channels -> (groups, 3 d), each group split into thirds
        n = qkv.shape[-1] // (3 * d)
        qkv = qkv.reshape(B, L, n, 3 * d)
        q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]

        # the inputs' products summed in float32 (JAX's preferred_element_type)
        q, k = F.relu(q).float(), F.relu(k).float()

        if L > d:  # linear: O(L d^2)
            v1 = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1).float()
            scores = torch.einsum("blnd,blne->bnde", k, v1)
            out = torch.einsum("blnd,bnde->blne", q, scores)
            out = out[..., :-1] / (out[..., -1:] + self.eps)
        else:  # quadratic: O(L^2 d)
            att = torch.einsum("bmnd,blnd->bnml", k, q)
            att = att / (att.sum(dim=2, keepdim=True) + self.eps)
            out = torch.einsum("bmnd,bnml->blnd", v.float(), att)

        out = out.reshape(B, H, W, -1).to(x.dtype)

        return x + self.norm_out(self.to_out(out))


class EfficientViTBlock(nn.Module):
    r"""Multiscale linear attention, then GLUMBConv, each with its residual."""

    def __init__(self, in_channels: int, head_dim: int = 32, qkv_multiscales: Sequence[int] = (5,), **factory) -> None:
        super().__init__()

        self.attn = SanaMultiscaleLinearAttention(
            in_channels, in_channels, head_dim=head_dim, kernel_sizes=qkv_multiscales, **factory
        )
        self.conv_out = DCGLUMBConv(in_channels, **factory)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv_out(self.attn(x))


class DCDownBlock2d(nn.Module):
    r"""2x downsampling: a stride-2 convolution plus a pixel-unshuffle
    channel-averaging shortcut."""

    def __init__(self, in_channels: int, out_channels: int, **factory) -> None:
        super().__init__()

        self.conv = _conv(in_channels, out_channels, stride=2, **factory)
        self.group_size = in_channels * 4 // out_channels
        self.out_channels = out_channels

    def forward(self, x: Tensor) -> Tensor:
        y = _pixel_unshuffle(x, 2)
        y = y.reshape(*y.shape[:-1], self.out_channels, self.group_size).mean(dim=-1)

        return self.conv(x) + y


class DCUpBlock2d(nn.Module):
    r"""2x upsampling with a channel-duplicating pixel-shuffle shortcut: nearest
    interpolation then a convolution (`interpolate`, the Sana variant), or a
    convolution to :math:`4 C_o` channels, pixel-shuffled."""

    def __init__(
        self, in_channels: int, out_channels: int, interpolate: bool = True, shortcut: bool = True, **factory
    ) -> None:
        super().__init__()

        self.interpolate = interpolate
        self.shortcut = shortcut
        self.repeats = out_channels * 4 // in_channels
        self.conv = _conv(in_channels, out_channels if interpolate else 4 * out_channels, **factory)

    def forward(self, x: Tensor) -> Tensor:
        if self.interpolate:
            h = self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
        else:
            h = _pixel_shuffle(self.conv(x), 2)

        if self.shortcut:
            h = h + _pixel_shuffle(x.repeat_interleave(self.repeats, dim=-1), 2)

        return h


def _make_block(block_type: str, channels: int, head_dim: int, qkv_multiscales: Sequence[int], **factory) -> nn.Module:
    if block_type == "ResBlock":
        return DCResBlock(channels, channels, **factory)
    if block_type == "EfficientViTBlock":
        return EfficientViTBlock(channels, head_dim=head_dim, qkv_multiscales=qkv_multiscales, **factory)
    raise ValueError(f"unknown block type '{block_type}'")


class DCEncoder(nn.Module):
    r"""conv-in, stages of blocks with 2x downsampling, and a group-averaged
    residual projection to the latent channels."""

    def __init__(
        self,
        in_channels: int,
        latent_channels: int,
        block_types: Sequence[str],
        block_out_channels: Sequence[int],
        layers_per_block: Sequence[int],
        qkv_multiscales: Sequence[Sequence[int]],
        head_dim: int = 32,
        **factory,
    ) -> None:
        super().__init__()

        if layers_per_block[0] <= 0:
            raise ValueError("depth-0 first stages are not supported")

        n = len(block_out_channels)

        self.conv_in = _conv(in_channels, block_out_channels[0], **factory)

        self.down_blocks = nn.ModuleList()
        for i, (ch, depth) in enumerate(zip(block_out_channels, layers_per_block, strict=True)):
            stage = [_make_block(block_types[i], ch, head_dim, qkv_multiscales[i], **factory) for _ in range(depth)]
            if i < n - 1 and depth > 0:
                stage.append(DCDownBlock2d(ch, block_out_channels[i + 1], **factory))
            self.down_blocks.append(nn.ModuleList(stage))

        self.conv_out = _conv(block_out_channels[-1], latent_channels, **factory)
        self.group_size = block_out_channels[-1] // latent_channels
        self.latent_channels = latent_channels

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv_in(x)

        for stage in self.down_blocks:
            for block in stage:
                h = block(h)

        y = h.reshape(*h.shape[:-1], self.latent_channels, self.group_size).mean(dim=-1)

        return self.conv_out(h) + y


class DCDecoder(nn.Module):
    r"""conv-in with a channel-duplicating residual, stages of blocks with 2x
    upsampling (run deep to shallow), and an RMSNorm-ReLU-conv head."""

    def __init__(
        self,
        in_channels: int,
        latent_channels: int,
        block_types: Sequence[str],
        block_out_channels: Sequence[int],
        layers_per_block: Sequence[int],
        qkv_multiscales: Sequence[Sequence[int]],
        head_dim: int = 32,
        upsample_interpolate: bool = True,
        **factory,
    ) -> None:
        super().__init__()

        if layers_per_block[0] <= 0:
            raise ValueError("depth-0 first stages are not supported")

        n = len(block_out_channels)

        self.conv_in = _conv(latent_channels, block_out_channels[-1], **factory)
        self.repeats = block_out_channels[-1] // latent_channels

        # up_blocks[i] = [upsampling from stage i + 1, blocks...], run in reverse
        self.up_blocks = nn.ModuleList()
        for i, (ch, depth) in enumerate(zip(block_out_channels, layers_per_block, strict=True)):
            stage = []
            if i < n - 1 and depth > 0:
                stage.append(DCUpBlock2d(block_out_channels[i + 1], ch, interpolate=upsample_interpolate, **factory))
            stage.extend(_make_block(block_types[i], ch, head_dim, qkv_multiscales[i], **factory) for _ in range(depth))
            self.up_blocks.append(nn.ModuleList(stage))

        self.norm_out = RMSNorm2d(block_out_channels[0], **factory)
        self.conv_out = _conv(block_out_channels[0], in_channels, **factory)

    def forward(self, z: Tensor) -> Tensor:
        h = self.conv_in(z) + z.repeat_interleave(self.repeats, dim=-1)

        for stage in reversed(self.up_blocks):
            for block in stage:
                h = block(h)

        return self.conv_out(F.relu(self.norm_out(h)))


class AutoencoderDC(nn.Module):
    r"""The deep-compression autoencoder (diffusers ``AutoencoderDC``
    semantics; the defaults are ``dc-ae-f32c32-sana-1.x``).

    The encoder is deterministic: :meth:`encode` returns the latent itself.
    The latent scale lives in :class:`~azula_tpu_torch.models.sana.AutoEncoder`.

    Arguments:
        in_channels: Image channels.
        latent_channels: Latent channels.
        block_types: Each stage's block type (`'ResBlock'` or `'EfficientViTBlock'`).
        block_out_channels: Each stage's width.
        encoder_layers_per_block, decoder_layers_per_block: Each stage's depth.
        qkv_multiscales: Each stage's attention aggregation kernel sizes.
        head_dim: The attention's head dimension.
        upsample_interpolate: The decoder's upsampling (Sana: interpolation).
        device: The parameters' device; the card unless another is named.
        dtype, generator: The parameters' dtype and initial-value generator.
    """

    def __init__(
        self,
        in_channels: int = 3,
        latent_channels: int = 32,
        block_types: Sequence[str] = (
            "ResBlock",
            "ResBlock",
            "ResBlock",
            "EfficientViTBlock",
            "EfficientViTBlock",
            "EfficientViTBlock",
        ),
        block_out_channels: Sequence[int] = (128, 256, 512, 512, 1024, 1024),
        encoder_layers_per_block: Sequence[int] = (2, 2, 2, 3, 3, 3),
        decoder_layers_per_block: Sequence[int] = (3, 3, 3, 3, 3, 3),
        qkv_multiscales: Sequence[Sequence[int]] = ((), (), (), (5,), (5,), (5,)),
        head_dim: int = 32,
        upsample_interpolate: bool = True,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408

        self.encoder = DCEncoder(
            in_channels, latent_channels, block_types, block_out_channels, encoder_layers_per_block, qkv_multiscales,
            head_dim, **factory,
        )
        self.decoder = DCDecoder(
            in_channels, latent_channels, block_types, block_out_channels, decoder_layers_per_block, qkv_multiscales,
            head_dim, upsample_interpolate, **factory,
        )

    def encode(self, x: Tensor) -> Tensor:
        r"""Encodes images to latents, :math:`(B, H, W, 3) \to (B, H/32, W/32, 32)`."""

        return self.encoder(x)

    def decode(self, z: Tensor) -> Tensor:
        r"""Decodes latents to images, :math:`(B, h, w, 32) \to (B, 32h, 32w, 3)`."""

        return self.decoder(z)


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts the state dict of a JAX `AutoencoderDC` (numpy arrays) to the
    port's layout: RMSNorm `scale` -> `weight`, Linear weights transposed,
    convolution kernels (the depthwise and grouped ones included) to
    :math:`(C_o, C_i / G, k, k)`."""

    return from_jax_arrays(sd, module)
