r"""Velocity-diffusion (crowsonkb v-diffusion) backbones, channels-last.

Port of :mod:`azula_tpu.models.vdm.backbone`: one declarative builder for
the family, each model a :class:`VDMSpec` (channel plan, block counts,
attention levels, upsampling mode, time parametrization) from which the
recursive U-Net is generated.

The containers mirror the checkpoints' `net.*` Sequential indices: a
parameter-free stage (ReLU, identity, the 2 x 2 mean that downsamples, the
nearest or bilinear upsampling) is a module without parameters at its index
(:class:`VDMStage`), so the state dict's keys are the checkpoints'
(`net.4.main.1.main.0.weight`, `timestep_embed.weight`) with PyTorch's
layouts, which the JAX package's `convert_state_dict` loads. The attention
blocks (:class:`VDMSelfAttention2d`) go through
:func:`~azula_tpu_torch.ops.attention.dot_product_attention`, on the card
the attention kernel at heads of 64 and 128; the yfcc models' attention
pre-norm is a single-group GroupNorm of up to 2048 channels, on the card the
GroupNorm kernel with a group spanning bands.
"""

from __future__ import annotations

__all__ = [
    "SPECS",
    "FourierFeatures",
    "VDMSelfAttention2d",
    "VDMSkipBlock",
    "VDMResConvBlock",
    "VDMSpec",
    "VDMStage",
    "VDMUNet",
]

import dataclasses
import math
import torch
import torch.nn.functional as F

from collections.abc import Sequence
from torch import Tensor, nn

from ...nn.layers import Conv, GroupNorm
from ...ops.attention import dot_product_attention
from ...ops.norm import group_norm


@dataclasses.dataclass(frozen=True)
class VDMSpec:
    r"""Declarative description of a v-diffusion CNN.

    Arguments:
        cs: Channels per resolution level (outermost first).
        blocks: Residual blocks per level (down and up each).
        inner: Residual blocks at the innermost level.
        attn: Levels with self-attention after every block.
        head_dim: Attention head width.
        final_act: Whether the last block keeps its trailing ReLU.
        t_input: Time parametrization fed to the Fourier features
            (`'log_snr'` or `'t'`).
        up: Upsampling mode (`'nearest'` or `'bilinear'`).
        std: Fourier-feature initialization scale.
        attn_norm: Whether attention inputs are pre-normalized (yfcc).
    """

    cs: tuple
    blocks: int
    inner: int
    attn: tuple
    head_dim: int
    final_act: bool
    t_input: str
    up: str
    std: float
    attn_norm: bool = False


# the JAX package's specs (`azula_tpu/models/vdm/backbone.py`)
SPECS = {
    "danbooru_128": VDMSpec(
        cs=(256, 512, 512, 1024, 1024, 2048),
        blocks=2, inner=4, attn=(3, 4, 5), head_dim=128,
        final_act=True, t_input="log_snr", up="nearest", std=0.2,
    ),
    "imagenet_128": VDMSpec(
        cs=(128, 256, 256, 512, 512, 1024),
        blocks=4, inner=8, attn=(3, 4, 5), head_dim=128,
        final_act=False, t_input="log_snr", up="nearest", std=0.2,
    ),
    "wikiart_128": VDMSpec(
        cs=(128, 256, 256, 512, 512, 1024),
        blocks=4, inner=8, attn=(), head_dim=128,
        final_act=True, t_input="log_snr", up="nearest", std=0.2,
    ),
    "wikiart_256": VDMSpec(
        cs=(64, 128, 256, 256, 512, 512, 1024),
        blocks=4, inner=8, attn=(4, 5, 6), head_dim=128,
        final_act=False, t_input="log_snr", up="nearest", std=0.2,
    ),
    "yfcc_1": VDMSpec(
        cs=(128, 128, 256, 256, 512, 512, 1024, 1024),
        blocks=4, inner=8, attn=(5, 6, 7), head_dim=64,
        final_act=False, t_input="t", up="bilinear", std=1.0, attn_norm=True,
    ),
    "yfcc_2": VDMSpec(
        cs=(128, 256, 512, 512, 1024, 1024, 2048, 2048),
        blocks=2, inner=4, attn=(5, 6, 7), head_dim=64,
        final_act=False, t_input="t", up="bilinear", std=1.0, attn_norm=True,
    ),
}


def _conv(cin: int, cout: int, kernel: int, bias: bool = True, **factory) -> Conv:
    pad = kernel // 2
    return Conv(cin, cout, kernel_size=(kernel, kernel), padding=((pad, pad), (pad, pad)), bias=bias, **factory)


def _down(x: Tensor) -> Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


def _up(x: Tensor, mode: str) -> Tensor:
    if mode == "nearest":
        return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    # `jax.image.resize(..., "bilinear")` upsampling: half-pixel centers, the
    # edge rows and columns the edge's own (no antialiasing up)
    y = F.interpolate(x.movedim(-1, 1), scale_factor=2, mode="bilinear", align_corners=False)
    return y.movedim(1, -1)


class VDMStage(nn.Module):
    r"""A parameter-free stage of a checkpoint's Sequential, at its index:
    `'relu'`, `'identity'`, `'down'` (the 2 x 2 mean), `'up'` (nearest or
    bilinear, `up_mode`) or `'gn1'` (a single-group GroupNorm without affine,
    CC12M-1's)."""

    def __init__(self, kind: str, up_mode: str = "nearest") -> None:
        super().__init__()

        if kind not in ("relu", "identity", "down", "up", "gn1"):
            raise ValueError(f"unknown stage '{kind}'")

        self.kind = kind
        self.up_mode = up_mode

    def forward(self, x: Tensor) -> Tensor:
        if self.kind == "relu":
            return F.relu(x)
        if self.kind == "down":
            return _down(x)
        if self.kind == "up":
            return _up(x, self.up_mode)
        if self.kind == "gn1":
            return group_norm(x, 1)
        return x

    def extra_repr(self) -> str:
        return self.kind + (f", {self.up_mode}" if self.kind == "up" else "")


class FourierFeatures(nn.Module):
    r"""Random Fourier features :math:`[\cos(2\pi x W^\top), \sin(2\pi x W^\top)]`;
    `weight` is :math:`(C_o / 2, C_i)`, as in the checkpoints."""

    def __init__(
        self, in_features: int, out_features: int, std: float = 1.0, *, device=None, dtype=None, generator=None
    ) -> None:
        super().__init__()

        assert out_features % 2 == 0

        w = torch.empty((out_features // 2, in_features), device=device, dtype=dtype)
        w.normal_(generator=generator)
        self.weight = nn.Parameter(w * std)

    def forward(self, x: Tensor) -> Tensor:
        f = 2 * math.pi * x @ self.weight.T.to(x.dtype)
        return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


class VDMResConvBlock(nn.Module):
    r"""conv-relu-conv-relu residual block with an optional 1 x 1 skip projection."""

    def __init__(
        self, c_in: int, c_mid: int, c_out: int, is_last: bool = False, *, device=None, dtype=None, generator=None
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.main = nn.ModuleList([
            _conv(c_in, c_mid, 3, **factory),
            VDMStage("relu"),
            _conv(c_mid, c_out, 3, **factory),
            VDMStage("identity" if is_last else "relu"),
        ])
        self.skip = None if c_in == c_out else _conv(c_in, c_out, 1, bias=False, **factory)

    def forward(self, x: Tensor) -> Tensor:
        h = x
        for layer in self.main:
            h = layer(h)

        return h + (x if self.skip is None else self.skip(x))


class VDMSelfAttention2d(nn.Module):
    r"""Spatial self-attention, the projection's channels qkv-major; the yfcc
    variant (and CC12M-1's) pre-normalizes with a single-group GroupNorm."""

    def __init__(
        self, c_in: int, n_head: int, pre_norm: bool = False, *, device=None, dtype=None, generator=None
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.heads = n_head
        self.norm = GroupNorm(1, c_in, affine=True, device=device, dtype=dtype) if pre_norm else None
        self.qkv_proj = _conv(c_in, 3 * c_in, 1, **factory)
        self.out_proj = _conv(c_in, c_in, 1, **factory)

    def forward(self, x: Tensor) -> Tensor:
        B, H, W, C = x.shape
        heads = self.heads
        ch = C // heads

        h = x if self.norm is None else self.norm(x)
        qkv = self.qkv_proj(h).reshape(B, H * W, 3, heads, ch)
        q, k, v = (a.transpose(1, 2) for a in qkv.unbind(dim=2))  # (B, heads, HW, ch)

        y = dot_product_attention(q, k, v)

        y = y.transpose(1, 2).reshape(B, H, W, C)

        return x + self.out_proj(y)


class VDMSkipBlock(nn.Module):
    r"""U-Net skip: the bypass concatenated before the processed branch."""

    def __init__(self, main: Sequence[nn.Module]) -> None:
        super().__init__()

        self.main = nn.ModuleList(main)

    def forward(self, x: Tensor) -> Tensor:
        h = x
        for layer in self.main:
            h = layer(h)

        return torch.cat([x, h], dim=-1)


class VDMUNet(nn.Module):
    r"""Generic v-diffusion recursive CNN built from a :class:`VDMSpec`.

    `model(x, t)` takes channels-last images and the crowsonkb time
    :math:`t \in [0, 1]` (the denoiser's
    :math:`c_\mathrm{time} = \mathrm{atan2}(\sigma, \alpha) \cdot 2 / \pi`),
    of shape :math:`()` or :math:`(B)`.
    """

    def __init__(
        self,
        spec: VDMSpec,
        in_channels: int = 3,
        out_channels: int = 3,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.spec = spec
        self.timestep_embed = FourierFeatures(1, 16, std=spec.std, **factory)

        cs = spec.cs
        last = len(cs) - 1
        n = spec.blocks

        def rcb(cin, cmid, cout, is_last=False):
            return VDMResConvBlock(cin, cmid, cout, is_last=is_last, **factory)

        def attn(ch):
            return VDMSelfAttention2d(ch, ch // spec.head_dim, pre_norm=spec.attn_norm, **factory)

        def content(level):
            seq = []

            if level == last:
                for i in range(spec.inner):
                    cin = cs[level - 1] if i == 0 else cs[level]
                    cout = cs[level - 1] if i == spec.inner - 1 else cs[level]
                    seq.append(rcb(cin, cs[level], cout))
                    if level in spec.attn:
                        seq.append(attn(cout))
                return seq

            # descent blocks at this resolution
            for i in range(n):
                if level == 0 and i == 0:
                    cin = in_channels + 16
                elif i == 0:
                    cin = cs[level - 1]
                else:
                    cin = cs[level]
                seq.append(rcb(cin, cs[level], cs[level]))
                if level in spec.attn:
                    seq.append(attn(cs[level]))

            # one level deeper
            seq.append(VDMSkipBlock([VDMStage("down"), *content(level + 1), VDMStage("up", spec.up)]))

            # ascent blocks
            for i in range(n):
                cin = 2 * cs[level] if i == 0 else cs[level]
                if i < n - 1:
                    cout, is_last = cs[level], False
                elif level > 0:
                    cout, is_last = cs[level - 1], False
                else:
                    cout, is_last = out_channels, not spec.final_act
                seq.append(rcb(cin, cs[level], cout, is_last=is_last))
                if level in spec.attn and (i < n - 1 or level > 0):
                    seq.append(attn(cout))

            return seq

        self.net = nn.ModuleList(content(0))

    def forward(self, x: Tensor, t: Tensor) -> Tensor:
        t = torch.broadcast_to(torch.atleast_1d(torch.as_tensor(t, device=x.device)), (x.shape[0],))

        if self.spec.t_input == "log_snr":
            # log(alpha^2 / sigma^2) with alpha = cos(t pi / 2), sigma = sin(t pi / 2)
            half = t.float() * (math.pi / 2)
            feat = 2 * (torch.log(torch.cos(half)) - torch.log(torch.sin(half)))
        else:
            feat = t.float()

        emb = self.timestep_embed(feat[:, None]).to(x.dtype)
        emb = torch.broadcast_to(emb[:, None, None, :], (*x.shape[:-1], emb.shape[-1]))

        h = torch.cat([x, emb], dim=-1)
        for layer in self.net:
            h = layer(h)

        return h
