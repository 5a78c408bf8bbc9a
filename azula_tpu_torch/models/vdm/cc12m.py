r"""CC12M_1, the CLIP-conditioned v-diffusion model, channels-last.

Port of :mod:`azula_tpu.models.vdm.cc12m`: a mapping MLP turns the CLIP
embedding and the time into a conditioning vector that FiLM-modulates every
convolution block, passed to each block explicitly. After each convolution
a single-group GroupNorm without affine (:func:`~azula_tpu_torch.ops.norm.group_norm`,
on the card the GroupNorm kernel, whose groups here reach 1024 channels)
is followed by the FiLM :math:`t + x (s + 1)` in x's dtype, apart, as in the
JAX package. This model's skip concatenates the processed branch before the
bypass, the opposite of the other v-diffusion models.

The state dict's keys are the checkpoint's (`mapping.0.main.0.weight`,
`net.0.main.2.layer.weight`, `net.4.main.1.norm.weight`), PyTorch's layouts.
"""

from __future__ import annotations

__all__ = [
    "CC12M1Model",
    "CC12MModConvBlock",
    "CC12MModulation",
    "CC12MResLinearBlock",
    "CC12MSkipBlock",
]

import torch

from collections.abc import Sequence
from torch import Tensor, nn

from ...nn.layers import Linear
from .backbone import FourierFeatures, VDMSelfAttention2d, VDMStage, _conv


@torch.no_grad()
def _scale_params(module: nn.Module, factor: float) -> nn.Module:
    r"""Scales the module's floating-point parameters by `factor` (the
    initialization of the mapping and of the network)."""

    for p in module.parameters():
        if p.is_floating_point():
            p.mul_(factor)
    return module


class CC12MResLinearBlock(nn.Module):
    r"""Linear-ReLU-Linear residual block."""

    def __init__(
        self, f_in: int, f_mid: int, f_out: int, is_last: bool = False, *, device=None, dtype=None, generator=None
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.main = nn.ModuleList([
            Linear(f_in, f_mid, **factory),
            VDMStage("relu"),
            Linear(f_mid, f_out, **factory),
            VDMStage("identity" if is_last else "relu"),
        ])
        self.skip = None if f_in == f_out else Linear(f_in, f_out, bias=False, **factory)

    def forward(self, x: Tensor) -> Tensor:
        h = x
        for layer in self.main:
            h = layer(h)

        return h + (x if self.skip is None else self.skip(x))


class CC12MModulation(nn.Module):
    r"""FiLM modulation from the conditioning vector."""

    def __init__(self, feats_in: int, c_out: int, *, device=None, dtype=None, generator=None) -> None:
        super().__init__()

        self.layer = Linear(feats_in, 2 * c_out, bias=False, device=device, dtype=dtype, generator=generator)

    def forward(self, x: Tensor, cond: Tensor) -> Tensor:
        scales, shifts = self.layer(cond).chunk(2, dim=-1)

        return shifts[:, None, None, :] + x * (scales[:, None, None, :] + 1)


class CC12MModConvBlock(nn.Module):
    r"""conv-GN-FiLM-relu-conv-GN-FiLM-relu residual block."""

    def __init__(
        self,
        feats_in: int,
        c_in: int,
        c_mid: int,
        c_out: int,
        is_last: bool = False,
        *,
        device=None,
        dtype=None,
        generator=None,
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.main = nn.ModuleList([
            _conv(c_in, c_mid, 3, **factory),
            VDMStage("gn1"),
            CC12MModulation(feats_in, c_mid, **factory),
            VDMStage("relu"),
            _conv(c_mid, c_out, 3, **factory),
            VDMStage("identity" if is_last else "gn1"),
            VDMStage("identity") if is_last else CC12MModulation(feats_in, c_out, **factory),
            VDMStage("identity" if is_last else "relu"),
        ])
        self.skip = None if c_in == c_out else _conv(c_in, c_out, 1, bias=False, **factory)

    def forward(self, x: Tensor, cond: Tensor) -> Tensor:
        h = x
        for layer in self.main:
            h = layer(h, cond) if isinstance(layer, CC12MModulation) else layer(h)

        return h + (x if self.skip is None else self.skip(x))


def _apply_cc(layer: nn.Module, x: Tensor, cond: Tensor) -> Tensor:
    if isinstance(layer, (CC12MModConvBlock, CC12MSkipBlock)):
        return layer(x, cond)
    return layer(x)


class CC12MSkipBlock(nn.Module):
    r"""U-Net skip that concatenates the processed branch first."""

    def __init__(self, main: Sequence[nn.Module]) -> None:
        super().__init__()

        self.main = nn.ModuleList(main)

    def forward(self, x: Tensor, cond: Tensor) -> Tensor:
        h = x
        for layer in self.main:
            h = _apply_cc(layer, h, cond)

        return torch.cat([h, x], dim=-1)


class CC12M1Model(nn.Module):
    r"""The CLIP-conditioned 256 x 256 v-diffusion model.

    `model(x, t, clip_embed)` takes channels-last images, the time
    :math:`t \in [0, 1]` of shape :math:`()` or :math:`(B)` and CLIP ViT-B/16
    image embeddings :math:`(B, 512)`, normalized here to the norm
    :math:`\sqrt{512}`. The zero embedding (the unconditional branch of
    `cc12m_1_cfg`) stays zero: the norm is taken at least 1e-12, as
    `torch.nn.functional.normalize` takes it, where the JAX package divides
    0 by 0; any other embedding is divided by its norm, as there.
    """

    def __init__(self, *, device=None, dtype=None, generator: torch.Generator | None = None) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        c = 128
        cs = (c, 2 * c, 2 * c, 4 * c, 4 * c, 8 * c, 8 * c)
        n = 4
        inner = 8
        attn = (4, 5, 6)
        feats = 1024

        self.mapping_timestep_embed = FourierFeatures(1, 128, **factory)
        self.mapping = nn.ModuleList([
            _scale_params(CC12MResLinearBlock(512 + 128, 1024, 1024, **factory), 0.5**0.5),
            _scale_params(CC12MResLinearBlock(1024, 1024, 1024, is_last=True, **factory), 0.5**0.5),
        ])

        self.timestep_embed = FourierFeatures(1, 16, **factory)

        def block(c_in, c_mid, c_out, is_last=False):
            return CC12MModConvBlock(feats, c_in, c_mid, c_out, is_last=is_last, **factory)

        def attn_block(ch):
            return VDMSelfAttention2d(ch, ch // 64, pre_norm=True, **factory)

        last = len(cs) - 1

        def content(level):
            seq = []

            if level == last:
                for i in range(inner):
                    cin = cs[level - 1] if i == 0 else cs[level]
                    cout = cs[level - 1] if i == inner - 1 else cs[level]
                    seq.append(block(cin, cs[level], cout))
                    if level in attn:
                        seq.append(attn_block(cout))
                return seq

            for i in range(n):
                cin = (3 + 16) if (level == 0 and i == 0) else cs[level - 1] if i == 0 else cs[level]
                seq.append(block(cin, cs[level], cs[level]))
                if level in attn:
                    seq.append(attn_block(cs[level]))

            seq.append(CC12MSkipBlock([VDMStage("down"), *content(level + 1), VDMStage("up", "bilinear")]))

            for i in range(n):
                cin = 2 * cs[level] if i == 0 else cs[level]
                if i < n - 1:
                    cout, is_last = cs[level], False
                elif level > 0:
                    cout, is_last = cs[level - 1], False
                else:
                    cout, is_last = 3, True
                seq.append(block(cin, cs[level], cout, is_last=is_last))
                if level in attn:
                    seq.append(attn_block(cout))

            return seq

        self.net = nn.ModuleList([_scale_params(layer, 0.5**0.5) for layer in content(0)])

    def forward(self, x: Tensor, t: Tensor, clip_embed: Tensor) -> Tensor:
        t = torch.broadcast_to(torch.atleast_1d(torch.as_tensor(t, device=x.device)), (x.shape[0],))

        norm = torch.linalg.vector_norm(clip_embed, dim=-1, keepdim=True)
        clip_embed = clip_embed / norm.clamp_min(1e-12)
        clip_embed = clip_embed * clip_embed.shape[-1] ** 0.5

        t_map = self.mapping_timestep_embed(t[:, None].float()).to(x.dtype)
        cond = torch.cat([clip_embed.to(x.dtype), t_map], dim=-1)
        for layer in self.mapping:
            cond = layer(cond)

        emb = self.timestep_embed(t[:, None].float()).to(x.dtype)
        emb = torch.broadcast_to(emb[:, None, None, :], (*x.shape[:-1], emb.shape[-1]))

        h = torch.cat([x, emb], dim=-1)
        for layer in self.net:
            h = _apply_cc(layer, h, cond)

        return h
