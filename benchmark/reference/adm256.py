r"""Plain reference of ADM's UNet (guided-diffusion's `unet.py`) under its
epsilon-prediction denoiser and a VP schedule.

Written from Dhariwal & Nichol (2021), "Diffusion Models Beat GANs on Image
Synthesis", and guided-diffusion's `unet.py` and `gaussian_diffusion.py`:
ResBlocks with GroupNorm32 (32 groups, eps 1e-5, float32 statistics),
scale-shift norm (``norm(h) * (1 + scale) + shift`` before the SiLU),
residual up- and downsampling (nearest x2, average pooling), legacy-order
QKV attention (channels head-major: H x (q, k, v)) with 64-channel heads, and
the sinusoidal timestep embedding (cosine first) of the discrete timestep.

The module names follow the state dict that the benchmark draws, which are
guided-diffusion's keys in their canonical form (`in_layers.0` -> `in_norm`,
`in_layers.2` -> `in_conv`, `emb_layers.1` -> `emb_lin`, `out_layers.0` ->
`out_norm`, `out_layers.3` -> `out_conv`, `skip_connection` -> `skip`,
`proj_out` -> `proj`, `out.0` -> `out_norm`, `out.2` -> `out_conv`); the
layouts are PyTorch's (linear (out, in), convolution (out, in, kh, kw)).
Images are channels-last at the interface and NCHW inside.

The denoiser maps continuous time to the checkpoint's discrete timestep as
azula does: the left search of :math:`\sigma_t / \sqrt{\alpha_t^2 + \sigma_t^2}`
in the table :math:`\sqrt{1 - \bar\alpha_i}` of the linear beta schedule
(1e-4 to 0.02 over 1000 steps), all in float64. Its mean is
:math:`\mathrm{clip}((x_t - \sigma_t \hat\epsilon) / \alpha_t, -1, 1)`, the
input scaled by :math:`1 / \sqrt{\alpha_t^2 + \sigma_t^2}` and rounded to
the served dtype (what a network served in it receives), and the learned
variance channels are left out of the mean.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from torch import Tensor, nn

from reference.common import CALLS_PER_STEP, SAMPLERS, Linear, Ops, parameter, served, shapes

__all__ = ["CALLS_PER_STEP", "UNet", "parameters", "trajectory"]


class Conv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1) -> None:
        super().__init__()

        parameter(self, "weight", out_ch, in_ch, kernel, kernel)
        parameter(self, "bias", out_ch)
        self.stride = stride
        self.padding = kernel // 2

    def forward(self, x: Tensor, ops: Ops) -> Tensor:
        return ops.conv(x, self.weight, self.bias, self.stride, self.padding)


class Norm(nn.Module):
    r"""GroupNorm32: 32 groups, affine, float32."""

    def __init__(self, channels: int) -> None:
        super().__init__()

        parameter(self, "weight", channels)
        parameter(self, "bias", channels)

    def forward(self, x: Tensor) -> Tensor:
        return F.group_norm(x.float(), 32, self.weight.float(), self.bias.float(), eps=1e-5)


def upsample(x: Tensor) -> Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def downsample(x: Tensor) -> Tensor:
    return F.avg_pool2d(x, 2)


class ResBlock(nn.Module):
    def __init__(self, channels: int, emb_channels: int, out_channels: int, up: bool = False, down: bool = False) -> None:
        super().__init__()

        self.in_norm = Norm(channels)
        self.in_conv = Conv(channels, out_channels)
        self.emb_lin = Linear(emb_channels, 2 * out_channels)
        self.out_norm = Norm(out_channels)
        self.out_conv = Conv(out_channels, out_channels)
        self.skip = None if out_channels == channels else Conv(channels, out_channels, kernel=1)
        self.up, self.down = up, down

    def forward(self, x: Tensor, emb: Tensor, ops: Ops) -> Tensor:
        h = F.silu(self.in_norm(x))
        if self.up:
            h, x = upsample(h), upsample(x)
        elif self.down:
            h, x = downsample(h), downsample(x)
        h = self.in_conv(h, ops)

        scale, shift = self.emb_lin(F.silu(emb), ops)[:, :, None, None].chunk(2, dim=1)
        h = self.out_norm(h) * (1 + scale) + shift
        h = self.out_conv(F.silu(h), ops)

        skip = x if self.skip is None else self.skip(x, ops)
        return skip + h


class Attention(nn.Module):
    def __init__(self, channels: int, head_channels: int) -> None:
        super().__init__()

        self.heads = channels // head_channels
        self.norm = Norm(channels)
        self.qkv = Linear(channels, 3 * channels)
        self.proj = Linear(channels, channels)

    def forward(self, x: Tensor, emb: Tensor, ops: Ops) -> Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).reshape(B, C, H * W).transpose(1, 2)
        qkv = self.qkv(h, ops).reshape(B, H * W, self.heads, 3, C // self.heads)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
        a = ops.attention(q, k, v).transpose(1, 2).reshape(B, H * W, C)
        return x + self.proj(a, ops).transpose(1, 2).reshape(B, C, H, W)


def timestep_embedding(t: Tensor, dim: int, max_period: float = 10000.0) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float64, device=t.device) / half)
    args = t.double()[:, None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()


class UNet(nn.Module):
    r"""guided-diffusion's `UNetModel` with `resblock_updown`,
    `use_scale_shift_norm`, `num_head_channels` and no class labels."""

    def __init__(self, config: dict) -> None:
        super().__init__()

        ch = config["num_channels"]
        mult = config["channel_mult"]
        blocks = config["num_res_blocks"]
        heads = config["num_head_channels"]
        size = config["image_size"]
        rates = {size // r for r in config["attention_resolutions"]}
        out_channels = 6 if config["learn_var"] else 3
        emb = 4 * ch
        if config.get("num_classes") is not None or not config["resblock_updown"] or not config["use_scale_shift_norm"]:
            raise ValueError("the reference covers ADM without labels, with resblock_updown and scale-shift norm")

        self.model_channels = ch
        self.time_embed = nn.ModuleList([Linear(ch, emb), Linear(emb, emb)])

        c = int(mult[0] * ch)
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv(3, c)])])
        chans, ds = [c], 1
        for level, m in enumerate(mult):
            for _ in range(blocks):
                layers = [ResBlock(c, emb, int(m * ch))]
                c = int(m * ch)
                if ds in rates:
                    layers.append(Attention(c, heads))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(c)
            if level != len(mult) - 1:
                self.input_blocks.append(nn.ModuleList([ResBlock(c, emb, c, down=True)]))
                chans.append(c)
                ds *= 2

        self.middle_block = nn.ModuleList([ResBlock(c, emb, c), Attention(c, heads), ResBlock(c, emb, c)])

        self.output_blocks = nn.ModuleList()
        for level, m in list(enumerate(mult))[::-1]:
            for i in range(blocks + 1):
                layers = [ResBlock(c + chans.pop(), emb, int(m * ch))]
                c = int(m * ch)
                if ds in rates:
                    layers.append(Attention(c, heads))
                if level and i == blocks:
                    layers.append(ResBlock(c, emb, c, up=True))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out_norm = Norm(c)
        self.out_conv = Conv(int(mult[0] * ch), out_channels)

    def forward(self, x: Tensor, t: Tensor, ops: Ops) -> Tensor:
        r"""`x` channels-last (B, H, W, 3), `t` the discrete timesteps (B,);
        returns the (B, H, W, 6) output, float32."""

        emb = timestep_embedding(t, self.model_channels)
        emb = self.time_embed[1](F.silu(self.time_embed[0](emb, ops)), ops)

        h = x.float().permute(0, 3, 1, 2)
        hs = []
        for i, layers in enumerate(self.input_blocks):
            for layer in layers:
                h = layer(h, ops) if i == 0 else layer(h, emb, ops)
            hs.append(h)
        for layer in self.middle_block:
            h = layer(h, emb, ops)
        for layers in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            for layer in layers:
                h = layer(h, emb, ops)
        h = self.out_conv(F.silu(self.out_norm(h)), ops)

        return h.permute(0, 2, 3, 1)


def parameters(config: dict) -> dict[str, tuple[int, ...]]:
    return shapes(UNet(config["model"]))


def vp(config: dict):
    r"""The VP schedule :math:`\alpha_t = \exp(t^2 \log \alpha_\min)`,
    :math:`\sigma_t = \sqrt{1 - \alpha_t^2 + \sigma_\min^2}`, float64."""

    alpha_min, sigma_min = config["schedule"]["alpha_min"], config["schedule"]["sigma_min"]

    def schedule(t: Tensor) -> tuple[Tensor, Tensor]:
        alpha = torch.exp(math.log(alpha_min) * t.double() ** 2)
        return alpha, torch.sqrt(1 - alpha**2 + sigma_min**2)

    return schedule


def discrete_sigmas(steps: int) -> Tensor:
    beta = torch.linspace(0.1 / steps, 20.0 / steps, steps, dtype=torch.float64)
    return torch.sqrt(1 - torch.cumprod(1 - beta, dim=0))


def trajectory(config: dict, traffic: dict, state: dict, x: Tensor, cond: dict, precision: str = "float32"):
    r"""The reference's sample from `x` (channels-last, time 1) under the
    cell's sampler, with the weights `state`.

    Returns:
        The network output at the first call and the final sample, float64.
    """

    model = config["model"]
    if model["discrete_schedule"] != "linear":
        raise ValueError("the reference covers the linear beta schedule")

    unet = UNet(model)
    unet.load_state_dict(state, strict=True, assign=True)
    ops = Ops(precision)
    schedule = vp(config)
    sigmas = discrete_sigmas(model["discrete_steps"]).to(x.device)
    dtype = getattr(torch, config["dtype"])
    channels = x.shape[-1]

    @torch.no_grad()
    def denoise(x_t: Tensor, t: Tensor) -> tuple[Tensor, Tensor]:
        alpha, sigma = schedule(t)
        step = torch.searchsorted(sigmas, (sigma / torch.sqrt(alpha**2 + sigma**2)).reshape(1))
        out = unet(served(x_t / torch.sqrt(alpha**2 + sigma**2), dtype), step.expand(x_t.shape[0]), ops).double()
        mean = (x_t - sigma * out[..., :channels]) / alpha
        if model["clip_mean"]:
            mean = mean.clamp(-1, 1)
        return mean, out

    return SAMPLERS[traffic["sampler"]](denoise, schedule, x, traffic["steps"], traffic["eta"])
