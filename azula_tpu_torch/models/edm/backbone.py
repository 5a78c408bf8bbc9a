r"""EDM (NVlabs) UNet backbones, channels-last.

Port of :mod:`azula_tpu.models.edm.backbone`: the architectures inside the
NVlabs/edm checkpoints,

- :class:`SongUNet`: DDPM++ / NCSN++ (Song et al.), with FIR up/downsampling
  filters, Fourier or positional noise embeddings and residual encoder
  pyramids;
- :class:`DhariwalUNet`: the ADM variant of `edm-imagenet-64x64-cond-adm`;
- the :class:`VPPrecond` / :class:`VEPrecond` / :class:`EDMPrecond` wrappers
  that map the noise level to the network's conditioning (Karras et al.,
  2022, table 1).

Every GroupNorm (`min(32, C // 4)` groups) goes through
:func:`~azula_tpu_torch.ops.norm.group_norm`, on the card the GroupNorm
kernel, with SiLU apart after it as in JAX. The blocks' self-attention is
inline, as there: the qkv channels laid out (head, channel, qkv), logits in
the activations' dtype, a float32 softmax, plain PyTorch.

The state dict's keys are the NVlabs checkpoints' (`enc.64x64_conv.weight`,
`dec.8x8_in0.norm2.bias`, the convolutions' `resample_filter` buffers, the
Fourier embedding's `freqs`), which the JAX package's
`convert_edm_state_dict` maps onto its own; :mod:`.convert` maps the JAX
arrays here.
"""

from __future__ import annotations

__all__ = [
    "PRECONDS",
    "DhariwalUNet",
    "EDMPrecond",
    "SongUNet",
    "VEPrecond",
    "VPPrecond",
]

import math
import torch
import torch.nn.functional as F

from collections.abc import Sequence
from torch import Tensor, nn

from ...nn.layers import GroupNorm, Linear
from ...nn.utils import default_device


def _norm(channels: int, eps: float, device=None, dtype=None) -> GroupNorm:
    # NVlabs GroupNorm: num_groups = min(32, C // 4)
    return GroupNorm(min(32, channels // 4), channels, eps=eps, affine=True, device=device, dtype=dtype)


def _nchw(fn, x: Tensor, *args, **kwargs) -> Tensor:
    r"""`fn` of `F`'s (B, C, H, W) convolutions on a channels-last `x`."""

    return fn(x.movedim(-1, 1), *args, **kwargs).movedim(1, -1)


class EDMConv(nn.Module):
    r"""The NVlabs `Conv2d`: optional FIR up/downsampling fused with a kxk
    convolution (k in {0, 1, 3}; 0 means resample-only), channels-last. The
    weight is :math:`(C_o, C_i, k, k)` and the normalized filter the buffer
    `resample_filter`, :math:`(1, 1, k_f, k_f)`, as in the checkpoints."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel: int,
        bias: bool = True,
        up: bool = False,
        down: bool = False,
        resample_filter: Sequence[int] = (1, 1),
        fused_resample: bool = False,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        self.up = up
        self.down = down
        self.fused = fused_resample
        self.in_channels = in_channels
        self.out_channels = out_channels

        f = torch.as_tensor(resample_filter, dtype=torch.float32)
        f = torch.outer(f, f) / f.sum() ** 2
        self.register_buffer("resample_filter", f[None, None].to(device=device, dtype=dtype))

        if kernel:
            w = torch.empty((out_channels, in_channels, kernel, kernel), device=device, dtype=dtype)
            w.normal_(generator=generator)
            self.weight = nn.Parameter(w / math.sqrt(in_channels * kernel * kernel))
        else:
            self.weight = None

        self.bias = nn.Parameter(torch.zeros(out_channels, device=device, dtype=dtype)) if kernel and bias else None

    def _conv(self, x: Tensor, w: Tensor, pad: int) -> Tensor:
        return _nchw(F.conv2d, x, w.to(x.dtype), padding=pad)

    def _depthwise(self, x: Tensor, f: Tensor, pad: int, stride: int = 1, transpose: bool = False) -> Tensor:
        C = x.shape[-1]
        w = f.to(x.dtype).repeat(C, 1, 1, 1)

        if transpose:
            return _nchw(F.conv_transpose2d, x, w, stride=2, padding=pad, groups=C)

        return _nchw(F.conv2d, x, w, stride=stride, padding=pad, groups=C)

    def forward(self, x: Tensor) -> Tensor:
        w = self.weight
        f = self.resample_filter.float()
        w_pad = w.shape[-1] // 2 if w is not None else 0
        f_pad = (f.shape[-1] - 1) // 2

        if self.fused and self.up and w is not None:
            x = self._depthwise(x, 4 * f, max(f_pad - w_pad, 0), transpose=True)
            x = self._conv(x, w, max(w_pad - f_pad, 0))
        elif self.fused and self.down and w is not None:
            x = self._conv(x, w, w_pad + f_pad)
            x = self._depthwise(x, f, 0, stride=2)
        else:
            if self.up:
                x = self._depthwise(x, 4 * f, f_pad, transpose=True)
            if self.down:
                x = self._depthwise(x, f, f_pad, stride=2)
            if w is not None:
                x = self._conv(x, w, w_pad)

        if self.bias is not None:
            x = x + self.bias.to(x.dtype)

        return x


class PositionalEmbedding(nn.Module):
    r"""NVlabs positional noise embedding, cosine components first."""

    def __init__(self, num_channels: int, max_positions: int = 10000, endpoint: bool = False) -> None:
        super().__init__()

        self.num_channels = num_channels
        self.max_positions = max_positions
        self.endpoint = endpoint

    def forward(self, t: Tensor) -> Tensor:
        half = self.num_channels // 2

        freqs = torch.arange(half, dtype=torch.float32, device=t.device)
        freqs = freqs / (half - (1 if self.endpoint else 0))
        freqs = torch.pow(1 / self.max_positions, freqs)

        args = t[..., None].float() * freqs

        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class FourierEmbedding(nn.Module):
    r"""NVlabs Gaussian Fourier noise embedding (NCSN++); the frequencies are
    the buffer `freqs`."""

    def __init__(
        self, num_channels: int, scale: float = 16.0, *, device=None, dtype=None, generator=None
    ) -> None:
        super().__init__()

        freqs = torch.empty(num_channels // 2, device=device, dtype=dtype)
        freqs.normal_(generator=generator)
        self.register_buffer("freqs", freqs * scale)

    def forward(self, t: Tensor) -> Tensor:
        args = 2 * math.pi * t[..., None].float() * self.freqs.float()

        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class EDMUNetBlock(nn.Module):
    r"""The NVlabs `UNetBlock`: GN-SiLU-conv (with optional up/down), embedding
    modulation (additive or FiLM), GN-SiLU-conv, skip, optional self-attention;
    both residual branches scaled by `skip_scale`."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        emb_channels: int,
        up: bool = False,
        down: bool = False,
        attention: bool = False,
        num_heads: int | None = None,
        channels_per_head: int = 64,
        skip_scale: float = 1.0,
        eps: float = 1e-5,
        resample_filter: Sequence[int] = (1, 1),
        resample_proj: bool = False,
        adaptive_scale: bool = True,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_heads = (
            0 if not attention else num_heads if num_heads is not None else out_channels // channels_per_head
        )
        self.skip_scale = skip_scale
        self.adaptive_scale = adaptive_scale

        self.norm0 = _norm(in_channels, eps, device, dtype)
        self.conv0 = EDMConv(
            in_channels, out_channels, kernel=3, up=up, down=down, resample_filter=resample_filter, **factory
        )
        self.affine = Linear(emb_channels, out_channels * (2 if adaptive_scale else 1), **factory)
        self.norm1 = _norm(out_channels, eps, device, dtype)
        self.conv1 = EDMConv(out_channels, out_channels, kernel=3, **factory)

        if out_channels != in_channels or up or down:
            kernel = 1 if resample_proj or out_channels != in_channels else 0
            self.skip = EDMConv(
                in_channels, out_channels, kernel=kernel, up=up, down=down, resample_filter=resample_filter, **factory
            )
        else:
            self.skip = None

        if self.num_heads:
            self.norm2 = _norm(out_channels, eps, device, dtype)
            self.qkv = EDMConv(out_channels, out_channels * 3, kernel=1, **factory)
            self.proj = EDMConv(out_channels, out_channels, kernel=1, **factory)

    def forward(self, x: Tensor, emb: Tensor) -> Tensor:
        orig = x
        x = self.conv0(F.silu(self.norm0(x)))

        params = self.affine(emb).to(x.dtype)[:, None, None, :]

        if self.adaptive_scale:
            scale, shift = params.chunk(2, dim=-1)
            x = F.silu(shift + self.norm1(x) * (scale + 1))
        else:
            x = F.silu(self.norm1(x + params))

        x = self.conv1(x)
        x = x + (orig if self.skip is None else self.skip(orig))
        x = x * self.skip_scale

        if self.num_heads:
            B, H, W, C = x.shape
            nh = self.num_heads
            ch = C // nh

            # checkpoint channel layout: (head, channel, qkv), qkv innermost
            q, k, v = self.qkv(self.norm2(x)).reshape(B, H * W, nh, ch, 3).unbind(-1)

            logits = torch.einsum("bqhc,bkhc->bhqk", q, k) / math.sqrt(ch)
            w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
            a = torch.einsum("bhqk,bkhc->bqhc", w, v).reshape(B, H, W, C)

            x = self.proj(a) + x
            x = x * self.skip_scale

        return x


class SongUNet(nn.Module):
    r"""The DDPM++ / NCSN++ UNet (NVlabs `SongUNet`).

    DDPM++ (VP): `embedding_type='positional'`, `encoder_type='standard'`,
    `resample_filter=(1, 1)`, `channel_mult_noise=1`. NCSN++ (VE):
    `embedding_type='fourier'`, `encoder_type='residual'`,
    `resample_filter=(1, 3, 3, 1)`, `channel_mult_noise=2`. `dropout` and
    `label_dropout` are training-time settings, unused at inference, as in
    the JAX package.

    Arguments:
        device: The parameters' device; the card unless another is named.
        dtype, generator: The parameters' dtype and initial-value generator.
    """

    def __init__(
        self,
        img_resolution: int,
        in_channels: int,
        out_channels: int,
        label_dim: int = 0,
        augment_dim: int = 0,
        model_channels: int = 128,
        channel_mult: Sequence[int] = (1, 2, 2, 2),
        channel_mult_emb: int = 4,
        num_blocks: int = 4,
        attn_resolutions: Sequence[int] = (16,),
        dropout: float = 0.10,
        label_dropout: float = 0.0,
        embedding_type: str = "positional",
        channel_mult_noise: int = 1,
        encoder_type: str = "standard",
        decoder_type: str = "standard",
        resample_filter: Sequence[int] = (1, 1),
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        if embedding_type not in ("fourier", "positional"):
            raise ValueError(f"unknown embedding type '{embedding_type}'")
        if encoder_type not in ("standard", "skip", "residual"):
            raise ValueError(f"unknown encoder type '{encoder_type}'")
        if decoder_type not in ("standard", "skip"):
            raise ValueError(f"unknown decoder type '{decoder_type}'")

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408
        emb_channels = model_channels * channel_mult_emb
        noise_channels = model_channels * channel_mult_noise

        block_kwargs = dict(  # noqa: C408
            emb_channels=emb_channels,
            num_heads=1,
            skip_scale=math.sqrt(0.5),
            eps=1e-6,
            resample_filter=resample_filter,
            resample_proj=True,
            adaptive_scale=False,
            **factory,
        )

        # Mapping
        if embedding_type == "positional":
            self.map_noise = PositionalEmbedding(noise_channels, endpoint=True)
        else:
            self.map_noise = FourierEmbedding(noise_channels, **factory)

        self.map_label = Linear(label_dim, noise_channels, **factory) if label_dim else None
        self.map_augment = Linear(augment_dim, noise_channels, bias=False, **factory) if augment_dim else None
        self.map_layer0 = Linear(noise_channels, emb_channels, **factory)
        self.map_layer1 = Linear(emb_channels, emb_channels, **factory)

        # Encoder
        self.enc = nn.ModuleDict()
        cout = in_channels
        caux = in_channels
        for level, mult in enumerate(channel_mult):
            res = img_resolution >> level
            if level == 0:
                cin, cout = cout, model_channels
                self.enc[f"{res}x{res}_conv"] = EDMConv(cin, cout, kernel=3, **factory)
            else:
                self.enc[f"{res}x{res}_down"] = EDMUNetBlock(cout, cout, down=True, **block_kwargs)
                if encoder_type == "skip":
                    self.enc[f"{res}x{res}_aux_down"] = EDMConv(
                        caux, caux, kernel=0, down=True, resample_filter=resample_filter, **factory
                    )
                    self.enc[f"{res}x{res}_aux_skip"] = EDMConv(caux, cout, kernel=1, **factory)
                if encoder_type == "residual":
                    self.enc[f"{res}x{res}_aux_residual"] = EDMConv(
                        caux, cout, kernel=3, down=True, resample_filter=resample_filter, fused_resample=True,
                        **factory,
                    )
                    caux = cout
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = EDMUNetBlock(
                    cin, cout, attention=(res in attn_resolutions), **block_kwargs
                )

        skips = [block.out_channels for name, block in self.enc.items() if "aux" not in name]

        # Decoder
        self.dec = nn.ModuleDict()
        for level, mult in reversed(list(enumerate(channel_mult))):
            res = img_resolution >> level
            if level == len(channel_mult) - 1:
                self.dec[f"{res}x{res}_in0"] = EDMUNetBlock(cout, cout, attention=True, **block_kwargs)
                self.dec[f"{res}x{res}_in1"] = EDMUNetBlock(cout, cout, **block_kwargs)
            else:
                self.dec[f"{res}x{res}_up"] = EDMUNetBlock(cout, cout, up=True, **block_kwargs)
            for idx in range(num_blocks + 1):
                cin = cout + skips.pop()
                cout = model_channels * mult
                self.dec[f"{res}x{res}_block{idx}"] = EDMUNetBlock(
                    cin, cout, attention=(idx == num_blocks and res in attn_resolutions), **block_kwargs
                )
            if decoder_type == "skip" or level == 0:
                if decoder_type == "skip" and level < len(channel_mult) - 1:
                    self.dec[f"{res}x{res}_aux_up"] = EDMConv(
                        out_channels, out_channels, kernel=0, up=True, resample_filter=resample_filter, **factory
                    )
                self.dec[f"{res}x{res}_aux_norm"] = _norm(cout, 1e-6, factory["device"], dtype)
                self.dec[f"{res}x{res}_aux_conv"] = EDMConv(cout, out_channels, kernel=3, **factory)

    def forward(
        self,
        x: Tensor,
        noise_labels: Tensor,
        class_labels: Tensor | None = None,
        augment_labels: Tensor | None = None,
    ) -> Tensor:
        # Mapping
        emb = self.map_noise(noise_labels)
        # swap sin/cos (the NVlabs quirk, kept for checkpoint compatibility)
        B, N = emb.shape
        emb = emb.reshape(B, 2, N // 2).flip(1).reshape(B, N)

        if self.map_label is not None and class_labels is not None:
            scale = math.sqrt(self.map_label.weight.shape[1])
            emb = emb + self.map_label(class_labels.to(emb.dtype) * scale)
        if self.map_augment is not None and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels.to(emb.dtype))

        emb = F.silu(self.map_layer0(emb))
        emb = F.silu(self.map_layer1(emb))
        emb = emb.to(x.dtype)

        # Encoder
        skips = []
        aux = x
        for name, block in self.enc.items():
            if "aux_down" in name:
                aux = block(aux)
            elif "aux_skip" in name:
                x = skips[-1] = x + block(aux)
            elif "aux_residual" in name:
                x = skips[-1] = aux = (x + block(aux)) / math.sqrt(2)
            else:
                x = block(x, emb) if isinstance(block, EDMUNetBlock) else block(x)
                skips.append(x)

        # Decoder
        aux = None
        tmp = None
        for name, block in self.dec.items():
            if "aux_up" in name:
                aux = block(aux)
            elif "aux_norm" in name:
                tmp = block(x)
            elif "aux_conv" in name:
                tmp = block(F.silu(tmp))
                aux = tmp if aux is None else tmp + aux
            else:
                if x.shape[-1] != block.in_channels:
                    x = torch.cat([x, skips.pop()], dim=-1)
                x = block(x, emb)

        return aux


class DhariwalUNet(nn.Module):
    r"""The ADM UNet variant of `edm-imagenet-64x64-cond-adm` (NVlabs
    `DhariwalUNet`). `dropout` and `label_dropout` are training-time
    settings, unused at inference, as in the JAX package.

    Arguments:
        device: The parameters' device; the card unless another is named.
        dtype, generator: The parameters' dtype and initial-value generator.
    """

    def __init__(
        self,
        img_resolution: int,
        in_channels: int,
        out_channels: int,
        label_dim: int = 0,
        augment_dim: int = 0,
        model_channels: int = 192,
        channel_mult: Sequence[int] = (1, 2, 3, 4),
        channel_mult_emb: int = 4,
        num_blocks: int = 3,
        attn_resolutions: Sequence[int] = (32, 16, 8),
        dropout: float = 0.10,
        label_dropout: float = 0.0,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        factory = dict(device=default_device(device), dtype=dtype, generator=generator)  # noqa: C408
        emb_channels = model_channels * channel_mult_emb

        block_kwargs = dict(emb_channels=emb_channels, channels_per_head=64, adaptive_scale=True, **factory)  # noqa: C408

        self.map_noise = PositionalEmbedding(model_channels)
        self.map_augment = Linear(augment_dim, model_channels, bias=False, **factory) if augment_dim else None
        self.map_layer0 = Linear(model_channels, emb_channels, **factory)
        self.map_layer1 = Linear(emb_channels, emb_channels, **factory)
        self.map_label = Linear(label_dim, emb_channels, bias=False, **factory) if label_dim else None

        self.enc = nn.ModuleDict()
        cout = in_channels
        for level, mult in enumerate(channel_mult):
            res = img_resolution >> level
            if level == 0:
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_conv"] = EDMConv(cin, cout, kernel=3, **factory)
            else:
                self.enc[f"{res}x{res}_down"] = EDMUNetBlock(cout, cout, down=True, **block_kwargs)
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = EDMUNetBlock(
                    cin, cout, attention=(res in attn_resolutions), **block_kwargs
                )

        skips = [block.out_channels for block in self.enc.values()]

        self.dec = nn.ModuleDict()
        for level, mult in reversed(list(enumerate(channel_mult))):
            res = img_resolution >> level
            if level == len(channel_mult) - 1:
                self.dec[f"{res}x{res}_in0"] = EDMUNetBlock(cout, cout, attention=True, **block_kwargs)
                self.dec[f"{res}x{res}_in1"] = EDMUNetBlock(cout, cout, **block_kwargs)
            else:
                self.dec[f"{res}x{res}_up"] = EDMUNetBlock(cout, cout, up=True, **block_kwargs)
            for idx in range(num_blocks + 1):
                cin = cout + skips.pop()
                cout = model_channels * mult
                self.dec[f"{res}x{res}_block{idx}"] = EDMUNetBlock(
                    cin, cout, attention=(res in attn_resolutions), **block_kwargs
                )

        self.out_norm = _norm(cout, 1e-5, factory["device"], dtype)
        self.out_conv = EDMConv(cout, out_channels, kernel=3, **factory)

    def forward(
        self,
        x: Tensor,
        noise_labels: Tensor,
        class_labels: Tensor | None = None,
        augment_labels: Tensor | None = None,
    ) -> Tensor:
        emb = self.map_noise(noise_labels)

        if self.map_augment is not None and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels.to(emb.dtype))

        emb = F.silu(self.map_layer0(emb))
        emb = self.map_layer1(emb)

        if self.map_label is not None and class_labels is not None:
            emb = emb + self.map_label(class_labels.to(emb.dtype))

        emb = F.silu(emb).to(x.dtype)

        skips = []
        for block in self.enc.values():
            x = block(x, emb) if isinstance(block, EDMUNetBlock) else block(x)
            skips.append(x)

        for block in self.dec.values():
            if x.shape[-1] != block.in_channels:
                x = torch.cat([x, skips.pop()], dim=-1)
            x = block(x, emb)

        return self.out_conv(F.silu(self.out_norm(x)))


class _Precond(nn.Module):
    r"""Base preconditioning wrapper: :math:`D(x, \sigma) = c_\mathrm{skip} x +
    c_\mathrm{out} F(c_\mathrm{in} x, c_\mathrm{noise})` (Karras et al., 2022,
    eq. 7), in float32 around the network's dtype."""

    def __init__(self, model: nn.Module) -> None:
        super().__init__()

        self.model = model

    def scalings(self, sigma: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        raise NotImplementedError

    def forward(self, x: Tensor, sigma: Tensor | float, class_labels: Tensor | None = None, **kwargs) -> Tensor:
        sigma = torch.atleast_1d(torch.as_tensor(sigma, dtype=torch.float32, device=x.device)).expand(x.shape[0])

        # conditional checkpoints expect zero one-hots, not a missing input
        # (the label embedding may have a bias): NVlabs Precond.forward
        map_label = getattr(self.model, "map_label", None)
        if class_labels is None and map_label is not None:
            class_labels = torch.zeros((x.shape[0], map_label.weight.shape[1]), dtype=x.dtype, device=x.device)

        c_skip, c_out, c_in, c_noise = self.scalings(sigma[:, None, None, None])

        out = self.model((c_in * x.float()).to(x.dtype), c_noise.reshape(-1), class_labels=class_labels, **kwargs)

        return c_skip * x.float() + c_out * out.float()


class VPPrecond(_Precond):
    r"""Variance-preserving preconditioning (DDPM++ checkpoints)."""

    def __init__(self, model: nn.Module, beta_d: float = 19.9, beta_min: float = 0.1, M: int = 1000) -> None:
        super().__init__(model)

        self.beta_d = beta_d
        self.beta_min = beta_min
        self.M = M

    def scalings(self, sigma: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        c_skip = torch.ones_like(sigma)
        c_out = -sigma
        c_in = 1 / torch.sqrt(sigma**2 + 1)
        # inverse of sigma(t) = sqrt(exp(beta_d t^2 / 2 + beta_min t) - 1)
        t = (torch.sqrt(self.beta_min**2 + 2 * self.beta_d * torch.log1p(sigma**2)) - self.beta_min) / self.beta_d
        c_noise = (self.M - 1) * t

        return c_skip, c_out, c_in, c_noise


class VEPrecond(_Precond):
    r"""Variance-exploding preconditioning (NCSN++ checkpoints)."""

    def scalings(self, sigma: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        c_skip = torch.ones_like(sigma)
        c_out = sigma
        c_in = torch.ones_like(sigma)
        c_noise = torch.log(0.5 * sigma)

        return c_skip, c_out, c_in, c_noise


class EDMPrecond(_Precond):
    r"""EDM preconditioning (Karras et al., 2022, table 1, last column)."""

    def __init__(self, model: nn.Module, sigma_data: float = 0.5) -> None:
        super().__init__(model)

        self.sigma_data = sigma_data

    def scalings(self, sigma: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        sd2 = self.sigma_data**2
        c_skip = sd2 / (sigma**2 + sd2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma**2 + sd2)
        c_in = 1 / torch.sqrt(sd2 + sigma**2)
        c_noise = torch.log(sigma) / 4

        return c_skip, c_out, c_in, c_noise


PRECONDS = {
    "VPPrecond": VPPrecond,
    "VEPrecond": VEPrecond,
    "EDMPrecond": EDMPrecond,
}
