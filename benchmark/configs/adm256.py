r"""ADM ImageNet 256x256 unconditional: the program built from the sizes in
`adm256.json`, the inputs of a trajectory, and the work of one network call.

The program is the port's `adm.make_model` (an `AblatedDenoiser` over
`ADMUNet`), built without parameter storage and given the weights that the
benchmark drew; its network is `denoiser.backbone`.
"""

from __future__ import annotations

import torch

import reference.adm256 as ref

from harness import draw

# bytes of one element of the served dtype (bfloat16)
ITEM = 2


def parameters(config: dict) -> dict[str, tuple[int, ...]]:
    return ref.parameters(config)


def build(config: dict, state: dict, device: torch.device):
    from azula_tpu_torch.models import adm
    from azula_tpu_torch.nn.utils import skip_init
    from azula_tpu_torch.noise import VPSchedule

    denoiser = skip_init(adm.make_model, **config["model"])
    denoiser.backbone.load_state_dict(state, strict=True, assign=True)
    denoiser.schedule = VPSchedule(**config["schedule"])
    return denoiser.to(device)


def network(denoiser) -> torch.nn.Module:
    return denoiser.backbone


def inputs(config: dict, traffic: dict, seed: int, index: int, device) -> tuple[torch.Tensor, dict]:
    r"""Trajectory `index`'s noise: standard normal images, channels-last,
    float32 (azula's `Sampler.init` at :math:`t = 1`, where the VP
    schedule's :math:`\sqrt{\alpha^2 + \sigma^2}` is 1 to 5e-5)."""

    size = config["model"]["image_size"]
    g = draw.generator(device, seed, "inputs", index)
    x = torch.randn((traffic["batch"], size, size, 3), generator=g, device=device, dtype=torch.float32)
    return x, {}


def layers(config: dict, B: int):
    r"""The layers of one UNet call at batch `B`, in order, as
    `('conv', B, side_out, c_in, c_out, kernel, stride)`, `('linear', rows,
    in, out)`, `('gn', B, HW, C, silu, modulated)` and `('attention', B,
    heads, L, head_dim)`."""

    m = config["model"]
    ch, mult, blocks = m["num_channels"], m["channel_mult"], m["num_res_blocks"]
    head = m["num_head_channels"]
    side = m["image_size"]
    rates = {side // r for r in m["attention_resolutions"]}
    emb = 4 * ch
    out_ch = 6 if m["learn_var"] else 3

    def resblock(c_in, c_out, side, up=False, down=False):
        yield ("gn", B, side * side, c_in, True, False)
        side2 = side * 2 if up else side // 2 if down else side
        yield ("conv", B, side2, c_in, c_out, 3, 1)
        yield ("linear", B, emb, 2 * c_out)
        yield ("gn", B, side2 * side2, c_out, True, True)
        yield ("conv", B, side2, c_out, c_out, 3, 1)
        if c_in != c_out:
            yield ("conv", B, side2, c_in, c_out, 1, 1)

    def attention(c, side):
        L = side * side
        yield ("gn", B, L, c, False, False)
        yield ("linear", B * L, c, 3 * c)
        yield ("attention", B, c // head, L, head)
        yield ("linear", B * L, c, c)

    yield ("linear", B, ch, emb)
    yield ("linear", B, emb, emb)
    c = int(mult[0] * ch)
    yield ("conv", B, side, 3, c, 3, 1)
    chans, ds = [c], 1
    for level, mu in enumerate(mult):
        for _ in range(blocks):
            yield from resblock(c, int(mu * ch), side)
            c = int(mu * ch)
            if ds in rates:
                yield from attention(c, side)
            chans.append(c)
        if level != len(mult) - 1:
            yield from resblock(c, c, side, down=True)
            side //= 2
            chans.append(c)
            ds *= 2
    yield from resblock(c, c, side)
    yield from attention(c, side)
    yield from resblock(c, c, side)
    for level, mu in list(enumerate(mult))[::-1]:
        for i in range(blocks + 1):
            yield from resblock(c + chans.pop(), int(mu * ch), side)
            c = int(mu * ch)
            if ds in rates:
                yield from attention(c, side)
            if level and i == blocks:
                yield from resblock(c, c, side, up=True)
                side *= 2
                ds //= 2
    yield ("gn", B, side * side, c, False, False)
    yield ("conv", B, side, c, out_ch, 3, 1)


def counts(config: dict, traffic: dict) -> dict:
    r"""The work of one network call at the cell's batch, counted from the
    layer shapes (2 FLOPs a multiply-add): `flops` of the convolutions,
    linear layers and attention products; `gn_bytes`, each GroupNorm's
    input read and output written once with its affine parameters (and the
    per-row scale and shift where modulated); `attention`, the shapes
    `(B, H, Lq, Lk, D)` of the attention calls."""

    flops, gn_bytes, attn = 0, 0, []
    for layer in layers(config, traffic["batch"]):
        kind = layer[0]
        if kind == "conv":
            _, B, side, c_in, c_out, k, _ = layer
            flops += 2 * B * side * side * c_in * c_out * k * k
        elif kind == "linear":
            _, rows, n_in, n_out = layer
            flops += 2 * rows * n_in * n_out
        elif kind == "gn":
            _, B, HW, C, _, modulated = layer
            gn_bytes += ITEM * (2 * B * HW * C + 2 * C + (2 * B * C if modulated else 0))
        else:
            _, B, H, L, D = layer
            flops += 4 * B * H * L * L * D
            attn.append((B, H, L, L, D))
    return {"flops": flops, "gn_bytes": gn_bytes, "attention": attn, "itemsize": ITEM}
