r"""FLUX.1-dev's transformer: the program built from the sizes in
`flux1_dev.json`, the inputs of a trajectory, and the work of one network
call.

The program is the port's `FluxTransformer` under `FluxDenoiser` on
`DecaySchedule`, built without parameter storage and given the weights that
the benchmark drew; its network is `denoiser.backbone`.
"""

from __future__ import annotations

import torch

import reference.flux1_dev as ref

from harness import draw

# bytes of one element of the served dtype (bfloat16)
ITEM = 2
# FluxTransformer's arguments among the configuration's keys
ARGS = (
    "in_channels", "num_layers", "num_single_layers", "attention_head_dim", "num_attention_heads",
    "joint_attention_dim", "pooled_projection_dim", "guidance_embeds", "axes_dims_rope",
)


def parameters(config: dict) -> dict[str, tuple[int, ...]]:
    return ref.parameters(config)


def build(config: dict, state: dict, device: torch.device):
    from azula_tpu_torch.models.flux import FluxDenoiser, FluxTransformer
    from azula_tpu_torch.nn.utils import skip_init
    from azula_tpu_torch.noise import DecaySchedule

    if config["model"]["patch_size"] != 1:
        raise ValueError("the port's FluxTransformer takes packed latents: patch size 1")
    net = skip_init(FluxTransformer, **{k: config["model"][k] for k in ARGS})
    net.load_state_dict(state, strict=True, assign=True)
    return FluxDenoiser(net, DecaySchedule(**config["schedule"])).to(device)


def network(denoiser) -> torch.nn.Module:
    return denoiser.backbone


def inputs(config: dict, traffic: dict, seed: int, index: int, device) -> tuple[torch.Tensor, dict]:
    r"""Trajectory `index`'s packed latent noise (float32, standard normal:
    the decay schedule's :math:`\sqrt{\alpha^2 + \sigma^2}` at
    :math:`t = 1` is 1 to 5e-7) and its prompt: the T5 tokens and the
    pooled CLIP vector at the encoders' output widths, standard normal in
    the served dtype, and the distilled guidance."""

    B, side, text = traffic["batch"], traffic["latent_side"], traffic["text_tokens"]
    model = config["model"]
    dtype = getattr(torch, config["dtype"])
    g = draw.generator(device, seed, "inputs", index)
    x = torch.randn((B, side, side, model["in_channels"]), generator=g, device=device, dtype=torch.float32)
    cond = {
        "prompt_t5": torch.randn((B, text, model["joint_attention_dim"]), generator=g, device=device, dtype=dtype),
        "prompt_clip": torch.randn((B, model["pooled_projection_dim"]), generator=g, device=device, dtype=dtype),
        "guidance": traffic["guidance"],
    }
    return x, cond


def counts(config: dict, traffic: dict) -> dict:
    r"""The work of one network call at the cell's batch, counted from the
    layer shapes (2 FLOPs a multiply-add): `flops` of the linear layers and
    the attention products; `attention`, the shapes `(B, H, Lq, Lk, D)` of
    the attention calls. FLUX has no GroupNorm."""

    m = config["model"]
    B, text = traffic["batch"], traffic["text_tokens"]
    image = traffic["latent_side"] ** 2
    L = image + text
    H, hd = m["num_attention_heads"], m["attention_head_dim"]
    D = H * hd

    def linear(rows, n_in, n_out):
        return 2 * rows * n_in * n_out

    flops = linear(B * image, m["in_channels"], D) + linear(B * text, m["joint_attention_dim"], D)
    flops += 2 * (linear(B, 256, D) + linear(B, D, D)) + linear(B, m["pooled_projection_dim"], D) + linear(B, D, D)
    attention = []
    for _ in range(m["num_layers"]):
        flops += 2 * linear(B, D, 6 * D)
        for rows in (B * image, B * text):
            flops += 4 * linear(rows, D, D) + linear(rows, D, 4 * D) + linear(rows, 4 * D, D)
        attention.append((B, H, L, L, hd))
    for _ in range(m["num_single_layers"]):
        flops += linear(B, D, 3 * D) + 3 * linear(B * L, D, D) + linear(B * L, D, 4 * D) + linear(B * L, 5 * D, D)
        attention.append((B, H, L, L, hd))
    flops += linear(B, D, 2 * D) + linear(B * image, D, m["in_channels"])
    flops += sum(4 * b * h * lq * lk * d for b, h, lq, lk, d in attention)
    return {"flops": flops, "gn_bytes": 0, "attention": attention, "itemsize": ITEM}
