r"""Plain reference of FLUX.1-dev's transformer (diffusers'
`FluxTransformer2DModel`) under azula's rectified-flow denoiser on its decay
schedule.

Written from Black Forest Labs' FLUX.1 release and diffusers'
`transformer_flux.py`, `embeddings.py`, `normalization.py` and
`attention_processor.py` (`FluxAttnProcessor2_0`):

- the conditioning vector: sinusoidal embeddings (dim 256, period 1e4,
  cosine first) of 1000 t and of 1000 g through two-layer SiLU MLPs, plus
  the pooled CLIP vector through another;
- dual-stream blocks (AdaLN-Zero: shift, scale, gate for attention, then
  for the MLP; LayerNorm without affine, eps 1e-6) with joint attention over
  the text tokens followed by the image tokens, per-head RMSNorm (eps 1e-6)
  of q and k, rotary embedding over three axes (16, 56, 56; theta 1e4,
  interleaved pairs), and GELU (tanh) MLPs of width 4D;
- single-stream blocks (shift, scale, gate) running attention and the MLP
  in parallel, concatenated and projected under one gate;
- the output norm, whose modulation splits into scale, then shift.

The denoiser is azula's `FluxDenoiser`: with
:math:`c = 1 / (\alpha_t + \sigma_t)`, the network sees :math:`c\,x_t` at
time :math:`\sigma_t c`, and the mean is :math:`c\,x_t - \sigma_t c\,v`.
The network's inputs (latent, time, guidance) reach it in the served dtype,
as the served pipeline rounds them, and so does the guidance's embedding
argument :math:`1000\,g` (diffusers' `guidance.to(dtype) * 1000`: 3504 for
3.5 in bf16, whose sinusoid differs from that of 3500); the time's
:math:`1000\,t` is float32, as azula computes it (diffusers rounds it too).
The schedule: :math:`\tau = (1 - \gamma^t) / (1 - \gamma)`,
:math:`\alpha_t = \tau \alpha_\min + 1 - \tau`,
:math:`\sigma_t = \tau + (1 - \tau) \sigma_\min`.

Every product is float32 (:class:`~reference.common.Ops`); the weights stay in
the dtype the benchmark drew them in and are widened layer by layer, so that
the reference fits beside nothing else on one card.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from torch import Tensor, nn

from reference.common import CALLS_PER_STEP, SAMPLERS, Linear, Ops, parameter, served, shapes

__all__ = ["CALLS_PER_STEP", "Transformer", "parameters", "trajectory"]


def layer_norm(x: Tensor) -> Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def rms_norm(x: Tensor, weight: Tensor) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * weight.float()


def timestep_embedding(t: Tensor, dim: int = 256) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64, device=t.device) / half)
    args = t.double()[:, None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()


def rope(ids: Tensor, axes: list[int], theta: float = 10000.0) -> tuple[Tensor, Tensor]:
    cos, sin = [], []
    for a, dim in enumerate(axes):
        freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64, device=ids.device) / dim)
        angles = ids[:, a].double()[:, None] * freqs
        cos.append(torch.cos(angles).repeat_interleave(2, dim=-1))
        sin.append(torch.sin(angles).repeat_interleave(2, dim=-1))
    return torch.cat(cos, dim=-1).float(), torch.cat(sin, dim=-1).float()


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    pairs = x.unflatten(-1, (-1, 2))
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x * cos + rotated * sin


class MLP(nn.Module):
    def __init__(self, in_dim: int, dim: int) -> None:
        super().__init__()

        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, x: Tensor, ops: Ops) -> Tensor:
        return self.linear_2(F.silu(self.linear_1(x, ops)), ops)


class Embed(nn.Module):
    def __init__(self, dim: int, pooled: int) -> None:
        super().__init__()

        self.timestep_embedder = MLP(256, dim)
        self.guidance_embedder = MLP(256, dim)
        self.text_embedder = MLP(pooled, dim)


class AdaNorm(nn.Module):
    def __init__(self, dim: int, n: int) -> None:
        super().__init__()

        self.linear = Linear(dim, n * dim)
        self.n = n

    def forward(self, emb: Tensor, ops: Ops) -> list[Tensor]:
        return [c[:, None] for c in self.linear(F.silu(emb), ops).chunk(self.n, dim=-1)]


class RMS(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()

        parameter(self, "weight", dim)


class FeedForward(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()

        proj = nn.Module()
        proj.proj = Linear(dim, 4 * dim)
        self.net = nn.ModuleList([proj, nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x: Tensor, ops: Ops) -> Tensor:
        return self.net[2](F.gelu(self.net[0].proj(x, ops), approximate="tanh"), ops)


def heads(x: Tensor, n: int) -> Tensor:
    return x.unflatten(-1, (n, -1)).transpose(1, 2)


class JointAttention(nn.Module):
    def __init__(self, dim: int, n: int) -> None:
        super().__init__()

        self.n = n
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out"):
            setattr(self, name, Linear(dim, dim))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, RMS(dim // n))
        self.to_out = nn.ModuleList([Linear(dim, dim)])


class DoubleBlock(nn.Module):
    def __init__(self, dim: int, n: int) -> None:
        super().__init__()

        self.norm1 = AdaNorm(dim, 6)
        self.norm1_context = AdaNorm(dim, 6)
        self.attn = JointAttention(dim, n)
        self.ff = FeedForward(dim)
        self.ff_context = FeedForward(dim)

    def forward(self, img: Tensor, txt: Tensor, emb: Tensor, cos: Tensor, sin: Tensor, ops: Ops):
        shift, scale, gate, shift_mlp, scale_mlp, gate_mlp = self.norm1(emb, ops)
        c_shift, c_scale, c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(emb, ops)
        a = self.attn
        h = layer_norm(img) * (1 + scale) + shift
        hc = layer_norm(txt) * (1 + c_scale) + c_shift

        q = rms_norm(heads(a.to_q(h, ops), a.n), a.norm_q.weight)
        k = rms_norm(heads(a.to_k(h, ops), a.n), a.norm_k.weight)
        v = heads(a.to_v(h, ops), a.n)
        qc = rms_norm(heads(a.add_q_proj(hc, ops), a.n), a.norm_added_q.weight)
        kc = rms_norm(heads(a.add_k_proj(hc, ops), a.n), a.norm_added_k.weight)
        vc = heads(a.add_v_proj(hc, ops), a.n)

        q = apply_rope(torch.cat([qc, q], dim=2), cos, sin)
        k = apply_rope(torch.cat([kc, k], dim=2), cos, sin)
        o = ops.attention(q, k, torch.cat([vc, v], dim=2)).transpose(1, 2).flatten(2)
        Lt = txt.shape[1]

        img = img + gate * a.to_out[0](o[:, Lt:], ops)
        img = img + gate_mlp * self.ff(layer_norm(img) * (1 + scale_mlp) + shift_mlp, ops)
        txt = txt + c_gate * a.to_add_out(o[:, :Lt], ops)
        txt = txt + c_gate_mlp * self.ff_context(layer_norm(txt) * (1 + c_scale_mlp) + c_shift_mlp, ops)
        return img, txt


class SingleAttention(nn.Module):
    def __init__(self, dim: int, n: int) -> None:
        super().__init__()

        self.n = n
        self.to_q, self.to_k, self.to_v = Linear(dim, dim), Linear(dim, dim), Linear(dim, dim)
        self.norm_q, self.norm_k = RMS(dim // n), RMS(dim // n)


class SingleBlock(nn.Module):
    def __init__(self, dim: int, n: int) -> None:
        super().__init__()

        self.norm = AdaNorm(dim, 3)
        self.proj_mlp = Linear(dim, 4 * dim)
        self.attn = SingleAttention(dim, n)
        self.proj_out = Linear(5 * dim, dim)

    def forward(self, x: Tensor, emb: Tensor, cos: Tensor, sin: Tensor, ops: Ops) -> Tensor:
        shift, scale, gate = self.norm(emb, ops)
        a = self.attn
        h = layer_norm(x) * (1 + scale) + shift

        q = apply_rope(rms_norm(heads(a.to_q(h, ops), a.n), a.norm_q.weight), cos, sin)
        k = apply_rope(rms_norm(heads(a.to_k(h, ops), a.n), a.norm_k.weight), cos, sin)
        v = heads(a.to_v(h, ops), a.n)
        o = ops.attention(q, k, v).transpose(1, 2).flatten(2)

        mlp = F.gelu(self.proj_mlp(h, ops), approximate="tanh")
        return x + gate * self.proj_out(torch.cat([o, mlp], dim=-1), ops)


class OutNorm(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()

        self.linear = Linear(dim, 2 * dim)


class Transformer(nn.Module):
    r"""`FluxTransformer2DModel` with guidance embeddings and patch size 1."""

    def __init__(self, config: dict) -> None:
        super().__init__()

        dim = config["num_attention_heads"] * config["attention_head_dim"]
        n = config["num_attention_heads"]
        if not config["guidance_embeds"] or config["patch_size"] != 1:
            raise ValueError("the reference covers FLUX.1-dev: guidance embeddings, patch size 1")

        self.axes = list(config["axes_dims_rope"])
        self.time_text_embed = Embed(dim, config["pooled_projection_dim"])
        self.context_embedder = Linear(config["joint_attention_dim"], dim)
        self.x_embedder = Linear(config["in_channels"], dim)
        self.transformer_blocks = nn.ModuleList([DoubleBlock(dim, n) for _ in range(config["num_layers"])])
        self.single_transformer_blocks = nn.ModuleList([SingleBlock(dim, n) for _ in range(config["num_single_layers"])])
        self.norm_out = OutNorm(dim)
        self.proj_out = Linear(dim, config["in_channels"])

    def forward(
        self, x: Tensor, t: Tensor, txt: Tensor, pooled: Tensor, guidance: Tensor, ops: Ops, dtype=torch.float64
    ) -> Tensor:
        r"""`x` (B, h, w, C) packed latents, `t` and `guidance` (B,), `txt`
        (B, Lt, 4096), `pooled` (B, 768); the guidance's embedding argument
        is rounded to `dtype`. Returns (B, h w, C), float32."""

        B, rows, cols, C = x.shape
        L = rows * cols
        x = x.reshape(B, L, C)
        e = self.time_text_embed
        emb = e.timestep_embedder(timestep_embedding(1000 * t), ops)
        emb = emb + e.guidance_embedder(timestep_embedding(served(1000 * guidance, dtype)), ops)
        emb = emb + e.text_embedder(pooled.float(), ops)

        img = self.x_embedder(x.float(), ops)
        txt = self.context_embedder(txt.float(), ops)

        grid = torch.stack(torch.meshgrid(torch.arange(rows), torch.arange(cols), indexing="ij"), dim=-1).reshape(-1, 2)
        ids = torch.zeros((txt.shape[1] + L, 3), dtype=torch.float64)
        ids[txt.shape[1] :, 1:] = grid.double()
        cos, sin = rope(ids.to(x.device), self.axes)

        for block in self.transformer_blocks:
            img, txt = block(img, txt, emb, cos, sin, ops)
        h = torch.cat([txt, img], dim=1)
        for block in self.single_transformer_blocks:
            h = block(h, emb, cos, sin, ops)
        h = h[:, txt.shape[1] :]

        scale, shift = (c[:, None] for c in self.norm_out.linear(F.silu(emb), ops).chunk(2, dim=-1))
        return self.proj_out(layer_norm(h) * (1 + scale) + shift, ops)


def parameters(config: dict) -> dict[str, tuple[int, ...]]:
    return shapes(Transformer(config["model"]))


def decay(config: dict):
    s = config["schedule"]
    alpha_min, sigma_min, gamma = s["alpha_min"], s["sigma_min"], s["gamma"]

    def schedule(t: Tensor) -> tuple[Tensor, Tensor]:
        tau = (1 - gamma ** t.double()) / (1 - gamma)
        return tau * alpha_min + (1 - tau), tau + (1 - tau) * sigma_min

    return schedule


def trajectory(config: dict, traffic: dict, state: dict, x: Tensor, cond: dict, precision: str = "float32"):
    r"""The reference's sample from `x` ((B, h, w, 64) packed latents, time
    1) under the cell's sampler, with the weights `state` and the text
    conditioning `cond` (`prompt_t5`, `prompt_clip`, `guidance`).

    Returns:
        The network output at the first call and the final sample, float64.
    """

    net = Transformer(config["model"])
    net.load_state_dict(state, strict=True, assign=True)
    ops = Ops(precision)
    schedule = decay(config)
    B = x.shape[0]
    dtype = getattr(torch, config["dtype"])
    guidance = served(torch.full((B,), float(cond["guidance"]), dtype=torch.float64, device=x.device), dtype)

    @torch.no_grad()
    def denoise(x_t: Tensor, t: Tensor) -> tuple[Tensor, Tensor]:
        alpha, sigma = schedule(t)
        c = 1 / (alpha + sigma)
        out = net(
            served(c * x_t, dtype), served(sigma * c, dtype).expand(B), cond["prompt_t5"], cond["prompt_clip"],
            guidance, ops, dtype,
        )
        out = out.reshape(x_t.shape).double()
        return c * x_t - sigma * c * out, out

    return SAMPLERS[traffic["sampler"]](denoise, schedule, x, traffic["steps"], traffic["eta"])
