r"""The ranks of the port's multi-rank tests on the CPU, and their launcher.

`tests/test_torch_parallel.py`, `tests/test_torch_ring.py`,
`tests/test_torch_ulysses.py` and `tests/test_torch_pipeline.py` each start
one group of `WORLD` processes
(:func:`launch`) that run every case of their suite under the `gloo`
backend, while the test process computes the JAX side; then they compare.
The ranks rendezvous through a `FileStore` in the test's temporary
directory (no TCP port, so that parallel test workers cannot collide), take
their inputs from `inputs.pt` there, and each writes its results to
`out_<rank>.pt`. Collectives time out after `TIMEOUT` seconds and the
launcher waits `DEADLINE` seconds at most, so that a hung rank fails the
tests in seconds. This module imports neither JAX nor the JAX package, and
each rank reports the modules it loaded so that the tests can check it.

A rank runs as

    python tests/torch_dist.py SUITE RANK WORLD DIRECTORY
"""

from __future__ import annotations

import copy
import datetime
import os
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from torch import nn  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from azula_tpu_torch import denoise, noise, parallel, sample  # noqa: E402
from azula_tpu_torch.nn.dit import DiT  # noqa: E402
from azula_tpu_torch.nn.layers import Linear, SineEncoding  # noqa: E402
from azula_tpu_torch.ops.attention import dot_product_attention  # noqa: E402
from azula_tpu_torch.parallel import tp  # noqa: E402
from azula_tpu_torch.parallel.ulysses import fold_in  # noqa: E402
from azula_tpu_torch.train import OPTAX_ADAMW  # noqa: E402
from azula_tpu_torch.utils.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded  # noqa: E402

WORLD = 4
TIMEOUT = 30.0
DEADLINE = 120.0

# the modules of the JAX tests, at their sizes
DUMMY = 5
TP_DIT = dict(in_channels=3, out_channels=3, mod_features=16, hid_channels=32, hid_blocks=2, attention_heads=4)  # noqa: C408
FSDP_DIT = dict(in_channels=3, out_channels=3, hid_channels=64, hid_blocks=2, attention_heads=4)  # noqa: C408
CKPT_DIT = dict(in_channels=3, out_channels=3, hid_channels=64, hid_blocks=1, attention_heads=4)  # noqa: C408
TRAIN_DIT = dict(in_channels=3, out_channels=3, mod_features=32, hid_channels=32, hid_blocks=2, attention_heads=4)  # noqa: C408
SP_DIT = dict(in_channels=16, out_channels=16, mod_features=8, hid_channels=32, hid_blocks=2)  # noqa: C408
FLUX = dict(  # noqa: C408
    in_channels=16,
    num_layers=2,
    num_single_layers=2,
    attention_head_dim=24,
    num_attention_heads=2,
    joint_attention_dim=32,
    pooled_projection_dim=20,
    axes_dims_rope=(8, 8, 8),
)
SANA = dict(  # noqa: C408
    in_channels=8,
    out_channels=8,
    num_attention_heads=4,
    attention_head_dim=8,
    num_cross_attention_heads=2,
    cross_attention_head_dim=16,
    caption_channels=24,
    num_layers=2,
    patch_size=1,
)
SD = dict(  # noqa: C408
    in_channels=4,
    out_channels=4,
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention_dim=24,
    attention_head_dim=2,
    cross_attention_levels=(True, False),
)
TRAIN_STEPS = 3
FSDP_MIN_SIZE = 1024
PP_BLOCK = dict(channels=32, mod_features=16, attention_heads=4)  # noqa: C408
PP_DIT = dict(in_channels=3, out_channels=3, mod_features=16, hid_channels=32, hid_blocks=8, attention_heads=4)  # noqa: C408
FLUX_MIN_SIZE = 256


class Dummy(nn.Module):
    r"""The port of `tests/dummies.py`'s `Dummy`: two Linears around a sine
    time encoding."""

    def __init__(self, features: int = DUMMY) -> None:
        super().__init__()

        self.l1 = Linear(features, 64, device="cpu")
        self.l2 = Linear(64, features, device="cpu")
        self.time_encoding = SineEncoding(64)

    def forward(self, x_t, t):
        return self.l2(torch.relu(self.l1(x_t) + self.time_encoding(t)))


class TimeDiT(nn.Module):
    r"""The port of `tests/test_parallel.py`'s `TimeDiT`: the denoiser's
    time, sine-encoded, as the DiT's modulation."""

    def __init__(self, dit: DiT, mod_features: int) -> None:
        super().__init__()

        self.dit = dit
        self.time_encoding = SineEncoding(mod_features)

    def forward(self, x_t, t, **kwargs):
        mod = self.time_encoding(t)
        if mod.ndim == 1:
            mod = mod.expand(x_t.shape[0], mod.shape[-1])
        return self.dit(x_t, mod=mod, **kwargs)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(a)


def _loaded(module: nn.Module, state: dict) -> nn.Module:
    module.load_state_dict(state)
    return module


def _gather_rows(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _gather_parameter(x: torch.Tensor, placement: tp.Placement, group) -> torch.Tensor:
    r"""The whole parameter from each rank's piece, on every rank."""

    n = dist.get_world_size(group)
    pieces = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(pieces, x.contiguous(), group=group)

    by_rank = [[t for t, _ in tp.split_pieces(piece, placement, n)] for piece in pieces]
    segments = [torch.cat([pieces[s] for pieces in by_rank], dim=placement.spec.dim) for s in range(len(by_rank[0]))]

    return tp.join_pieces(segments, placement)


def _sum(x: torch.Tensor, group=None) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def _whole_grads(module: nn.Module, mesh, data: bool = True) -> dict:
    r"""Every parameter's gradient of the whole loss, in the unsplit layout:
    tensor-parallel pieces gathered over 'model', then summed over 'data'
    (each data rank's loss is its rows')."""

    out = {}
    for name, p in module.named_parameters():
        g = p.grad
        placement = getattr(p, "placement", None)
        if placement is not None:
            g = _gather_parameter(g, placement, mesh.get_group(placement.axis))
        if data:
            g = _sum(g, mesh.get_group("data"))
        out[name] = g
    return out


def _sequence_split(x: torch.Tensor, group=None, dim: int = 1) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[r]


# ----------------------------------------------------------------- parallel


def parallel_data_parallel_sampling(inputs, rank):
    mesh = parallel.make_mesh(device="cpu")
    denoiser = denoise.KarrasDenoiser(_loaded(Dummy(), inputs["state"]), noise.VPSchedule())
    sampler = sample.DDIMSampler(denoiser, steps=8)
    x1 = _t(inputs["x1"])

    with torch.no_grad():
        local = sampler(parallel.shard_batch(x1, mesh))
        whole = parallel.gather_batch(local, mesh)
        alone = sampler(x1)

    return {"out": whole, "rows": tuple(local.shape), "equal": bool(torch.equal(whole, alone))}


def parallel_sample_sharded(inputs, rank):
    mesh = parallel.make_mesh(device="cpu")
    denoiser = denoise.KarrasDenoiser(_loaded(Dummy(), inputs["state"]), noise.VPSchedule())
    sampler = sample.DDIMSampler(denoiser, steps=8)

    with torch.no_grad():
        local = parallel.sample_sharded(sampler, (16, DUMMY), torch.Generator().manual_seed(3), mesh)
        whole = parallel.gather_batch(local, mesh)
        x1 = sampler.init((16, DUMMY), generator=torch.Generator().manual_seed(3))
        alone = sampler(x1)

    return {"out": whole, "x1": x1, "rows": tuple(local.shape), "equal": bool(torch.equal(whole, alone))}


def _tp_forward_and_grads(inputs, module, rules, call, batched: dict, whole: dict):
    r"""The module split over a (data=2, model=2) mesh: its output on each
    data rank's rows, gathered, and every parameter's gradient of the sum of
    the squared outputs, in the unsplit layout; and the unsplit module's
    gradients on the whole batch."""

    mesh = parallel.make_mesh(data=2, model=2, device="cpu")
    split = parallel.shard_module(module, mesh, rules=rules)
    specs = parallel.module_shardings(module, rules)

    kwargs = {k: parallel.shard_batch(_t(v), mesh) for k, v in batched.items()}
    kwargs.update({k: _t(v) for k, v in whole.items()})

    y = call(split, kwargs)
    (y.square().sum()).backward()

    # one rank, the whole batch, the module unsplit
    call(module, {k: _t(v) for k, v in {**batched, **whole}.items()}).square().sum().backward()

    return {
        "out": parallel.gather_batch(y.detach(), mesh),
        "grads": _whole_grads(split, mesh),
        "alone": {name: p.grad for name, p in module.named_parameters()},
        "split": sorted(name for name, spec in specs.items() if not isinstance(spec, tp.Replicate)),
        "heads": sorted({getattr(m, "heads") for m in split.modules() if isinstance(getattr(m, "heads", None), int)}),
    }


def parallel_tensor_parallel_dit(inputs, rank):
    module = _loaded(DiT(**TP_DIT, device="cpu"), inputs["state"])
    return _tp_forward_and_grads(
        inputs, module, parallel.DIT_TP_RULES, lambda m, kw: m(kw["x"], kw["mod"]),
        {"x": inputs["x"], "mod": inputs["mod"]}, {},
    )


def parallel_tensor_parallel_flux(inputs, rank):
    from azula_tpu_torch.models.flux.backbone import FluxTransformer

    module = _loaded(FluxTransformer(**FLUX, device="cpu"), inputs["state"])
    return _tp_forward_and_grads(
        inputs, module, parallel.FLUX_TP_RULES, lambda m, kw: m(**kw),
        {k: inputs[k] for k in ("hidden_states", "timestep", "encoder_hidden_states", "pooled_projections", "guidance")},
        {k: inputs[k] for k in ("img_ids", "txt_ids")},
    )


def _sana(inputs, qk_norm: bool):
    from azula_tpu_torch.models.sana.backbone import SanaTransformer

    module = _loaded(SanaTransformer(**SANA, qk_norm=qk_norm, device="cpu"), inputs["state"])
    return _tp_forward_and_grads(
        inputs, module, parallel.SANA_TP_RULES, lambda m, kw: m(**kw),
        {k: inputs[k] for k in ("hidden_states", "timestep", "encoder_hidden_states", "encoder_attention_mask")}, {},
    )


def parallel_tensor_parallel_sana1(inputs, rank):
    return _sana(inputs, False)


def parallel_tensor_parallel_sana15(inputs, rank):
    return _sana(inputs, True)


def parallel_tensor_parallel_sd(inputs, rank):
    from azula_tpu_torch.models.sd.backbone import SDUNet

    module = _loaded(SDUNet(**SD, device="cpu"), inputs["state"])
    return _tp_forward_and_grads(
        inputs, module, parallel.SD_TP_RULES, lambda m, kw: m(kw["x"], kw["t"], kw["ctx"]),
        {"x": inputs["x"], "t": inputs["t"], "ctx": inputs["ctx"]}, {},
    )


def parallel_fsdp_forward(inputs, rank):
    mesh = parallel.make_mesh(device="cpu")
    module = _loaded(DiT(**FSDP_DIT, device="cpu"), inputs["state"])
    split = parallel.shard_module_fsdp(module, mesh, min_size=FSDP_MIN_SIZE)

    x = parallel.shard_batch(_t(inputs["x"]), mesh)
    y = split(x)
    y.square().sum().backward()

    grads = {}
    for name, p in split.named_parameters():
        g = p.grad
        if hasattr(p, "placement"):
            # the backward averaged the whole gradient over the ranks
            g = _gather_parameter(g, p.placement, mesh.get_group("data")) * WORLD
        else:
            g = _sum(g, mesh.get_group("data"))
        grads[name] = g

    return {
        "out": parallel.gather_batch(y.detach(), mesh),
        "grads": grads,
        "n_split": sum(hasattr(p, "placement") for p in split.parameters()),
        "local_numel": sum(p.numel() for p in split.parameters()),
        "numel": sum(p.numel() for p in module.parameters()),
    }


def _roundtrip(split: nn.Module, fresh: nn.Module, mesh, path: pathlib.Path, x: torch.Tensor) -> dict:
    optimizer = torch.optim.AdamW(split.parameters(), **OPTAX_ADAMW)
    split(x).square().mean().backward()
    optimizer.step()

    save_checkpoint_sharded(path, split, optimizer, mesh)

    # another learning rate, which the checkpoint's param groups replace
    optimizer2 = torch.optim.AdamW(fresh.parameters(), **{**OPTAX_ADAMW, "lr": 5e-4})
    load_checkpoint_sharded(path, fresh, optimizer2, mesh)

    params = all(torch.equal(a, b) for a, b in zip(split.parameters(), fresh.parameters(), strict=True))
    state = all(
        set(optimizer.state[a]) == set(optimizer2.state[b])
        and all(torch.equal(optimizer.state[a][k], optimizer2.state[b][k]) for k in optimizer.state[a])
        for a, b in zip(split.parameters(), fresh.parameters(), strict=True)
    )
    with torch.no_grad():
        out = torch.equal(split(x), fresh(x))

    return {"params": params, "optimizer": state, "out": out, "groups": optimizer2.param_groups[0]["lr"]}


def parallel_sharded_checkpoint_roundtrip(inputs, rank):
    directory = pathlib.Path(inputs["directory"])
    module = _loaded(DiT(**CKPT_DIT, device="cpu"), inputs["state"])
    other = DiT(**CKPT_DIT, device="cpu", generator=torch.Generator().manual_seed(99))
    x = _t(inputs["x"])

    out = {}
    mesh = parallel.make_mesh(data=2, model=2, device="cpu")
    out["tp"] = _roundtrip(
        parallel.shard_module(module, mesh), parallel.shard_module(other, mesh), mesh, directory / "tp", x
    )
    mesh = parallel.make_mesh(device="cpu")
    out["fsdp"] = _roundtrip(
        parallel.shard_module_fsdp(module, mesh, min_size=FSDP_MIN_SIZE),
        parallel.shard_module_fsdp(other, mesh, min_size=FSDP_MIN_SIZE),
        mesh, directory / "fsdp", x,
    )

    return out


def _train(denoiser, step, inputs) -> None:
    for i in range(TRAIN_STEPS):
        step(_t(inputs["x"]), _t(inputs["t"]))
        del i


def parallel_dp_tp_train_step(inputs, rank):
    noises = [_t(z) for z in inputs["z"]]

    def build():
        dit = DiT(**TRAIN_DIT, device="cpu")
        backbone = TimeDiT(dit, TRAIN_DIT["mod_features"])
        backbone.load_state_dict(inputs["state"])
        return denoise.KarrasDenoiser(backbone, noise.RectifiedSchedule())

    # one rank on the whole batch
    alone = build()
    optimizer = torch.optim.AdamW(alone.parameters(), **OPTAX_ADAMW)
    for z in noises:
        alone._loss(_t(inputs["x"]), _t(inputs["t"]), z).backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    mesh = parallel.make_mesh(data=2, model=2, device="cpu")
    split = parallel.shard_module(build(), mesh)
    optimizer = torch.optim.AdamW(split.parameters(), **OPTAX_ADAMW)
    state = parallel.ShardedTrainState(split, optimizer, mesh)
    draws = iter(noises)
    state._normal = lambda generator, like: next(draws)  # JAX's noise, the whole batch's

    def whole(tensors: dict) -> dict:
        out = {}
        for name, p in split.named_parameters():
            placement = getattr(p, "placement", None)
            t = tensors[name]
            out[name] = t if placement is None else _gather_parameter(t, placement, mesh.get_group("model"))
        return out

    # the first step's gradients, averaged over 'data', as the optimizer takes them
    first, update = {}, optimizer.step

    def step(*args, **kwargs):
        if not first:
            first.update(whole({name: p.grad.clone() for name, p in split.named_parameters()}))
        return update(*args, **kwargs)

    optimizer.step = step
    losses = [state.step(_t(inputs["x"]), _t(inputs["t"])) for _ in noises]

    return {
        "params": whole({name: p.detach() for name, p in split.named_parameters()}),
        "grads": first,
        "alone": {k: v.detach() for k, v in alone.named_parameters()},
        "losses": losses,
    }


def parallel_hybrid_mesh(inputs, rank):
    mesh = parallel.make_hybrid_mesh(replica=2, data=1, model=2, device="cpu")
    x = torch.arange(8.0 * 4).reshape(8, 4)

    block = mesh.get_local_rank("replica") * mesh.size(1) + mesh.get_local_rank("data")
    rows = x.chunk(mesh.size(0) * mesh.size(1))[block]
    piece = rows.chunk(mesh.size(2), dim=1)[mesh.get_local_rank("model")]
    out = _sum(piece, mesh.get_group("model"))

    return {"names": mesh.mesh_dim_names, "shape": tuple(mesh.mesh.shape), "out": out, "want": rows[:, :2] + rows[:, 2:]}


def parallel_hybrid_mesh_defaults(inputs, rank):
    mesh = parallel.make_hybrid_mesh(model=2, device="cpu")
    return {"names": mesh.mesh_dim_names, "shape": tuple(mesh.mesh.shape)}


# --------------------------------------------------------------------- ring


def _attention_case(fn, inputs, grads: bool = True, mask=None, **kwargs):
    q, k, v = (_t(inputs[name]).requires_grad_() for name in "qkv")
    local = fn(q, k, v, mask=mask, **kwargs)
    out = _gather_rows(local.detach(), dim=2)
    result = {"out": out, "local": tuple(local.shape)}
    if grads:
        local.square().sum().backward()
        result["grads"] = [_sum(t.grad) for t in (q, k, v)]
    return result


def ring_matches_full(inputs, rank):
    return _attention_case(parallel.ring_attention, inputs, grads=False)


def ring_matches_full_bf16(inputs, rank):
    q, k, v = (_t(inputs[name]).bfloat16() for name in "qkv")
    return {"out": _gather_rows(parallel.ring_attention(q, k, v), dim=2).float()}


def ring_grads(inputs, rank):
    return _attention_case(parallel.ring_attention, inputs)


def ring_mask(inputs, rank):
    return _attention_case(parallel.ring_attention, inputs, mask=_t(inputs["mask"]))


def ring_per_head_mask_raises(inputs, rank):
    q = torch.zeros(1, 2, 32, 8)
    try:
        parallel.ring_attention(q, q, q, mask=torch.ones(1, 2, 32, 32, dtype=torch.bool))
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def _sequence_parallel_dit(inputs, implementation: str, heads: int):
    dit = _loaded(DiT(**SP_DIT, attention_heads=heads, device="cpu"), inputs["state"])
    for block in dit.blocks:
        block.msa.implementation = implementation
        block.msa.ring_axis = dist.group.WORLD

    x = _sequence_split(_t(inputs["x"]))
    pos = _sequence_split(_t(inputs["pos"]))
    y = dit(x, mod=_t(inputs["mod"]), pos=pos)
    y.square().sum().backward()

    return {
        "out": _gather_rows(y.detach(), dim=1),
        "grads": {name: _sum(p.grad) for name, p in dit.named_parameters()},
    }


def ring_dit_sequence_parallel(inputs, rank):
    return _sequence_parallel_dit(inputs, "ring", 2)


def ring_msa_refuses_dropout(inputs, rank):
    from azula_tpu_torch.nn.attention import MultiheadSelfAttention

    msa = MultiheadSelfAttention(16, attention_heads=2, dropout=0.1, implementation="ring", device="cpu")
    try:
        msa(torch.zeros(1, 8, 16), generator=torch.Generator())
    except NotImplementedError as e:
        return {"raised": str(e)}
    return {"raised": None}


# ------------------------------------------------------------------ ulysses


def ulysses_matches_full(inputs, rank):
    return _attention_case(parallel.ulysses_attention, inputs, grads=False)


def ulysses_grads(inputs, rank):
    return _attention_case(parallel.ulysses_attention, inputs)


def ulysses_head_divisibility(inputs, rank):
    q = torch.zeros(1, 6, 64, 8)  # 6 heads, 4 ranks
    try:
        parallel.ulysses_attention(q, q, q)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def ulysses_dit_sequence_parallel(inputs, rank):
    return _sequence_parallel_dit(inputs, "ulysses", 8)


def ulysses_mask(inputs, rank):
    return _attention_case(parallel.ulysses_attention, inputs, grads=False, mask=_t(inputs["mask"]))


def ulysses_dropout(inputs, rank):
    q, k, v = (_t(inputs[name]) for name in "qkv")

    def run(rate, seed):
        return _gather_rows(parallel.ulysses_attention(q, k, v, dropout_rate=rate, generator=torch.Generator().manual_seed(seed)), dim=2)

    out0 = run(1e-12, 7)
    out = run(0.5, 7)
    again = run(0.5, 7)

    # this rank's heads, as one process computes them with the folded generator
    H = q.shape[1] // WORLD
    heads = slice(rank * H, (rank + 1) * H)
    alone = dot_product_attention(
        q[:, heads], k[:, heads], v[:, heads], dropout_rate=0.5, generator=fold_in(torch.Generator().manual_seed(7), rank)
    )

    return {"out0": out0, "out": out, "again": again, "own_heads_equal": bool(torch.equal(out[:, heads], alone))}


def ulysses_tp_composition(inputs, rank):
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("seq", "tp"))
    q, k, v = (_t(inputs[name]).requires_grad_() for name in "qkv")

    def local(t):
        t = t.chunk(2, dim=1)[mesh.get_local_rank("tp")]
        return t.chunk(2, dim=2)[mesh.get_local_rank("seq")]

    y = parallel.ulysses_attention_local(local(q), local(k), local(v), axis=mesh.get_group("seq"))
    y.square().sum().backward()

    rows = _gather_rows(y.detach(), mesh.get_group("seq"), dim=2)
    out = _gather_rows(rows, mesh.get_group("tp"), dim=1)

    return {"out": out, "grads": [_sum(q.grad)]}


# ----------------------------------------------------------------- pipeline


def _stage_slices(t: torch.Tensor, group) -> torch.Tensor:
    r"""The whole stack of a parameter from each stage's slice of its
    gradient (each rank's gradient is zero outside its slice)."""

    n, r = dist.get_world_size(group), dist.get_rank(group)
    k = t.shape[0] // n
    return _gather_rows(t[r * k : (r + 1) * k].contiguous(), group)


def tanh_block(p, x):
    r"""The block of `tests/test_parallel.py`'s pipeline tests."""

    return x + torch.tanh(x @ p["w"] + p["b"])


def pipeline_blocks_equality(inputs, rank):
    mesh = parallel.make_mesh(model=WORLD, device="cpu")
    params = {k: _t(inputs[k]) for k in ("w", "b")}
    x = _t(inputs["x"])

    with torch.no_grad():
        return {
            f"M={m}": parallel.pipeline_blocks(tanh_block, params, x, mesh, microbatches=m)
            for m in (None, 8)
        }


def pipeline_real_dit_blocks(inputs, rank):
    from azula_tpu_torch.nn.dit import DiTBlock

    mesh = parallel.make_mesh(model=WORLD, device="cpu")
    blocks = [_loaded(DiTBlock(**PP_BLOCK, device="cpu"), state) for state in inputs["states"]]
    x, mod = _t(inputs["x"]), torch.ones(1, PP_BLOCK["mod_features"])

    params, apply = parallel.stack_modules(blocks)
    with torch.no_grad():
        out = parallel.pipeline_blocks(lambda p, h: apply(p, h, mod), params, x, mesh)

    try:
        parallel.stack_modules([blocks[0], DiTBlock(**{**PP_BLOCK, "attention_heads": 2, "channels": 16}, device="cpu")])
        refused = False
    except ValueError:
        refused = True

    return {"out": out, "refused": refused}


def pipeline_blocks_grads(inputs, rank):
    mesh = parallel.make_mesh(model=WORLD, device="cpu")
    w = _t(inputs["w"]).requires_grad_()
    x = _t(inputs["x"]).requires_grad_()

    out = parallel.pipeline_blocks(lambda p, h: h + torch.tanh(h @ p["w"]), {"w": w}, x, mesh)
    out.square().sum().backward()

    return {"w": _stage_slices(w.grad, mesh.get_group("model")), "x": x.grad}


def pipeline_blocks_pytree_state(inputs, rank):
    mesh = parallel.make_mesh(model=WORLD, device="cpu")

    def block_fn(p, state, shift):
        h = state["h"] + torch.tanh(state["scale"] * (state["h"] @ p["w"]) + shift)
        return {**state, "h": h}

    with torch.no_grad():
        out = parallel.pipeline_blocks(
            block_fn, {"w": _t(inputs["w"])}, {"h": _t(inputs["x"]), "scale": _t(inputs["scale"])}, mesh,
            consts=(_t(inputs["shift"]),),
        )

    return out


def pipeline_dit_equality(inputs, rank):
    mesh = parallel.make_mesh(model=WORLD, device="cpu")
    out = {}
    for name, case in inputs.items():
        dit = _loaded(DiT(**PP_DIT, **case.get("config", {}), device="cpu"), case["state"])
        forward = parallel.pipeline_dit(dit, mesh)
        kwargs = {k: _t(case[k]) for k in ("mod", "pos") if k in case}
        with torch.no_grad():
            out[name] = forward(_t(case["x"]), **kwargs)
    return out


def pipeline_dit_grads(inputs, rank):
    mesh = parallel.make_mesh(model=WORLD, device="cpu")
    dit = _loaded(DiT(**{**PP_DIT, "hid_blocks": 4}, device="cpu"), inputs["state"])
    x, mod = _t(inputs["x"]).requires_grad_(), _t(inputs["mod"]).requires_grad_()

    parallel.pipeline_dit(dit, mesh)(x, mod).square().sum().backward()

    # every parameter the backward reached on this rank: the replicated
    # projections and this rank's stage's blocks
    params = {name: p.grad for name, p in dit.named_parameters() if p.grad is not None}

    return {"x": x.grad, "mod": mod.grad, "params": params}


def _flux_denoiser(state):
    from azula_tpu_torch.models.flux import FluxDenoiser
    from azula_tpu_torch.models.flux.backbone import FluxTransformer

    return FluxDenoiser(_loaded(FluxTransformer(**FLUX, device="cpu"), state))


def _whole(p: torch.Tensor, mesh) -> torch.Tensor:
    r"""The whole parameter from each rank's piece of a serving placement:
    the 'data' split gathered first, then the tensor-parallel one."""

    placement = getattr(p, "placement", None)
    p = p.detach()
    if placement is None:
        return p
    if placement.then is not None:
        axis, dim = placement.then
        p = _gather_rows(p, mesh.get_group(axis), dim=dim)
        placement = placement._replace(then=None)
    return _gather_parameter(p, placement, mesh.get_group(placement.axis))


def pipeline_serve_flux(inputs, rank):
    mesh = parallel.make_mesh(data=2, model=2, device="cpu")
    x1 = _t(inputs["x1"])
    positive, negative = ({k: v if isinstance(v, float) else _t(v) for k, v in inputs[c].items()} for c in ("positive", "negative"))

    denoiser = _flux_denoiser(inputs["state"])
    specs = parallel.flux_serving_shardings(denoiser, mesh, min_size=FLUX_MIN_SIZE)
    whole = {name: p.detach().clone() for name, p in denoiser.named_parameters()}

    with torch.no_grad():
        sampler = parallel.serve_flux(denoiser, mesh, steps=3, min_size=FLUX_MIN_SIZE)
        out = parallel.gather_batch(sampler(x1, positive), mesh)
        cfg = parallel.gather_batch(sampler(x1, positive, negative=negative, guidance=2.5), mesh)

        chunked = parallel.serve_flux(_flux_denoiser(inputs["state"]), mesh, steps=3, microbatch=4, min_size=FLUX_MIN_SIZE)
        mb = parallel.gather_batch(chunked(x1, positive, negative=negative, guidance=2.5), mesh)

    # the placement: every piece's size, and the whole parameters again
    pieces = {name: tuple(p.shape) for name, p in denoiser.named_parameters()}
    unjoined = [name for name, p in denoiser.named_parameters() if not torch.equal(_whole(p, mesh), whole[name])]

    # the sharded checkpoint of the placement, into another placed denoiser
    directory = pathlib.Path(inputs["directory"])
    save_checkpoint_sharded(directory, denoiser, mesh=mesh)
    other = _flux_denoiser(inputs["state"])
    with torch.no_grad():
        for p in other.parameters():
            p.zero_()
    other = parallel.recipes._place(other, mesh, FLUX_MIN_SIZE)
    load_checkpoint_sharded(directory, other, mesh=mesh)
    restored = all(torch.equal(a, b) for a, b in zip(denoiser.parameters(), other.parameters(), strict=True))
    dims = sorted({(p.placement.axis, p.placement.then is not None) for p in other.parameters() if hasattr(p, "placement")})

    # a placed denoiser is served again on its own placement only
    refused = {}
    elsewhere = {
        "min_size": (denoiser, FLUX_MIN_SIZE + 1),
        "shard_module": (tp.shard_module(_flux_denoiser(inputs["state"]), mesh, rules=tp.FLUX_TP_RULES), FLUX_MIN_SIZE),
    }
    for case, (module, min_size) in elsewhere.items():
        try:
            parallel.serve_flux(module, mesh, steps=3, min_size=min_size)
            refused[case] = None
        except ValueError as e:
            refused[case] = str(e)
    parallel.serve_flux(denoiser, mesh, steps=3, min_size=FLUX_MIN_SIZE)

    return {
        "specs": {name: tuple((type(p).__name__, getattr(p, "dim", None)) for p in spec) for name, spec in specs.items()},
        "pieces": pieces,
        "unjoined": unjoined,
        "restored": restored,
        "dims": dims,
        "refused": refused,
        "out": out,
        "cfg": cfg,
        "mb": mb,
    }


SUITES = {
    suite: {name.removeprefix(suite + "_"): fn for name, fn in globals().items() if name.startswith(suite + "_") and callable(fn)}
    for suite in ("parallel", "ring", "ulysses", "pipeline")
}


# ---------------------------------------------------------------- launcher


def launch(suite: str, directory: pathlib.Path, inputs: dict, world: int = WORLD) -> list[subprocess.Popen]:
    r"""Writes `inputs` (by case) and starts the suite's ranks."""

    torch.save(inputs, directory / "inputs.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

    return [
        subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()), suite, str(rank), str(world), str(directory)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]


def collect(procs: list[subprocess.Popen], directory: pathlib.Path, deadline: float = DEADLINE) -> list[dict]:
    r"""Waits for the ranks until `deadline` seconds have passed, kills the
    rest, and returns each rank's results; raises with the ranks' output if
    one failed or hung."""

    end = time.monotonic() + deadline
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=max(end - time.monotonic(), 0.1))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            logs.append("(killed at the deadline)")

    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(f"rank {i}: {log}" for i, log in enumerate(logs)))

    return [torch.load(directory / f"out_{rank}.pt", weights_only=False) for rank in range(len(procs))]


def main() -> None:
    suite, rank, world, directory = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), pathlib.Path(sys.argv[4])
    torch.set_num_threads(1)
    torch.manual_seed(0)

    store = dist.FileStore(str(directory / "store"), world)
    parallel.initialize_distributed("gloo", store=store, world_size=world, rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT))

    inputs = torch.load(directory / "inputs.pt", weights_only=False)
    out = {}
    for name, fn in SUITES[suite].items():
        t0 = time.perf_counter()
        try:
            out[name] = fn(copy.deepcopy(inputs.get(name, {})), rank)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
        out[name]["seconds"] = time.perf_counter() - t0

    out["modules"] = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "azula_tpu"})
    torch.save(out, directory / f"out_{rank}.pt")

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
