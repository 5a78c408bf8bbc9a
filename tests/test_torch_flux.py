r"""The PyTorch port's Flux serving path against the JAX package's, on the CPU:
`DecaySchedule`, the transformer's helpers, both block kinds, the whole
`FluxTransformer` (dev and schnell), `FluxDenoiser` under DDIM-4, the
weight converter in both directions, and the max-free attention.

JAX's max-free forward is a Pallas kernel (`_pallas_attention_blocked` for
L > 2048, `_pallas_attention` up to it); it runs here in interpret mode
(`pltpu.force_tpu_interpret_mode()`), and the port's plain version is held
against it. The CUDA kernel is held against the same plain version on the
card by `chip_smoke.py`. On the CPU, `dot_product_attention(max_free=True)`
computes the exact softmax in both packages. Inputs come from seeded numpy
generators. Tolerances are relative to max |JAX| unless stated: float32 1e-5
(the same arithmetic in another order, and float32 sin/cos arguments that
differ by an ulp), bfloat16 2e-2 (one bf16 rounding of a value that lies on
an edge, through a few layers).
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from jax.experimental.pallas import tpu as pltpu

from azula_tpu import noise as jnoise
from azula_tpu.models import flux as jflux
from azula_tpu.models.flux import backbone as jbackbone
from azula_tpu.models.flux.convert import convert_flux_state_dict
from azula_tpu.models.sd.backbone import sinusoidal_timestep_embedding as jax_timestep_embedding
from azula_tpu.ops import attention as jattention
from azula_tpu.sample import DDIMSampler as JaxDDIM
from azula_tpu.utils.pytree import filter_eval_shape, load_state_dict, state_dict
from azula_tpu_torch import noise as tnoise
from azula_tpu_torch.models import flux as tflux
from azula_tpu_torch.models.flux import backbone as tbackbone
from azula_tpu_torch.models.flux.convert import from_jax_state_dict
from azula_tpu_torch.models.utils import load_cards
from azula_tpu_torch.nn import layers as tlayers
from azula_tpu_torch.ops import _build
from azula_tpu_torch.ops import attention as tattention
from azula_tpu_torch.sample import DDIMSampler as TorchDDIM

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# the small configuration of tests/test_models_flux.py
SMALL = dict(  # noqa: C408
    in_channels=16,
    num_layers=2,
    num_single_layers=2,
    attention_head_dim=24,
    num_attention_heads=2,
    joint_attention_dim=32,
    pooled_projection_dim=20,
    axes_dims_rope=(8, 8, 8),
)
DIM = SMALL["num_attention_heads"] * SMALL["attention_head_dim"]


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _normal(rng, shape, scale=1.0) -> np.ndarray:
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _random_state(module, seed: int) -> dict[str, np.ndarray]:
    r"""Random arrays for every leaf of a JAX Flux module: Linear weights
    (in, out) at 1 / sqrt(fan in), biases at 0.2, RMSNorm scales about 1."""

    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in state_dict(module).items():
        shape = tuple(leaf.shape)
        if key.endswith("scale"):
            value = 1 + 0.2 * rng.standard_normal(shape)
        elif key.endswith("bias"):
            value = 0.2 * rng.standard_normal(shape)
        else:
            value = rng.standard_normal(shape) / math.sqrt(shape[0])
        out[key] = value.astype(np.float32)
    return out


def _load_jax(module, sd):
    return load_state_dict(module, {k: jnp.asarray(v) for k, v in sd.items()})


def _ids(H: int, W: int, Lt: int) -> tuple[np.ndarray, np.ndarray]:
    return tflux.FluxDenoiser.coordinates(H, W), np.zeros((Lt, 3), dtype=np.float32)


def _transformer_pair(guidance_embeds: bool, seed: int = 0):
    r"""The same random small transformer in JAX and in the port (CPU)."""

    cfg = {**SMALL, "guidance_embeds": guidance_embeds}
    sd = _random_state(jbackbone.FluxTransformer(**cfg, key=jax.random.key(0)), seed)
    jmodel = _load_jax(jbackbone.FluxTransformer(**cfg, key=jax.random.key(0)), sd)

    tmodel = tbackbone.FluxTransformer(**cfg, device="cpu")
    tmodel.load_state_dict(from_jax_state_dict(sd, tmodel))

    return jmodel, tmodel, sd


# DecaySchedule


@pytest.mark.parametrize("params", [{}, {"alpha_min": 1e-2, "sigma_min": 1e-2, "gamma": 0.05}], ids=["default", "custom"])
def test_decay_schedule_matches_jax(params):
    t = np.random.default_rng(0).uniform(0, 1, 257).astype(np.float32)
    t[:2] = [0.0, 1.0]

    want = jnoise.DecaySchedule(**params)(jnp.asarray(t))
    got = tnoise.DecaySchedule(**params)(torch.from_numpy(t))

    for a, b in zip(got, want, strict=True):
        assert a.dtype == torch.float32
        assert np.abs(_f64(a) - _f64(b)).max() <= 1e-6


@pytest.mark.parametrize("steps", [4, 28, 50])
def test_decay_schedule_at_ddim_times(steps):
    jsampler = JaxDDIM(jflux.FluxDenoiser(None), steps=steps)
    tsampler = TorchDDIM(tflux.FluxDenoiser(torch.nn.Identity()), steps=steps)

    assert np.array_equal(_f64(tsampler.timesteps), _f64(jsampler.timesteps))

    want = jnoise.DecaySchedule()(jsampler.timesteps)
    got = tnoise.DecaySchedule()(tsampler.timesteps)
    for a, b in zip(got, want, strict=True):
        assert np.abs(_f64(a) - _f64(b)).max() <= 1e-6


# helpers


def test_timestep_embedding_matches_jax():
    t = np.asarray([0.0, 0.001, 0.3, 0.5, 0.9, 1.0, 4.0], dtype=np.float32) * 1000

    want = jax_timestep_embedding(jnp.asarray(t), 256)
    got = tbackbone.sinusoidal_timestep_embedding(torch.from_numpy(t), 256)

    assert got.dtype == torch.float32 and tuple(got.shape) == (7, 256)
    # XLA's and PyTorch's float32 exp differ by an ulp on some frequencies:
    # an error of about an ulp of the largest argument (4000)
    assert np.abs(_f64(got) - _f64(want)).max() <= 2 * np.spacing(np.float32(4000))


def test_rope_tables_match_jax():
    # the 1024 px layout: 512 text tokens and 64 x 64 image tokens
    img_ids, txt_ids = _ids(64, 64, 512)
    ids = np.concatenate([txt_ids, img_ids])

    want = jbackbone.rope_cos_sin(jnp.asarray(ids), (16, 56, 56))
    got = tbackbone.rope_cos_sin(torch.from_numpy(ids), (16, 56, 56))

    for a, b in zip(got, want, strict=True):
        assert a.dtype == torch.float32 and tuple(a.shape) == (4608, 128)
        # float32 sin/cos of the same arguments, up to an ulp of the largest (63)
        assert np.abs(_f64(a) - _f64(b)).max() <= 2 * np.spacing(np.float32(63))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, 3, 40, 24))
    img_ids, txt_ids = _ids(6, 5, 10)
    cos, sin = jbackbone.rope_cos_sin(jnp.asarray(np.concatenate([txt_ids, img_ids])), (8, 8, 8))

    want = jbackbone.apply_rope(jnp.asarray(x).astype(jd), cos, sin)
    got = tbackbone.apply_rope(torch.from_numpy(x).to(td), *(torch.tensor(np.asarray(a)) for a in (cos, sin)))

    assert got.dtype == td
    assert _rel_err(got, want) <= (1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_norms_match_jax(norm, dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, 7, 24)) * 3 + 1
    scale = 1 + _normal(rng, (24,), 0.2)

    if norm == "layer":
        jnorm, tnorm = jbackbone.LayerNorm(), tlayers.LayerNorm(eps=1e-6)
    else:
        jnorm = _load_jax(jbackbone.RMSNorm(24), {"scale": scale})
        tnorm = tbackbone.RMSNorm(24, device="cpu")
        tnorm.load_state_dict({"weight": torch.from_numpy(scale)})

    want = jnorm(jnp.asarray(x).astype(jd))
    with torch.no_grad():
        got = tnorm(torch.from_numpy(x).to(td))

    assert got.dtype == td
    assert _rel_err(got, want) <= (1e-6 if dtype == "float32" else 1e-2)


# blocks


def _block_inputs(seed: int, Lt: int = 6, side: int = 4):
    rng = np.random.default_rng(seed)
    img = _normal(rng, (2, side * side, DIM))
    txt = _normal(rng, (2, Lt, DIM))
    emb = _normal(rng, (2, DIM))
    img_ids, txt_ids = _ids(side, side, Lt)
    cos, sin = jbackbone.rope_cos_sin(jnp.asarray(np.concatenate([txt_ids, img_ids])), SMALL["axes_dims_rope"])
    return img, txt, emb, np.array(cos), np.array(sin)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dual", "single"])
def test_block_matches_jax(kind, dtype):
    jd, td = DTYPES[dtype]
    heads = SMALL["num_attention_heads"]
    img, txt, emb, cos, sin = _block_inputs(3)

    if kind == "dual":
        jblock = jbackbone.FluxTransformerBlock(DIM, heads, key=jax.random.key(1))
        tblock = tbackbone.FluxTransformerBlock(DIM, heads, device="cpu")
    else:
        jblock = jbackbone.FluxSingleTransformerBlock(DIM, heads, key=jax.random.key(1))
        tblock = tbackbone.FluxSingleTransformerBlock(DIM, heads, device="cpu")

    sd = _random_state(jblock, 4)
    jblock = _load_jax(jblock, sd).astype(jd)
    tblock.load_state_dict(from_jax_state_dict(sd, tblock))
    tblock.to(td)

    def jx(a):
        return jnp.asarray(a).astype(jd)

    def tx(a):
        return torch.from_numpy(a).to(td)

    tables = (torch.from_numpy(cos), torch.from_numpy(sin))
    with torch.no_grad():
        if kind == "dual":
            want = jblock(jx(img), jx(txt), jx(emb), jnp.asarray(cos), jnp.asarray(sin))
            got = tblock(tx(img), tx(txt), tx(emb), *tables)
        else:
            h = np.concatenate([txt, img], axis=1)
            want = (jblock(jx(h), jx(emb), jnp.asarray(cos), jnp.asarray(sin)),)
            got = (tblock(tx(h), tx(emb), *tables),)

    for a, b in zip(got, want, strict=True):
        assert a.dtype == td and tuple(a.shape) == tuple(b.shape)
        assert _rel_err(a, b) <= TOL[dtype]


# the whole transformer


def _transformer_inputs(seed: int, guidance_embeds: bool):
    rng = np.random.default_rng(seed)
    B, H, W, Lt = 2, 4, 4, 6
    img_ids, txt_ids = _ids(H, W, Lt)
    return dict(  # noqa: C408
        hidden_states=_normal(rng, (B, H * W, 16)),
        timestep=np.asarray([0.3, 0.9], dtype=np.float32),
        encoder_hidden_states=_normal(rng, (B, Lt, 32)),
        pooled_projections=_normal(rng, (B, 20)),
        img_ids=img_ids,
        txt_ids=txt_ids,
        guidance=np.asarray([4.0, 2.0], dtype=np.float32) if guidance_embeds else None,
    )


@pytest.mark.parametrize("guidance_embeds", [True, False], ids=["dev", "schnell"])
def test_transformer_matches_jax(guidance_embeds):
    jmodel, tmodel, _ = _transformer_pair(guidance_embeds)
    inputs = _transformer_inputs(5, guidance_embeds)

    want = jmodel(**{k: None if v is None else jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        got = tmodel(**{k: None if v is None else torch.from_numpy(v) for k, v in inputs.items()})

    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 16, 16)
    assert _rel_err(got, want) <= TOL["float32"]


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_transformer_matches_jax_bf16(seed):
    # dev in bf16, every input cast as FluxDenoiser casts it: the casts inside
    # the forward (the embedding, the guidance's g * 1000) are held to JAX's.
    # 3500 and 1250 are not bf16 numbers, so g * 1000 taken in float32 shows.
    # The two packages round the same bf16 arithmetic summed in other orders;
    # through the whole small model that came to 0.7-2.3e-2 on these inputs,
    # where a float32 g * 1000 gives 0.24-0.37: hence 5e-2, not the blocks' 2e-2.
    jmodel, tmodel, _ = _transformer_pair(True)
    jmodel, tmodel = jmodel.astype(jnp.bfloat16), tmodel.to(torch.bfloat16)
    inputs = dict(_transformer_inputs(seed, True), guidance=np.asarray([3.5, 1.25], dtype=np.float32))

    want = jmodel(**{k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in inputs.items()})
    with torch.no_grad():
        got = tmodel(**{k: torch.from_numpy(v).to(torch.bfloat16) for k, v in inputs.items()})

    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 16, 16)
    assert _rel_err(got, want) <= 5e-2


def test_transformer_without_guidance_uses_zeros():
    # dev with guidance None embeds g = 0, as in JAX
    jmodel, tmodel, _ = _transformer_pair(True, seed=1)
    inputs = dict(_transformer_inputs(6, True), guidance=None)

    want = jmodel(**{k: None if v is None else jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        got = tmodel(**{k: None if v is None else torch.from_numpy(v) for k, v in inputs.items()})

    assert _rel_err(got, want) <= TOL["float32"]


def test_twin_state_dict_loads_as_it_is():
    # the port's keys are the checkpoints' (diffusers) names: the PyTorch twin
    # of FluxTransformer2DModel loads without renames and agrees
    from torch_twins.flux_mmdit import FluxTransformerTwin

    torch.manual_seed(0)
    twin = FluxTransformerTwin(**SMALL).eval()
    tmodel = tbackbone.FluxTransformer(**SMALL, device="cpu")
    tmodel.load_state_dict(twin.state_dict(), strict=True)

    inputs = {k: None if v is None else torch.from_numpy(v) for k, v in _transformer_inputs(7, True).items()}
    with torch.no_grad():
        want = twin(**inputs)
        got = tmodel(**inputs)

    assert _rel_err(got, want) <= TOL["float32"]


# the denoiser and the sampler


def _denoiser_pair(seed: int = 0):
    jmodel, tmodel, _ = _transformer_pair(True, seed)
    return jflux.FluxDenoiser(jmodel), tflux.FluxDenoiser(tmodel)


def _conditioning(seed: int):
    rng = np.random.default_rng(seed)
    return _normal(rng, (2, 4, 4, 16)), _normal(rng, (2, 20)), _normal(rng, (1, 6, 32))


@pytest.mark.parametrize("t", [0.2, 0.7, 1.0])
def test_denoiser_matches_jax(t):
    jd, td = _denoiser_pair(2)
    z, clip, t5 = _conditioning(8)

    want = jd(jnp.asarray(z), jnp.float32(t), prompt_clip=jnp.asarray(clip), prompt_t5=jnp.asarray(t5))
    with torch.no_grad():
        got = td(torch.from_numpy(z), torch.tensor(t), prompt_clip=torch.from_numpy(clip), prompt_t5=torch.from_numpy(t5))

    assert got.mean.dtype == torch.float32 and tuple(got.mean.shape) == z.shape
    assert _rel_err(got.mean, want.mean) <= TOL["float32"]


def test_ddim_trajectory_matches_jax():
    jd, td = _denoiser_pair(3)
    z, clip, t5 = _conditioning(9)

    want = JaxDDIM(jd, steps=4)(jnp.asarray(z), prompt_clip=jnp.asarray(clip), prompt_t5=jnp.asarray(t5), guidance=3.5)
    with torch.no_grad():
        got = TorchDDIM(td, steps=4)(
            torch.from_numpy(z), prompt_clip=torch.from_numpy(clip), prompt_t5=torch.from_numpy(t5), guidance=3.5
        )

    assert bool(torch.isfinite(got).all()) and tuple(got.shape) == z.shape
    assert _rel_err(got, want) <= 1e-4


def test_denoiser_rounds_the_backbone_inputs():
    # c_time, the ids, the guidance and the latent reach a bf16 backbone in bf16
    _, td = _denoiser_pair(4)
    td.backbone.to(torch.bfloat16)
    seen = {}
    td.backbone.register_forward_pre_hook(lambda m, args, kwargs: seen.update(kwargs), with_kwargs=True)

    z, clip, t5 = _conditioning(10)
    t = torch.tensor(0.37)
    with torch.no_grad():
        out = td(torch.from_numpy(z), t, prompt_clip=torch.from_numpy(clip), prompt_t5=torch.from_numpy(t5))

    assert out.mean.dtype == torch.float32
    for key in ("timestep", "hidden_states", "encoder_hidden_states", "pooled_projections", "img_ids", "txt_ids", "guidance"):
        assert seen[key].dtype == torch.bfloat16, key

    alpha, sigma = tnoise.DecaySchedule()(t)
    assert torch.equal(seen["timestep"], (sigma / (alpha + sigma)).to(torch.bfloat16).expand(2))
    assert seen["guidance"].tolist() == [4.0, 4.0]
    assert tuple(seen["encoder_hidden_states"].shape) == (2, 6, 32)
    assert seen["img_ids"][5].tolist() == [0.0, 1.0, 1.0]


# weights


def test_converter_round_trip():
    jmodel, tmodel, sd = _transformer_pair(True, seed=5)

    port_sd = tmodel.state_dict()
    assert "norm_out.linear.weight" in port_sd
    assert "transformer_blocks.0.ff.net.0.proj.weight" in port_sd
    assert "transformer_blocks.1.ff_context.net.2.bias" in port_sd
    assert "transformer_blocks.0.attn.to_out.0.weight" in port_sd
    assert "single_transformer_blocks.1.attn.norm_k.weight" in port_sd

    # back into JAX through the checkpoint converter, which asserts that
    # every key is used
    skeleton = filter_eval_shape(jbackbone.FluxTransformer, **SMALL, key=jax.random.key(0))
    back = convert_flux_state_dict(skeleton, port_sd)

    assert set(back) == set(sd)
    for key, value in sd.items():
        assert np.array_equal(np.asarray(back[key]), value), key

    reloaded = load_state_dict(skeleton, back)
    assert np.array_equal(np.asarray(reloaded.proj_out.weight), sd["proj_out.weight"])


def test_converter_is_strict():
    jmodel = jbackbone.FluxTransformer(**SMALL, key=jax.random.key(0))
    tmodel = tbackbone.FluxTransformer(**SMALL, device="cpu")
    sd = _random_state(jmodel, 6)

    converted = from_jax_state_dict(sd, tmodel)
    assert set(converted) == set(tmodel.state_dict())
    assert np.array_equal(converted["norm_out.linear.weight"].numpy(), sd["norm_out_linear.weight"].T)
    assert np.array_equal(converted["transformer_blocks.0.attn.norm_q.weight"].numpy(), sd["transformer_blocks.0.attn.norm_q.scale"])

    missing = dict(sd)
    del missing["transformer_blocks.1.ff.out.bias"]
    with pytest.raises(KeyError):
        from_jax_state_dict(missing, tmodel)

    extra = dict(sd, **{"transformer_blocks.0.extra.weight": np.zeros((3, 3), np.float32)})
    with pytest.raises(KeyError):
        from_jax_state_dict(extra, tmodel)

    wrong = dict(sd, **{"proj_out.bias": np.zeros(7, np.float32)})
    with pytest.raises(ValueError):
        from_jax_state_dict(wrong, tmodel)


def test_cards_and_full_size():
    assert load_cards(tflux)["flux_1_dev"].repo == "black-forest-labs/FLUX.1-dev"

    # the FLUX.1-dev defaults, without allocating them
    model = tbackbone.FluxTransformer(device="meta", dtype=torch.bfloat16)
    assert sum(p.numel() for p in model.parameters()) == 11_901_408_320
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_transformer_defaults_to_the_card():
    if torch.cuda.is_available():
        model = tbackbone.FluxTransformer(**SMALL)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tbackbone.FluxTransformer(**SMALL)


# the max-free attention


def _qkv(shape, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    return _normal(rng, shape, q_scale), _normal(rng, shape), _normal(rng, shape)


MAX_FREE_CASES = {
    # row 5's route (L > 2048, K/V blocks of 1024, the last one ragged)
    "blocked": (jattention._pallas_attention_blocked, (1, 2, 2304, 128), 1.0),
    # row 3's route (512 < L <= 2048; a ragged 512-row query block)
    "full_kv": (jattention._pallas_attention, (1, 2, 640, 128), 1.0),
    "full_kv_d64": (jattention._pallas_attention, (2, 1, 1024, 64), 1.0),
    # q scaled so that the logits' std is 30 and each row has a few above
    # 80: the clamp changes the result
    "blocked_clamp": (jattention._pallas_attention_blocked, (1, 2, 2304, 128), 30.0),
    "full_kv_clamp": (jattention._pallas_attention, (1, 2, 640, 128), 30.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MAX_FREE_CASES))
def test_max_free_plain_matches_jax_kernel(case, dtype):
    kernel, shape, q_scale = MAX_FREE_CASES[case]
    jd, td = DTYPES[dtype]
    q, k, v = _qkv(shape, seed=11, q_scale=q_scale)
    scale = 1 / math.sqrt(shape[-1])

    with pltpu.force_tpu_interpret_mode():
        want, lse = kernel(*(jnp.asarray(a).astype(jd) for a in (q, k, v)), scale, with_lse=False, max_free=True)
    assert lse is None

    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = tattention._attention_max_free_plain(tq, tk, tv, scale)

    assert got.dtype == td and tuple(got.shape) == shape
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= TOL[dtype] / 2

    exact = tattention._attention_plain(tq, tk, tv, scale=scale)
    if q_scale > 1:
        assert _rel_err(got, exact) > 0.1  # the clamp is reached
    else:
        assert _rel_err(got, exact) <= TOL[dtype] / 2  # the same softmax below it


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_free_on_the_cpu_is_the_exact_softmax(dtype):
    jd, td = DTYPES[dtype]
    q, k, v = _qkv((1, 2, 640, 64), seed=12, q_scale=30.0)

    want = jattention.dot_product_attention(*(jnp.asarray(a).astype(jd) for a in (q, k, v)), max_free=True)

    before = dict(_build.LAUNCHES)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = tattention.dot_product_attention(tq, tk, tv, max_free=True)

    assert dict(_build.LAUNCHES) == before
    assert torch.equal(got, tattention.dot_product_attention(tq, tk, tv))
    assert _rel_err(got, want) <= TOL[dtype] / 2


@pytest.mark.parametrize(
    "shape, route",
    [
        ((1, 24, 4608, 128), True),  # FLUX.1 at 1024 px: row 5
        ((1, 24, 1536, 128), True),  # FLUX.1 at 512 px: row 3
        ((2, 2, 640, 64), True),
        ((1, 24, 512, 128), False),  # the batched kernel ignores max_free
        ((1, 2, 600, 128), False),  # L % 128 != 0: JAX's XLA path
        ((1, 2, 1024, 32), False),  # D % 64 != 0: JAX's XLA path
        ((2, 640, 64), False),  # not (B, H, L, D)
    ],
)
def test_max_free_route_follows_the_jax_dispatch(shape, route):
    assert tattention._max_free_route(torch.empty(shape, device="meta")) is route


def test_max_free_kernel_needs_the_card():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 640, 64), seed=13))
    before = dict(_build.LAUNCHES)

    with pytest.raises(ValueError, match="CUDA"):
        tattention._attention_max_free_kernel(q, k, v, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        tattention.dot_product_attention(q, k, v, implementation="kernel", max_free=True)

    assert dict(_build.LAUNCHES) == before
