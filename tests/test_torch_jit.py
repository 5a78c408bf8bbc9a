r"""The PyTorch port's JiT family (`azula_tpu_torch.models.jit`) against the
JAX package's, on the CPU: the small JiT of `tests/test_models_jit.py`
(`SMALL`: 64 x 64 images, patch 16, 4 heads of 16) with and without
in-context tokens, with them from block 0 and from block 1, and with heads of
32; the RoPE tables and the position embedding bit for bit; each layer;
`JITDenoiser` with and without labels and with a bf16 backbone; a Heun-4
trajectory under batched CFG; the weights both ways (JAX -> port by
`from_jax_state_dict`, port -> JAX by `convert_state_dict`, with the `net.`
prefix that `load_model` strips); the six cards' full-size networks (meta
device) against the port's manifests and JAX's parameter counts.

Inputs and weights come from seeded numpy generators; the RoPE tables are
the host's, as each package computes them. Tolerances are relative to
max |JAX|: float32 1e-5, 1e-4 over a trajectory.
"""

import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process
import yaml

from azula_tpu.guidance import CFGDenoiser as JaxCFG
from azula_tpu.models import jit as jjit
from azula_tpu.models.jit import backbone as jbackbone
from azula_tpu.models.jit.convert import convert_state_dict
from azula_tpu.sample import HeunSampler as JaxHeun
from azula_tpu.utils.pytree import filter_eval_shape, state_dict
from azula_tpu_torch.guidance import CFGDenoiser
from azula_tpu_torch.models import jit as tjit
from azula_tpu_torch.models.jit import backbone as tbackbone
from azula_tpu_torch.models.jit.convert import from_jax_state_dict
from azula_tpu_torch.models.utils import check_manifest, load_cards
from azula_tpu_torch.ops import attention
from azula_tpu_torch.sample import HeunSampler as TorchHeun

from test_torch_vae import _rel_err, call, load_jax, random_state, skeleton

TOL = 1e-5
TOL_TRAJECTORY = 1e-4

SMALL = dict(  # noqa: C408
    input_size=64,
    patch_size=16,
    hidden_size=64,
    depth=3,
    num_heads=4,
    num_classes=10,
    bottleneck_dim=16,
    in_context_len=4,
    in_context_start=1,
)
CONFIGS = {
    "in_context_from_1": SMALL,
    "in_context_from_0": {**SMALL, "in_context_start": 0},
    "no_in_context": {**SMALL, "in_context_len": 0, "in_context_start": 0},
    "heads_of_32": {**SMALL, "num_heads": 2},
}
CARDS = {
    "jit_0.1b_16": "JiT-B/16",
    "jit_0.1b_32": "JiT-B/32",
    "jit_0.5b_16": "JiT-L/16",
    "jit_0.5b_32": "JiT-L/32",
    "jit_1.0b_16": "JiT-H/16",
    "jit_1.0b_32": "JiT-H/32",
}


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _state(jmodel, seed: int) -> dict[str, np.ndarray]:
    r"""`random_state` with the RoPE tables and the position embedding as
    JAX computes them (the skeleton's are abstract): every other leaf
    random, the zero-initialized AdaLN and final layers included."""

    sd = random_state(jmodel, seed, tables=0.5)
    head_dim, grid = jmodel.rope[0].shape[1], int(round(jmodel.rope[0].shape[0] ** 0.5))
    cls = jmodel.rope_incontext[0].shape[0] - grid**2
    sd["rope.0"], sd["rope.1"] = jbackbone._axial_rope_tables(head_dim, grid, 0)
    sd["rope_incontext.0"], sd["rope_incontext.1"] = jbackbone._axial_rope_tables(head_dim, grid, cls)
    sd["pos_embed"] = jbackbone._sincos_pos_embed(sd["pos_embed"].shape[-1], grid)
    return sd


def _pair(config: dict, seed: int):
    jmodel = skeleton(jbackbone.JiT, **config)
    sd = _state(jmodel, seed)
    jmodel = load_jax(jmodel, sd)
    tmodel = tbackbone.JiT(**config, device="cpu")
    tmodel.load_state_dict(from_jax_state_dict(sd, tmodel))
    return jmodel, tmodel, sd


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jit_matches_jax(name):
    jmodel, tmodel, _ = _pair(CONFIGS[name], seed=1)
    x, t, y = _normal(2, (2, 64, 64, 3)), np.asarray([0.2, 0.9], dtype=np.float32), np.asarray([1, 10])

    want = call(jmodel, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))

    assert tuple(got.shape) == (2, 64, 64, 3) and got.dtype == torch.float32
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("head_dim, grid, cls", [(16, 4, 0), (16, 4, 4), (64, 16, 32), (80, 16, 32), (64, 8, 32)])
def test_rope_tables_equal_jax(head_dim, grid, cls):
    cos, sin = tbackbone._axial_rope_tables(head_dim, grid, cls)
    want_cos, want_sin = jbackbone._axial_rope_tables(head_dim, grid, cls)

    assert cos.dtype == sin.dtype == np.float32 and cos.shape == (cls + grid**2, head_dim)
    assert np.array_equal(cos, want_cos) and np.array_equal(sin, want_sin)
    assert (cos[:cls] == 1).all() and (sin[:cls] == 0).all()


@pytest.mark.parametrize("dim, grid", [(64, 4), (1024, 16), (1280, 8)])
def test_position_embedding_equals_jax(dim, grid):
    got = tbackbone._sincos_pos_embed(dim, grid)

    assert got.dtype == np.float32 and got.shape == (grid**2, dim)
    assert np.array_equal(got, jbackbone._sincos_pos_embed(dim, grid))


def test_model_buffers_are_the_tables():
    model = tbackbone.JiT(**SMALL, device="cpu")

    cos, sin = jbackbone._axial_rope_tables(16, 4, 4)
    assert torch.equal(model.rope_incontext_cos, torch.from_numpy(cos))
    assert torch.equal(model.rope_incontext_sin, torch.from_numpy(sin))
    assert torch.equal(model.pos_embed[0], torch.from_numpy(jbackbone._sincos_pos_embed(64, 4)))
    assert not any(k.startswith("rope") for k in model.state_dict())  # never carried


def test_rotate_half_pairs_interleaved():
    x = np.arange(12, dtype=np.float32).reshape(2, 6)

    got = tbackbone._rotate_half(torch.from_numpy(x))

    assert np.array_equal(got.numpy(), np.asarray(jbackbone._rotate_half(jnp.asarray(x))))
    assert got[0].tolist() == [-1.0, 0.0, -3.0, 2.0, -5.0, 4.0]


@pytest.mark.parametrize("t", [[0.0, 0.37], [1.0, 0.999]])
def test_timestep_embedding_matches_jax(t):
    got = tbackbone._timestep_embedding(torch.tensor(t), 256)
    want = jbackbone._timestep_embedding(jnp.asarray(t), 256)

    assert tuple(got.shape) == (2, 256)
    assert _rel_err(got, want) <= TOL


LAYERS = {
    "rms_norm": (lambda m, **kw: m.JiTRMSNorm(32, **({} if m is jbackbone else kw)), (2, 5, 32)),
    "swiglu": (lambda m, **kw: m.JiTSwiGLU(32, 128, **kw), (2, 5, 32)),
}


@pytest.mark.parametrize("kind", list(LAYERS))
def test_layers_match_jax(kind):
    build, shape = LAYERS[kind]
    jlayer = skeleton(lambda key: build(jbackbone, key=key)) if kind != "rms_norm" else build(jbackbone)
    sd = random_state(jlayer, 3)
    jlayer = load_jax(jlayer, sd)
    tlayer = build(tbackbone, device="cpu")
    state = from_jax_state_dict({f"blocks.0.{k}": v for k, v in sd.items()})
    tlayer.load_state_dict({k.removeprefix("blocks.0."): v for k, v in state.items()})
    x = _normal(4, shape) * 3

    want = call(jlayer, jnp.asarray(x))
    with torch.no_grad():
        got = tlayer(torch.from_numpy(x))

    assert _rel_err(got, want) <= TOL
    if kind == "swiglu":
        assert tuple(tlayer.w12.weight.shape) == (2 * int(128 * 2 / 3), 32)


def test_rms_norm_rounds_its_product_to_x():
    norm = tbackbone.JiTRMSNorm(8, device="cpu").to(torch.bfloat16)
    x = torch.randn(3, 8, dtype=torch.bfloat16)

    h = x.float() * torch.rsqrt(x.float().square().mean(-1, keepdim=True) + 1e-6)
    want = (norm.weight * h).to(torch.bfloat16)  # bf16 weight times float32 statistics, rounded once
    assert torch.equal(norm(x), want)


# the denoiser


def _denoisers(seed: int, name: str = "in_context_from_1"):
    jmodel, tmodel, _ = _pair(CONFIGS[name], seed)
    return jjit.JITDenoiser(jmodel, num_classes=10), tjit.JITDenoiser(tmodel, num_classes=10)


TIMES = {"scalar": np.float32(0.4), "batch": np.asarray([0.15, 0.8], dtype=np.float32)}


def _denoise(jden, tden, x, t, label):
    want = call(
        lambda d, x, t, y: d(x, t, label=y).mean, jden, jnp.asarray(x), jnp.asarray(t),
        None if label is None else jnp.asarray(label),
    )
    with torch.no_grad():
        got = tden(torch.from_numpy(x), torch.as_tensor(t), label=None if label is None else torch.from_numpy(label)).mean
    return got, want


@pytest.mark.parametrize("labelled", [True, False], ids=["label", "no_label"])
@pytest.mark.parametrize("time", list(TIMES))
def test_denoiser_matches_jax(time, labelled):
    jden, tden = _denoisers(5)
    label = np.asarray([3, 7]) if labelled else None

    got, want = _denoise(jden, tden, _normal(6, (2, 64, 64, 3)), TIMES[time], label)

    assert got.dtype == torch.float32
    assert _rel_err(got, want) <= TOL


def test_denoiser_feeds_the_null_label_and_rounds_the_time():
    _, tden = _denoisers(7)
    tden.backbone.to(torch.bfloat16)
    seen = {}

    def spy(x, t, y):
        seen.update(x=x.dtype, t=t, y=y)
        return x

    tden.backbone.forward = spy
    t = torch.tensor([0.3, 0.6])
    out = tden(torch.zeros(2, 64, 64, 3), t).mean

    alpha, sigma = tden.schedule(t)
    assert out.dtype == torch.float32 and seen["x"] == torch.bfloat16
    assert seen["t"].dtype == torch.bfloat16 and torch.equal(seen["t"], (alpha / (alpha + sigma)).to(torch.bfloat16))
    assert seen["y"].tolist() == [10, 10]  # the null label, num_classes
    tden(torch.zeros(2, 64, 64, 3), t, label=torch.tensor(4))
    assert seen["y"].tolist() == [4, 4]


# A bf16 backbone on both sides, held to JAX's float32 mean as in
# `tests/test_torch_sd.py`: no farther from it than `BF16_SLACK` times
# JAX's own bf16 mean, no farther from that than twice.
BF16_SLACK = 1.5


@pytest.mark.parametrize("time", list(TIMES))
def test_denoiser_with_a_bf16_backbone(time):
    jden, tden = _denoisers(8)
    jden16 = jjit.JITDenoiser(jden.backbone.astype(jnp.bfloat16), num_classes=10)
    tden.backbone.to(torch.bfloat16)
    x, label = _normal(9, (2, 64, 64, 3)), np.asarray([2, 5])

    got, want16 = _denoise(jden16, tden, x, TIMES[time], label)
    _, want32 = _denoise(jden, tden, x, TIMES[time], label)

    assert want16.dtype == jnp.float32 and got.dtype == torch.float32
    jax_err = _rel_err(want16, want32)
    assert 1e-3 < jax_err < 0.2
    assert _rel_err(got, want32) <= BF16_SLACK * jax_err
    assert _rel_err(got, want16) <= 2 * jax_err


GUIDANCE = 2.0


def test_cfg_heun_trajectory_matches_jax():
    jden, tden = _denoisers(10)
    x1 = _normal(11, (2, 64, 64, 3))
    labels, null = np.asarray([1, 6]), np.asarray([10])

    def jax_run(d, x, y, n):
        sampler = JaxHeun(JaxCFG(d, batched=True), steps=4)
        return sampler(x, positive={"label": y}, negative={"label": n}, guidance=GUIDANCE)

    want = call(jax_run, jden, jnp.asarray(x1), jnp.asarray(labels), jnp.asarray(null))
    with torch.no_grad():
        got = TorchHeun(CFGDenoiser(tden, batched=True), steps=4)(
            torch.from_numpy(x1), positive={"label": torch.from_numpy(labels)},
            negative={"label": torch.from_numpy(null)}, guidance=GUIDANCE,
        )

    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= TOL_TRAJECTORY


def test_attention_routes_by_head_dim():
    # heads of 64 (JiT-B, JiT-L) take the kernel on the card, JiT-H's 80 the
    # plain route, as the JAX package takes XLA there
    q = torch.zeros(1, 2, 288, 64)
    assert attention._self_attention(q, q, q)
    q = torch.zeros(1, 2, 288, 80)
    assert not attention._self_attention(q, q, q)


# the weights both ways


def test_converter_round_trip():
    jmodel, tmodel, sd = _pair(SMALL, seed=12)
    # a checkpoint's keys carry the `net.` prefix that load_model strips
    checkpoint = {f"net.{k}": v for k, v in tmodel.state_dict().items()}
    back = convert_state_dict(jmodel, {k.removeprefix("net."): v for k, v in checkpoint.items()})

    assert set(back) == set(sd)
    for key, value in sd.items():
        assert np.array_equal(np.asarray(back[key]), value), key


# full size and cards


def _jax_parameters(module) -> int:
    return sum(math.prod(leaf.shape) for name, leaf in state_dict(module).items() if not name.startswith("rope"))


@pytest.mark.parametrize("card", list(CARDS))
def test_full_size_cards_match_manifests_and_jax(card):
    model = tjit.make_model(CARDS[card], device="meta")

    check_manifest(model.backbone.state_dict(), "jit", card, "model")
    jmodel = filter_eval_shape(jjit.make_model, CARDS[card])
    n = sum(p.numel() for p in model.parameters())
    assert n == _jax_parameters(jmodel.backbone)
    assert convert_state_dict(jmodel.backbone, None) == {k: tuple(v.shape) for k, v in model.backbone.state_dict().items()}


def test_configs_and_cards_equal_jax():
    assert tbackbone.JIT_CONFIGS == jbackbone.JIT_CONFIGS

    cards = load_cards(tjit)
    with open(jjit.__file__.replace("__init__.py", "cards.yaml")) as f:
        jax_cards = yaml.safe_load(f)
    assert set(cards) == set(jax_cards) == set(CARDS)
    for name, card in cards.items():
        assert card.config == jax_cards[name]["config"] == {"model": CARDS[name]}


def test_exports_cover_jax():
    # the JAX package's public names, but `load_model`, which waits for
    # checkpoint files in the repository
    assert set(jjit.__all__) - {"load_model"} <= set(tjit.__all__)
    assert set(jbackbone.__all__) <= set(tbackbone.__all__)
