r"""The PyTorch port's v-diffusion family (`azula_tpu_torch.models.vdm`)
against the JAX package's, on the CPU: small `VDMUNet`s with each time
input, each upsampling mode, the attention pre-norm on and off and heads of
32; each block; `VelocityDenoiser` (a float32 time of shape () and (B,), a
bf16 backbone, whose time is rounded to bf16 first) and a DDIM-4 trajectory;
CC12M-1's blocks at small widths and the whole `CC12M1Model` at 64 x 64
(its widths are fixed: seven levels down to 1 x 1), with a zero CLIP
embedding beside a random one; the weights both ways (JAX -> port by
`from_jax_state_dict`, port -> JAX by `convert_state_dict`, exact); the
six cards' full-size networks (meta device) against the port's manifests
and JAX's parameter counts.

Inputs and weights come from seeded numpy generators (the whole CC12M-1's
from a generator-built port model, carried into JAX's abstract model by
`convert_state_dict`). Tolerances are relative to max |JAX|: float32 1e-5,
2e-5 where a softmax sums 64 keys or more, 1e-4 over a trajectory.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process
import yaml

from azula_tpu.models import vdm as jvdm
from azula_tpu.models.vdm import backbone as jbackbone
from azula_tpu.models.vdm import cc12m as jcc12m
from azula_tpu.models.vdm.convert import convert_state_dict, manifest_state_dict
from azula_tpu.sample import DDIMSampler as JaxDDIM
from azula_tpu.utils.pytree import filter_eval_shape, filter_jit
from azula_tpu_torch.models import vdm as tvdm
from azula_tpu_torch.models.utils import check_manifest, load_cards
from azula_tpu_torch.models.vdm import backbone as tbackbone
from azula_tpu_torch.models.vdm import cc12m as tcc12m
from azula_tpu_torch.models.vdm.convert import from_jax_state_dict
from azula_tpu_torch.ops import norm
from azula_tpu_torch.sample import DDIMSampler as TorchDDIM

from test_torch_vae import _rel_err, call, load_jax, random_state, skeleton

TOL = 1e-5
TOL_SOFTMAX = 2e-5
TOL_TRAJECTORY = 1e-4

# three levels (16 x 16, 8 x 8, 4 x 4 on 16 x 16 images), attention at the
# two inner ones in heads of 32 (L = 64 and 16)
SMALL = dict(cs=(32, 32, 64), blocks=1, inner=2, attn=(1, 2), head_dim=32, final_act=False, std=0.2)  # noqa: C408
SPECS = {
    "log_snr-nearest": tbackbone.VDMSpec(**SMALL, t_input="log_snr", up="nearest"),
    "t-bilinear-norm": tbackbone.VDMSpec(**SMALL, t_input="t", up="bilinear", attn_norm=True),
    "log_snr-bilinear-norm-final_act": tbackbone.VDMSpec(
        **{**SMALL, "final_act": True, "blocks": 2}, t_input="log_snr", up="bilinear", attn_norm=True
    ),
    "t-nearest": tbackbone.VDMSpec(**{**SMALL, "attn": (2,)}, t_input="t", up="nearest"),
}

CARDS = {
    "danbooru_128x128": ("danbooru_128", 128),
    "imagenet_128x128": ("imagenet_128", 128),
    "wikiart_128x128": ("wikiart_128", 128),
    "wikiart_256x256": ("wikiart_256", 256),
    "yfcc_512x512": ("yfcc_1", 512),
    "yfcc_512x512_large": ("yfcc_2", 512),
}


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_spec(spec):
    return jbackbone.VDMSpec(**vars(spec))


def _pair(build, seed: int):
    r"""A JAX module and the port's with the same random weights; `build(m,
    **factory)` builds either from its module `m` (the backbone or cc12m)."""

    jmodule = skeleton(lambda key: build(None, key=key))
    sd = random_state(jmodule, seed)
    jmodule = load_jax(jmodule, sd)
    tmodule = build("torch", device="cpu")
    # converted under a parent's name, as a bare layer's leaves have none
    state = from_jax_state_dict({f"m.{k}": v for k, v in sd.items()})
    tmodule.load_state_dict({k.removeprefix("m."): v for k, v in state.items()})

    return jmodule, tmodule, sd


def _unet(spec):
    def build(which, **factory):
        if which == "torch":
            return tbackbone.VDMUNet(spec, **factory)
        return jbackbone.VDMUNet(_jax_spec(spec), **factory)

    return build


TIMES = {"scalar": np.float32(0.4), "batch": np.asarray([0.15, 0.8], dtype=np.float32)}


@pytest.mark.parametrize("name", list(SPECS))
def test_unet_matches_jax(name):
    jmodule, tmodule, _ = _pair(_unet(SPECS[name]), seed=1)
    x, t = _normal(2, (2, 16, 16, 3)), np.asarray([0.3, 0.7], dtype=np.float32)

    want = call(jmodule, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tmodule(torch.from_numpy(x), torch.from_numpy(t))

    assert tuple(got.shape) == (2, 16, 16, 3) and got.dtype == torch.float32
    assert _rel_err(got, want) <= TOL_SOFTMAX


def _block_builders(which):
    m = tbackbone if which == "torch" else jbackbone
    return {
        "resconv": lambda **kw: m.VDMResConvBlock(16, 24, 32, **kw),
        "resconv_last": lambda **kw: m.VDMResConvBlock(16, 16, 16, is_last=True, **kw),
        "attention": lambda **kw: m.VDMSelfAttention2d(64, 2, **kw),
        "attention_norm": lambda **kw: m.VDMSelfAttention2d(64, 1, pre_norm=True, **kw),
        "fourier": lambda **kw: m.FourierFeatures(1, 16, std=0.2, **kw),
    }


@pytest.mark.parametrize("kind", ["resconv", "resconv_last", "attention", "attention_norm"])
def test_blocks_match_jax(kind):
    def build(which, **factory):
        return _block_builders(which)[kind](**factory)

    jblock, tblock, _ = _pair(build, seed=3)
    x = _normal(4, (2, 8, 8, 16 if kind.startswith("resconv") else 64))

    # the JAX blocks take the upsampling mode, which only the skip block uses
    want = call(lambda b, x: b(x, "nearest"), jblock, jnp.asarray(x))
    with torch.no_grad():
        got = tblock(torch.from_numpy(x))

    assert tuple(got.shape) == tuple(want.shape)
    assert _rel_err(got, want) <= TOL_SOFTMAX


def test_fourier_features_keep_the_checkpoint_layout():
    # (C_o / 2, C_i) on both sides, under the checkpoints' names
    jfeat = load_jax(skeleton(lambda key: _block_builders(None)["fourier"](key=key)), sd := {"weight": _normal(5, (8, 1))})
    tfeat = _block_builders("torch")["fourier"](device="cpu")
    state = from_jax_state_dict({f"timestep_embed.{k}": v for k, v in sd.items()})
    tfeat.load_state_dict({k.removeprefix("timestep_embed."): v for k, v in state.items()})
    t = np.asarray([[0.0], [0.3], [-2.5], [7.0]], dtype=np.float32)

    want = call(jfeat, jnp.asarray(t))
    got = tfeat(torch.from_numpy(t))

    assert tuple(tfeat.weight.shape) == (8, 1) and np.array_equal(tfeat.weight.detach().numpy(), sd["weight"])
    assert tuple(got.shape) == (4, 16) and _rel_err(got, want) <= TOL


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_upsampling_matches_jax(mode):
    # jax.image.resize's bilinear upsampling, edge rows and columns included
    x = _normal(6, (2, 5, 7, 3))
    want = jbackbone._apply("up", jnp.asarray(x), mode)
    got = tbackbone.VDMStage("up", mode)(torch.from_numpy(x))

    assert tuple(got.shape) == (2, 10, 14, 3)
    assert _rel_err(got, want) <= TOL
    down = tbackbone.VDMStage("down")(torch.from_numpy(_normal(7, (2, 6, 8, 3))))
    assert _rel_err(down, jbackbone._apply("down", jnp.asarray(_normal(7, (2, 6, 8, 3))), mode)) <= TOL


# the denoiser


def _denoisers(seed: int, name: str = "t-bilinear-norm"):
    jmodule, tmodule, _ = _pair(_unet(SPECS[name]), seed)
    return jvdm.VelocityDenoiser(jmodule), tvdm.VelocityDenoiser(tmodule)


def _denoise(jden, tden, x, t):
    want = call(lambda d, x, t: d(x, t).mean, jden, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tden(torch.from_numpy(x), torch.as_tensor(t)).mean
    return got, want


@pytest.mark.parametrize("name", ["log_snr-nearest", "t-bilinear-norm"])
@pytest.mark.parametrize("time", list(TIMES))
def test_denoiser_matches_jax(time, name):
    jden, tden = _denoisers(8, name)
    got, want = _denoise(jden, tden, _normal(9, (2, 16, 16, 3)), TIMES[time])

    assert got.dtype == torch.float32
    assert _rel_err(got, want) <= TOL_SOFTMAX


# A bf16 backbone on both sides: c_time is rounded to bf16 before the
# backbone takes it to float32 (its log-SNR included), the network runs in
# bf16, its output is cast back to float32. Both networks round after every
# operation, each in its own order, so the bf16 means are held to JAX's
# float32 mean, as in `tests/test_torch_sd.py`. At t = 0.15 the rounded
# time moves the log-SNR features: JAX's bf16 mean lies 8.5e-2 from its
# float32 one, the port's 8.3e-2, and 7.6e-3 from JAX's bf16 mean.
BF16_SLACK = 1.5


@pytest.mark.parametrize("time", list(TIMES))
def test_denoiser_with_a_bf16_backbone(time):
    jden, tden = _denoisers(10, "log_snr-nearest")
    jden16 = jvdm.VelocityDenoiser(jden.backbone.astype(jnp.bfloat16))
    tden.backbone.to(torch.bfloat16)
    x = _normal(11, (2, 16, 16, 3))

    got, want16 = _denoise(jden16, tden, x, TIMES[time])
    _, want32 = _denoise(jden, tden, x, TIMES[time])

    assert want16.dtype == jnp.float32 and got.dtype == torch.float32
    jax_err = _rel_err(want16, want32)
    assert 1e-3 < jax_err < 0.2
    assert _rel_err(got, want32) <= BF16_SLACK * jax_err
    assert _rel_err(got, want16) <= 2 * jax_err


def test_denoiser_rounds_the_time_to_the_backbone():
    _, tden = _denoisers(12)
    tden.backbone.to(torch.bfloat16)
    seen = {}

    def spy(x, t):
        seen.update(x=x.dtype, t=t)
        return x

    tden.backbone.forward = spy
    t = torch.tensor([0.3, 0.6])
    out = tden(torch.zeros(2, 16, 16, 3), t).mean

    alpha, sigma = tden.schedule(t)
    c_time = torch.atan2(sigma, alpha) / math.pi * 2
    assert out.dtype == torch.float32 and seen["x"] == torch.bfloat16
    assert seen["t"].dtype == torch.bfloat16 and torch.equal(seen["t"], c_time.to(torch.bfloat16))
    assert not torch.equal(seen["t"].float(), c_time)  # the rounding bites at these times


def test_ddim_trajectory_matches_jax():
    jden, tden = _denoisers(13)
    x1 = _normal(14, (2, 16, 16, 3))

    want = call(lambda d, x: JaxDDIM(d, eta=0.0, steps=4)(x), jden, jnp.asarray(x1))
    with torch.no_grad():
        got = TorchDDIM(tden, eta=0.0, steps=4)(torch.from_numpy(x1))

    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= TOL_TRAJECTORY


# CC12M-1


CC_BLOCKS = {
    "linear": lambda m, b, **kw: m.CC12MResLinearBlock(24, 32, 40, **kw),
    "linear_last": lambda m, b, **kw: m.CC12MResLinearBlock(24, 32, 24, is_last=True, **kw),
    "modconv": lambda m, b, **kw: m.CC12MModConvBlock(24, 16, 32, 32, **kw),
    "modconv_last": lambda m, b, **kw: m.CC12MModConvBlock(24, 16, 16, 3, is_last=True, **kw),
    "skip": lambda m, b, **kw: m.CC12MSkipBlock([
        "down" if m is jcc12m else b.VDMStage("down"),
        m.CC12MModConvBlock(24, 16, 32, 16, **kw),
        b.VDMSelfAttention2d(16, 1, pre_norm=True, **kw),
        "up" if m is jcc12m else b.VDMStage("up", "bilinear"),
    ]),
}


@pytest.mark.parametrize("kind", list(CC_BLOCKS))
def test_cc12m_blocks_match_jax(kind):
    def build(which, **factory):
        if which == "torch":
            return CC_BLOCKS[kind](tcc12m, tbackbone, **factory)
        return CC_BLOCKS[kind](jcc12m, jbackbone, **factory)

    jblock, tblock, _ = _pair(build, seed=15)
    cond = _normal(16, (2, 24))
    if kind.startswith("linear"):
        want = call(jblock, jnp.asarray(cond))
        with torch.no_grad():
            got = tblock(torch.from_numpy(cond))
    else:
        x = _normal(17, (2, 8, 8, 16)) * 3 + 1
        want = call(jblock, jnp.asarray(x), jnp.asarray(cond))
        with torch.no_grad():
            got = tblock(torch.from_numpy(x), torch.from_numpy(cond))

    assert tuple(got.shape) == tuple(want.shape)
    assert _rel_err(got, want) <= TOL_SOFTMAX


def test_cc12m_modulation_matches_jax():
    jmod, tmod, _ = _pair(lambda which, **kw: (tcc12m if which == "torch" else jcc12m).CC12MModulation(24, 16, **kw), 18)
    x, cond = _normal(19, (2, 4, 4, 16)), _normal(20, (2, 24))

    want = call(jmod, jnp.asarray(x), jnp.asarray(cond))
    got = tmod(torch.from_numpy(x), torch.from_numpy(cond))

    assert _rel_err(got, want) <= TOL


def test_cc12m_group_norms_are_single_group_without_affine(monkeypatch):
    # every convolution block normalizes with group_norm(h, 1), then applies
    # the FiLM apart; the attention pre-norm is a single affine group
    calls = []
    plain = norm._gn_forward

    def spy(x, P, Q, groups, eps, silu, implementation):
        calls.append((x.shape[-1], groups, silu, bool((P == 1).all() and (Q == 0).all())))
        return plain(x, P, Q, groups, eps, silu, implementation)

    monkeypatch.setattr(norm, "_gn_forward", spy)
    block = tcc12m.CC12MModConvBlock(24, 16, 32, 32, device="cpu")
    with torch.no_grad():
        block(torch.randn(1, 4, 4, 16), torch.randn(1, 24))
        tbackbone.VDMSelfAttention2d(32, 1, pre_norm=True, device="cpu")(torch.randn(1, 4, 4, 32))

    assert calls == [(32, 1, False, True), (32, 1, False, True), (32, 1, False, True)]


@pytest.fixture(scope="module")
def cc12m_outputs():
    r"""The whole CC12M-1 at 64 x 64 on one set of random weights, drawn by
    the port, which runs first; then carried into JAX's abstract model one
    tensor at a time through `convert_state_dict`, each port tensor freed as
    it goes (no JAX initialization of 603M parameters is paid, and one
    model's 2.4 GB is the peak): JAX's outputs for a random and a zero CLIP
    embedding, then, with JAX's norm taken at least 1e-12 as the port takes
    it, for the zero one."""

    x, t = _normal(22, (2, 64, 64, 3)), np.asarray([0.35, 0.8], dtype=np.float32)
    clip = _normal(23, (2, 512))
    clip[1] = 0.0  # the unconditional branch of cc12m_1_cfg

    tmodel = tcc12m.CC12M1Model(device="cpu", generator=torch.Generator().manual_seed(21))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(clip))
    port = tmodel.state_dict()
    del tmodel

    sd = {}
    for key in list(port):
        value = port.pop(key)
        sd.update({k: jnp.asarray(v) for k, v in convert_state_dict({key: value.numpy()}).items()})
        del value
    jmodel = load_jax(filter_eval_shape(jcc12m.CC12M1Model, key=jax.random.key(0)), sd)
    del sd

    want = np.asarray(call(jmodel, jnp.asarray(x), jnp.asarray(t), jnp.asarray(clip)))
    norm_ = jnp.linalg.norm
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jnp.linalg, "norm", lambda a, **kw: jnp.maximum(norm_(a, **kw), 1e-12))
        fresh = filter_jit(lambda f, *args: f(*args))  # traced anew, under the patch
        clamped = np.asarray(fresh(jmodel, jnp.asarray(x[1:]), jnp.asarray(t[1:]), jnp.asarray(clip[1:])))

    return got, want, clamped


def test_cc12m_model_matches_jax(cc12m_outputs):
    got, want, _ = cc12m_outputs

    assert tuple(got.shape) == (2, 64, 64, 3) and got.dtype == torch.float32
    assert _rel_err(got[:1], want[:1]) <= TOL_SOFTMAX


def test_cc12m_zero_embedding(cc12m_outputs):
    got, want, clamped = cc12m_outputs

    # JAX divides the zero embedding by its zero norm: NaN throughout that
    # row; the port divides by max(norm, 1e-12): finite, and equal to JAX's
    # where JAX's norm is taken so as well
    assert np.isnan(want[1]).all() and bool(torch.isfinite(got).all())
    assert _rel_err(got[1:], clamped) <= TOL_SOFTMAX


def test_cc12m_embedding_normalized_as_jax():
    # a non-zero embedding is divided by its norm, then scaled by sqrt(512),
    # as the JAX package computes it
    e = _normal(24, (3, 512)) * np.asarray([[1.0], [1e-3], [40.0]], dtype=np.float32)
    want = np.asarray(e / jnp.linalg.norm(jnp.asarray(e), axis=-1, keepdims=True) * 512**0.5)
    et = torch.from_numpy(e)
    got = et / torch.linalg.vector_norm(et, dim=-1, keepdim=True).clamp_min(1e-12) * 512**0.5

    assert np.abs(got.numpy() - want).max() <= 4 * np.finfo(np.float32).eps * np.abs(want).max()


# the weights both ways


def test_converter_round_trip():
    jmodule, tmodule, sd = _pair(_unet(SPECS["t-bilinear-norm"]), seed=25)
    back = convert_state_dict(tmodule.state_dict())

    assert set(back) == set(sd)
    for key, value in sd.items():
        assert np.array_equal(np.asarray(back[key]), value), key


def test_cc12m_converter_round_trip():
    # the mapping, both Fourier features and a block of each kind (the
    # FiLM's bias-free linears, the attention's affine pre-norm) of the
    # full-size model
    model = tcc12m.CC12M1Model(device="meta")
    attention = next(k for k in model.state_dict() if k.endswith(".norm.weight")).removesuffix("norm.weight")
    names = ("mapping.", "mapping_timestep_embed.", "timestep_embed.", "net.0.", "net.4.main.1.", attention)
    rng = np.random.default_rng(26)
    port = {
        k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in model.state_dict().items() if k.startswith(names)
    }
    jax_sd = convert_state_dict(port)
    back = from_jax_state_dict(jax_sd)

    assert any(k.endswith(".norm.scale") for k in jax_sd) and "net.0.main.2.layer.weight" in jax_sd
    assert set(back) == set(port)
    for key, value in port.items():
        assert torch.equal(back[key], value), key


# full size and cards


def _jax_parameters(module) -> int:
    return sum(math.prod(leaf.shape) for leaf in jax.tree.leaves(module) if hasattr(leaf, "shape"))


@pytest.mark.parametrize("card", list(CARDS))
def test_full_size_cards_match_manifests_and_jax(card):
    spec, _ = CARDS[card]
    denoiser = tvdm.make_model(spec, device="meta")

    check_manifest(denoiser.backbone.state_dict(), "vdm", card, "model")
    n = sum(p.numel() for p in denoiser.parameters())
    assert n == _jax_parameters(filter_eval_shape(jvdm.make_model, spec).backbone)


def test_full_size_cc12m_matches_jax():
    tmodel = tvdm.make_model("cc12m_1", device="meta").backbone
    jmodel = filter_eval_shape(jcc12m.CC12M1Model, key=jax.random.key(0))

    # the checkpoint's keys and shapes, as JAX's converter inverts them
    assert {k: tuple(v.shape) for k, v in tmodel.state_dict().items()} == manifest_state_dict(jmodel)
    n = sum(p.numel() for p in tmodel.parameters())
    assert n == _jax_parameters(jmodel) and 602e6 < n < 604e6  # CC12M-1: 603M parameters


def test_specs_and_cards_equal_jax():
    assert {k: vars(v) for k, v in tvdm.SPECS.items()} == {k: vars(v) for k, v in jbackbone.SPECS.items()}

    cards = load_cards(tvdm)
    with open(jvdm.__file__.replace("__init__.py", "cards.yaml")) as f:
        jax_cards = yaml.safe_load(f)
    assert set(cards) == set(jax_cards) == set(CARDS)
    for name, card in cards.items():
        assert card.config == jax_cards[name]["config"] == {"model": CARDS[name][0]}


def test_state_dict_keys_keep_the_sequential_indices():
    # parameter-free stages hold their index: the keys of yfcc_2's first
    # levels are the checkpoint's
    model = tvdm.make_model("yfcc_2", device="meta").backbone
    keys = set(model.state_dict())

    assert {"timestep_embed.weight", "net.0.main.0.weight", "net.0.main.2.bias", "net.0.skip.weight"} <= keys
    assert "net.2.main.1.main.0.weight" in keys and not any(".main.1.weight" in k for k in keys)
    assert all(isinstance(m, tbackbone.VDMStage) for m in (model.net[0].main[1], model.net[2].main[0]))
    assert len(keys) == 218


def test_exports_cover_jax():
    # the JAX package's public names, but `load_model`, which waits for
    # checkpoint files in the repository
    assert set(jvdm.__all__) - {"load_model"} <= set(tvdm.__all__)
    assert set(jbackbone.__all__) <= set(tbackbone.__all__)
    assert set(jcc12m.__all__) <= set(tcc12m.__all__)
