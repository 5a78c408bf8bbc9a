r"""The PyTorch port's EDM family (`azula_tpu_torch.models.edm`) against the
JAX package's, on the CPU: `SongUNet` (DDPM++, NCSN++, the skip encoder and
decoder, class-conditional) and `DhariwalUNet` (with labels and without,
where the precond feeds zero one-hots) under every precond, each layer
(`EDMConv` in each resampling form, both noise embeddings, `EDMUNetBlock`
with attention), `ElucidatedDenoiser` (a float32 time of shape () and (B,),
and a bf16 backbone, whose noise level is rounded to bf16 first), a Heun-4
trajectory; the weights both ways (JAX -> port by `from_jax_state_dict`,
port -> JAX by `convert_edm_state_dict`, exact) and the NVlabs twin's state
dict as it is; the full-size `imagenet_64x64_cond` network (meta device)
against JAX's parameter count.

The small configurations are those of `tests/test_models_edm.py`
(`SONG_SMALL`, `DHARIWAL_SMALL`: 16 x 16 images, channels (16, 32), one
block a level, attention at 8 x 8). Inputs and weights come from seeded
numpy generators; the convolutions' resampling filters are the real ones
(the JAX package's transposed form holds for symmetric filters only).
Tolerances are relative to max |JAX|: float32 1e-5, 2e-5 where a softmax
sums 64 keys or more (the networks: 64 positions at 8 x 8), 1e-4 over a
trajectory.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process
import yaml

from azula_tpu.models import edm as jedm
from azula_tpu.models.edm import backbone as jbackbone
from azula_tpu.models.edm.convert import convert_edm_state_dict
from azula_tpu.sample import HeunSampler as JaxHeun
from azula_tpu.utils.pytree import filter_eval_shape, state_dict
from azula_tpu_torch.models import edm as tedm
from azula_tpu_torch.models.edm import backbone as tbackbone
from azula_tpu_torch.models.edm.convert import from_jax_state_dict
from azula_tpu_torch.models.utils import load_cards
from azula_tpu_torch.ops import norm
from azula_tpu_torch.sample import HeunSampler as TorchHeun

from test_torch_vae import _rel_err, call, load_jax, random_state, skeleton

TOL = 1e-5
TOL_SOFTMAX = 2e-5
TOL_TRAJECTORY = 1e-4

SONG_SMALL = dict(  # noqa: C408
    img_resolution=16,
    in_channels=3,
    out_channels=3,
    model_channels=16,
    channel_mult=(1, 2),
    channel_mult_emb=2,
    num_blocks=1,
    attn_resolutions=(8,),
)
DHARIWAL_SMALL = dict(  # noqa: C408
    img_resolution=16,
    in_channels=3,
    out_channels=3,
    label_dim=10,
    model_channels=16,
    channel_mult=(1, 2),
    channel_mult_emb=2,
    num_blocks=1,
    attn_resolutions=(8,),
)
SONG_VARIANTS = {
    "ddpmpp": dict(embedding_type="positional", encoder_type="standard", resample_filter=(1, 1), channel_mult_noise=1),  # noqa: C408
    "ncsnpp": dict(  # noqa: C408
        embedding_type="fourier", encoder_type="residual", resample_filter=(1, 3, 3, 1), channel_mult_noise=2
    ),
    "skip": dict(encoder_type="skip", decoder_type="skip"),  # noqa: C408
    "conditional": dict(label_dim=10),  # noqa: C408
}
# the edm-imagenet-64x64-cond-adm network, as NVlabs/edm's train.py --arch=adm builds it
EDM64 = dict(  # noqa: C408
    img_resolution=64,
    in_channels=3,
    out_channels=3,
    label_dim=1000,
    model_channels=192,
    channel_mult=(1, 2, 3, 4),
    num_blocks=3,
    attn_resolutions=(32, 16, 8),
)


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _state(module, seed: int) -> dict[str, np.ndarray]:
    r"""`random_state` with each convolution's normalized FIR filter as the
    network builds it: (1, 1) for the (2, 2) filters, (1, 3, 3, 1) for the
    (4, 4) ones."""

    sd = random_state(module, seed)
    for key, value in sd.items():
        if key.rpartition(".")[2] == "filter":
            f = {2: np.array([1.0, 1.0]), 4: np.array([1.0, 3.0, 3.0, 1.0])}[value.shape[0]]
            sd[key] = (np.outer(f, f) / f.sum() ** 2).astype(np.float32)
    return sd


def _pair(build, seed: int):
    r"""A JAX module and the port's, with the same random weights; `build(m,
    **factory)` builds either from its backbone module `m`."""

    jmodule = skeleton(lambda key: build(jbackbone, key=key))
    sd = _state(jmodule, seed)
    jmodule = load_jax(jmodule, sd)
    tmodule = build(tbackbone, device="cpu")
    # converted under a parent's name, as a bare layer's leaves have none
    state = from_jax_state_dict({f"m.{k}": v for k, v in sd.items()})
    tmodule.load_state_dict({k.removeprefix("m."): v for k, v in state.items()})

    return jmodule, tmodule, sd


def _precond(precond: str, unet: str, config: dict):
    def build(m, **factory):
        return getattr(m, precond)(getattr(m, unet)(**config, **factory))

    return build


def _run(jmodule, tmodule, x, sigma, label):
    want = call(
        lambda m, x, s, c: m(x, s, class_labels=c), jmodule, jnp.asarray(x), jnp.asarray(sigma),
        None if label is None else jnp.asarray(label),
    )
    with torch.no_grad():
        got = tmodule(
            torch.from_numpy(x), torch.as_tensor(sigma), class_labels=None if label is None else torch.from_numpy(label)
        )
    return got, want


# the NVlabs pairings of network and precond (VP: DDPM++, VE: NCSN++) and
# EDM's precond on each network. NCSN++'s Fourier embedding takes VE's
# c_noise = log(sigma / 2); under VP's c_noise = 999 t its arguments reach
# 2 pi 999 |16 N(0, 1)| ~ 1e5, where an ulp of float32 sin and cos decides.
CASES = {
    "ddpmpp-VPPrecond": ("VPPrecond", "SongUNet", SONG_VARIANTS["ddpmpp"]),
    "ddpmpp-EDMPrecond": ("EDMPrecond", "SongUNet", SONG_VARIANTS["ddpmpp"]),
    "ncsnpp-VEPrecond": ("VEPrecond", "SongUNet", SONG_VARIANTS["ncsnpp"]),
    "ncsnpp-EDMPrecond": ("EDMPrecond", "SongUNet", SONG_VARIANTS["ncsnpp"]),
    "skip-EDMPrecond": ("EDMPrecond", "SongUNet", SONG_VARIANTS["skip"]),
    "conditional-VPPrecond": ("VPPrecond", "SongUNet", SONG_VARIANTS["conditional"]),
    "dhariwal-EDMPrecond": ("EDMPrecond", "DhariwalUNet", {}),
    "dhariwal-VEPrecond": ("VEPrecond", "DhariwalUNet", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_precond_networks_match_jax(case):
    precond, unet, variant = CASES[case]
    config = {**(DHARIWAL_SMALL if unet == "DhariwalUNet" else SONG_SMALL), **variant}
    jmodule, tmodule, _ = _pair(_precond(precond, unet, config), seed=1)
    x, sigma = _normal(2, (2, 16, 16, 3)), np.asarray([0.3, 5.0], dtype=np.float32)
    label = np.eye(10, dtype=np.float32)[[3, 7]] if config.get("label_dim") else None

    got, want = _run(jmodule, tmodule, x, sigma, label)

    assert tuple(got.shape) == (2, 16, 16, 3) and got.dtype == torch.float32
    assert _rel_err(got, want) <= TOL_SOFTMAX


def test_conditional_precond_without_labels_feeds_zeros():
    # NVlabs Precond.forward: a conditional network called without labels
    # gets zero one-hots (the label embedding of SongUNet has a bias)
    config = {**SONG_SMALL, **SONG_VARIANTS["conditional"]}
    jmodule, tmodule, _ = _pair(_precond("EDMPrecond", "SongUNet", config), seed=3)
    x, sigma = _normal(4, (2, 16, 16, 3)), np.float32(1.5)

    got, want = _run(jmodule, tmodule, x, sigma, None)
    assert _rel_err(got, want) <= TOL_SOFTMAX

    with torch.no_grad():
        zeros = tmodule(torch.from_numpy(x), sigma, class_labels=torch.zeros(2, 10))
    assert torch.equal(got, zeros)


LAYERS = {
    "conv3": (lambda m, **kw: m.EDMConv(8, 16, 3, **kw), (2, 8, 8, 8)),
    "conv1_nobias": (lambda m, **kw: m.EDMConv(8, 16, 1, bias=False, **kw), (2, 8, 8, 8)),
    "up": (lambda m, **kw: m.EDMConv(8, 16, 3, up=True, **kw), (2, 4, 6, 8)),
    "down": (lambda m, **kw: m.EDMConv(8, 16, 3, down=True, **kw), (2, 8, 6, 8)),
    "up_fir": (lambda m, **kw: m.EDMConv(8, 8, 0, up=True, resample_filter=(1, 3, 3, 1), **kw), (2, 4, 6, 8)),
    "down_fir": (lambda m, **kw: m.EDMConv(8, 8, 0, down=True, resample_filter=(1, 3, 3, 1), **kw), (2, 8, 6, 8)),
    "down_fused": (
        lambda m, **kw: m.EDMConv(8, 16, 3, down=True, resample_filter=(1, 3, 3, 1), fused_resample=True, **kw),
        (2, 8, 6, 8),
    ),
    "up_fused": (
        lambda m, **kw: m.EDMConv(8, 16, 3, up=True, resample_filter=(1, 3, 3, 1), fused_resample=True, **kw),
        (2, 4, 6, 8),
    ),
}


@pytest.mark.parametrize("kind", list(LAYERS))
def test_conv_forms_match_jax(kind):
    build, shape = LAYERS[kind]
    jconv, tconv, _ = _pair(build, seed=5)
    x = _normal(6, shape)

    want = call(jconv, jnp.asarray(x))
    with torch.no_grad():
        got = tconv(torch.from_numpy(x))

    assert tuple(got.shape) == tuple(want.shape)
    assert _rel_err(got, want) <= TOL


BLOCKS = {
    "film_attention": dict(attention=True, channels_per_head=8),  # noqa: C408
    "additive_up": dict(up=True, adaptive_scale=False, skip_scale=math.sqrt(0.5), eps=1e-6),  # noqa: C408
    "down_fir_proj": dict(  # noqa: C408
        down=True, resample_filter=(1, 3, 3, 1), resample_proj=True, adaptive_scale=False, num_heads=1, attention=True
    ),
}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_unet_blocks_match_jax(kind):
    out = 16 if kind == "film_attention" else 24
    jblock, tblock, _ = _pair(lambda m, **kw: m.EDMUNetBlock(16, out, 12, **BLOCKS[kind], **kw), seed=7)
    x, emb = _normal(8, (2, 8, 8, 16)), _normal(9, (2, 12))

    want = call(jblock, jnp.asarray(x), jnp.asarray(emb))
    with torch.no_grad():
        got = tblock(torch.from_numpy(x), torch.from_numpy(emb))

    assert tuple(got.shape) == tuple(want.shape)
    assert _rel_err(got, want) <= TOL_SOFTMAX


@pytest.mark.parametrize("kind", ["positional", "positional_endpoint", "fourier"])
def test_noise_embeddings_match_jax(kind):
    if kind == "fourier":
        jemb, temb, _ = _pair(lambda m, **kw: m.FourierEmbedding(32, **kw), seed=10)
    else:
        endpoint = kind == "positional_endpoint"
        jemb, temb = jbackbone.PositionalEmbedding(32, endpoint=endpoint), tbackbone.PositionalEmbedding(32, endpoint=endpoint)
    t = np.asarray([-2.5, -0.1, 0.0, 0.7, 3.0], dtype=np.float32)

    want = call(jemb, jnp.asarray(t))
    got = temb(torch.from_numpy(t))

    assert tuple(got.shape) == (5, 32) and got.dtype == torch.float32
    assert _rel_err(got, want) <= TOL


# the denoiser


def _denoisers(seed: int):
    jmodule, tmodule, _ = _pair(_precond("EDMPrecond", "DhariwalUNet", DHARIWAL_SMALL), seed)
    return jedm.ElucidatedDenoiser(jmodule), tedm.ElucidatedDenoiser(tmodule)


TIMES = {"scalar": np.float32(0.4), "batch": np.asarray([0.15, 0.8], dtype=np.float32)}


def _denoise(jden, tden, x, t, label):
    want = call(
        lambda d, x, t, c: d(x, t, label=c).mean, jden, jnp.asarray(x), jnp.asarray(t),
        None if label is None else jnp.asarray(label),
    )
    with torch.no_grad():
        got = tden(torch.from_numpy(x), torch.as_tensor(t), label=None if label is None else torch.from_numpy(label)).mean
    return got, want


@pytest.mark.parametrize("labelled", [True, False], ids=["label", "no_label"])
@pytest.mark.parametrize("time", list(TIMES))
def test_denoiser_matches_jax(time, labelled):
    jden, tden = _denoisers(11)
    x = _normal(12, (2, 16, 16, 3))
    label = np.eye(10, dtype=np.float32)[[1, 4]] if labelled else None

    got, want = _denoise(jden, tden, x, TIMES[time], label)

    assert got.dtype == torch.float32
    assert _rel_err(got, want) <= TOL_SOFTMAX


# A bf16 backbone on both sides: the noise level sigma / alpha is rounded to
# bf16 before the precond takes it to float32 (as in JAX), the network runs
# in bf16, its output is cast back to float32. Both networks round after
# every operation, each in its own order, so the bf16 means are held to
# JAX's float32 mean as in `tests/test_torch_sd.py`: no farther from it than
# `BF16_SLACK` times JAX's own bf16 mean, no farther from that than twice.
BF16_SLACK = 1.5


@pytest.mark.parametrize("time", list(TIMES))
def test_denoiser_with_a_bf16_backbone(time):
    jden, tden = _denoisers(13)
    jden16 = jedm.ElucidatedDenoiser(jden.backbone.astype(jnp.bfloat16))
    tden.backbone.to(torch.bfloat16)
    x, label = _normal(14, (2, 16, 16, 3)), np.eye(10, dtype=np.float32)[[2, 9]]

    got, want16 = _denoise(jden16, tden, x, TIMES[time], label)
    _, want32 = _denoise(jden, tden, x, TIMES[time], label)

    assert want16.dtype == jnp.float32 and got.dtype == torch.float32
    jax_err = _rel_err(want16, want32)
    assert 1e-3 < jax_err < 5e-2
    assert _rel_err(got, want32) <= BF16_SLACK * jax_err
    assert _rel_err(got, want16) <= 2 * jax_err


def test_denoiser_rounds_the_noise_level_to_the_backbone():
    _, tden = _denoisers(15)
    tden.backbone.to(torch.bfloat16)
    seen = {}

    def spy(x, sigma, class_labels=None):
        seen.update(x=x.dtype, sigma=sigma, labels=class_labels.dtype)
        return x

    tden.backbone.forward = spy
    t = torch.tensor([0.3, 0.6])
    out = tden(torch.zeros(2, 16, 16, 3), t, label=torch.zeros(2, 10)).mean

    sigma = tden.schedule.sigma(t)
    assert out.dtype == torch.float32 and seen["x"] == seen["labels"] == torch.bfloat16
    assert seen["sigma"].dtype == torch.bfloat16 and torch.equal(seen["sigma"], sigma.to(torch.bfloat16))
    assert not torch.equal(seen["sigma"].float(), sigma)  # the rounding bites at these times


def test_heun_trajectory_matches_jax():
    jden, tden = _denoisers(16)
    x1 = _normal(17, (2, 16, 16, 3)) * 80.0
    label = np.eye(10, dtype=np.float32)[[0, 5]]

    want = call(lambda d, x, c: JaxHeun(d, steps=4)(x, label=c), jden, jnp.asarray(x1), jnp.asarray(label))
    with torch.no_grad():
        got = TorchHeun(tden, steps=4)(torch.from_numpy(x1), label=torch.from_numpy(label))

    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= TOL_TRAJECTORY


def test_group_norms_take_min_32_c_over_4_groups(monkeypatch):
    # every GroupNorm goes through `group_norm` (the kernel on the card),
    # none through `group_norm_silu`, with min(32, C // 4) groups
    _, tden = _denoisers(18)
    calls = []
    plain = norm._gn_forward

    def spy(x, P, Q, groups, eps, silu, implementation):
        calls.append((x.shape[-1], groups, silu))
        return plain(x, P, Q, groups, eps, silu, implementation)

    monkeypatch.setattr(norm, "_gn_forward", spy)
    with torch.no_grad():
        tden(torch.zeros(1, 16, 16, 3), torch.tensor(0.5))

    blocks = [m for m in tden.backbone.modules() if isinstance(m, tbackbone.EDMUNetBlock)]
    assert len(calls) == 2 * len(blocks) + sum(b.num_heads > 0 for b in blocks) + 1
    assert all(groups == min(32, C // 4) and not silu for C, groups, silu in calls)


# the weights both ways


@pytest.mark.parametrize("unet", ["SongUNet", "DhariwalUNet"])
def test_converter_round_trip(unet):
    config = {**SONG_SMALL, **SONG_VARIANTS["ncsnpp"]} if unet == "SongUNet" else DHARIWAL_SMALL
    jmodule, tmodule, sd = _pair(_precond("EDMPrecond", unet, config), seed=19)

    back = convert_edm_state_dict(jmodule, tmodule.state_dict())

    assert set(back) == set(sd)
    for key, value in sd.items():
        assert np.array_equal(np.asarray(back[key]), value), key


@pytest.mark.parametrize("case", ["ncsnpp", "skip", "dhariwal"])
def test_twin_state_dict_loads_as_it_is(case):
    from torch_twins import edm_unet as twin_mod

    torch.manual_seed(0)
    if case == "dhariwal":
        config, unet = DHARIWAL_SMALL, "DhariwalUNet"
    else:
        config, unet = {**SONG_SMALL, **SONG_VARIANTS[case]}, "SongUNet"
    twin = twin_mod.EDMPrecond(getattr(twin_mod, unet)(**config)).eval()
    tmodule = tbackbone.EDMPrecond(getattr(tbackbone, unet)(**config, device="cpu"))
    tmodule.load_state_dict(twin.state_dict())

    x, sigma = _normal(20, (2, 16, 16, 3)), np.asarray([0.5, 4.0], dtype=np.float32)
    label = torch.eye(10)[[2, 6]] if config.get("label_dim") else None
    with torch.no_grad():
        want = twin(torch.from_numpy(np.moveaxis(x, -1, 1).copy()), torch.from_numpy(sigma), class_labels=label)
        got = tmodule(torch.from_numpy(x), torch.from_numpy(sigma), class_labels=label)

    assert _rel_err(got, want.movedim(1, -1)) <= TOL_SOFTMAX


# full size and cards


def test_full_size_edm64_matches_jax():
    tmodule = tbackbone.EDMPrecond(tbackbone.DhariwalUNet(**EDM64, device="meta"))
    jmodule = filter_eval_shape(lambda: jbackbone.EDMPrecond(jbackbone.DhariwalUNet(**EDM64, key=jax.random.key(0))))

    n = sum(p.numel() for p in tmodule.parameters())
    assert n == sum(math.prod(leaf.shape) for name, leaf in state_dict(jmodule).items() if not name.endswith(".filter"))
    assert 295e6 < n < 297e6  # edm-imagenet-64x64-cond-adm: 296M parameters
    heads = [b.num_heads for b in tmodule.modules() if isinstance(b, tbackbone.EDMUNetBlock) and b.num_heads]
    assert len(heads) == 3 * 3 + 1 + 3 * 4 and set(heads) == {6, 9, 12}


def test_cards_equal_jax():
    cards = load_cards(tedm)
    with open(jedm.__file__.replace("__init__.py", "cards.yaml")) as f:
        jax_cards = yaml.safe_load(f)
    assert {name: vars(card) for name, card in cards.items()} == jax_cards
    assert "imagenet_64x64_cond" in cards


def test_exports_cover_jax():
    # the JAX package's public names, but `load_model`, which waits for
    # checkpoint files in the repository
    assert set(jedm.__all__) - {"load_model"} <= set(tedm.__all__)
    assert tedm.ElucidatedSchedule is tedm.ElucidatedDenoiser(tedm.EDMPrecond(tedm.SongUNet(
        **SONG_SMALL, device="meta"))).schedule.__class__
