r"""The PyTorch port's EDM2 family (`azula_tpu_torch.models.eldm`) against
the JAX package's, on the CPU: the magnitude-preserving helpers
(`normalize`, `mp_silu`, `mp_sum`, `mp_cat`), `MPFourier`, `MPConv` (linear
and convolution, with a gain), `EDM2Block` (encoder and decoder flavours,
down, up, attention), `EDM2UNet` under `EDM2Precond` with and without
labels, `ElucidatedLatentDenoiser` (a float32 time of shape () and (B,), and
a bf16 backbone), a Heun-4 trajectory, and the `AutoEncoder` with per-channel
statistics and JAX's draws injected; the weights both ways (JAX -> port by
`from_jax_state_dict`, port -> JAX by `convert_eldm_state_dict`, exact) and
the NVlabs/edm2 twin's state dict as it is; the full-size
`imagenet_512x512_xxl` network (meta device) against JAX's parameter count.

The small configuration is that of `tests/test_models_eldm.py` (16 x 16
latents of 4 channels, channels (16, 32), one block a level, attention at
8 x 8). Inputs and weights come from seeded numpy generators, the scalar
gains among them (drawn, not JAX's zeros, so that they act). Tolerances are
relative to max |JAX|: float32 1e-5, 2e-5 where a softmax sums 64 keys or
more (the networks: 64 positions at 8 x 8), 1e-4 over a trajectory.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process
import yaml

from azula_tpu.models import eldm as jeldm
from azula_tpu.models.autoencoder import AutoencoderKL as JaxAutoencoderKL
from azula_tpu.models.eldm import backbone as jbackbone
from azula_tpu.models.eldm.convert import convert_eldm_state_dict
from azula_tpu.sample import HeunSampler as JaxHeun
from azula_tpu.utils.pytree import filter_eval_shape, state_dict
from azula_tpu_torch.models import autoencoder as tvae
from azula_tpu_torch.models import eldm as teldm
from azula_tpu_torch.models.eldm import backbone as tbackbone
from azula_tpu_torch.models.eldm.convert import from_jax_state_dict
from azula_tpu_torch.models.utils import load_cards
from azula_tpu_torch.sample import HeunSampler as TorchHeun

from test_torch_vae import _rel_err, call, decode, load_jax, random_state, skeleton

TOL = 1e-5
TOL_SOFTMAX = 2e-5
TOL_TRAJECTORY = 1e-4

SMALL = dict(  # noqa: C408
    img_resolution=16,
    img_channels=4,
    label_dim=10,
    model_channels=16,
    channel_mult=(1, 2),
    num_blocks=1,
    attn_resolutions=(8,),
)
# EDM2-XXL (the imagenet_512x512_xxl card): NVlabs/edm2's presets, XS 128 ... XXL 448 channels
EDM2_XXL = dict(  # noqa: C408
    img_resolution=64,
    img_channels=4,
    label_dim=1000,
    model_channels=448,
    channel_mult=(1, 2, 3, 4),
    num_blocks=3,
    attn_resolutions=(16, 8),
)
# NVlabs/edm2 training/encoders.py StabilityVAEEncoder: the latents are
# (z - raw_mean) * final_std / raw_std
RAW_MEAN = np.asarray([5.81, 3.25, 0.12, -2.15], dtype=np.float32)
RAW_STD = np.asarray([4.17, 4.62, 3.71, 3.28], dtype=np.float32)
FINAL_STD = 0.5


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(build, seed: int):
    r"""A JAX module and the port's, with the same random weights (the gains
    at 0.5 N(0, 1)); `build(m, **factory)` builds either from `m`."""

    jmodule = skeleton(lambda key: build(jbackbone, key=key))
    sd = random_state(jmodule, seed, tables=0.5)
    jmodule = load_jax(jmodule, sd)
    tmodule = build(tbackbone, device="cpu")
    # converted under a parent's name, as a bare layer's leaves have none
    state = from_jax_state_dict({f"m.{k}": v for k, v in sd.items()})
    tmodule.load_state_dict({k.removeprefix("m."): v for k, v in state.items()})

    return jmodule, tmodule, sd


def _precond(label_dim: int):
    def build(m, **factory):
        return m.EDM2Precond(m.EDM2UNet(**{**SMALL, "label_dim": label_dim}, **factory), label_dim=label_dim)

    return build


def test_helpers_match_jax():
    a, b = _normal(1, (2, 3, 5, 8)), _normal(2, (2, 3, 5, 4))

    for got, want in (
        (tbackbone.normalize(torch.from_numpy(a)), jbackbone.normalize(jnp.asarray(a))),
        (tbackbone.normalize(torch.from_numpy(a), dim=-1), jbackbone.normalize(jnp.asarray(a), dim=-1)),
        (tbackbone.normalize(torch.from_numpy(a), dim=(1, 3)), jbackbone.normalize(jnp.asarray(a), dim=(1, 3))),
        (tbackbone.mp_silu(torch.from_numpy(a)), jbackbone.mp_silu(jnp.asarray(a))),
        (tbackbone.mp_sum(torch.from_numpy(a), torch.from_numpy(a[::-1].copy()), t=0.3),
         jbackbone.mp_sum(jnp.asarray(a), jnp.asarray(a[::-1]), t=0.3)),
        (tbackbone.mp_cat(torch.from_numpy(a), torch.from_numpy(b), t=0.5),
         jbackbone.mp_cat(jnp.asarray(a), jnp.asarray(b), t=0.5)),
    ):
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel_err(got, want) <= TOL


LAYERS = {
    "fourier": (lambda m, **kw: m.MPFourier(32, **kw), [(5,)]),
    "linear": (lambda m, **kw: m.MPConv(12, 16, (), **kw), [(3, 12)]),
    "conv3": (lambda m, **kw: m.MPConv(8, 16, (3, 3), **kw), [(2, 5, 6, 8)]),
    "conv1": (lambda m, **kw: m.MPConv(8, 16, (1, 1), **kw), [(2, 5, 6, 8)]),
    "enc": (lambda m, **kw: m.EDM2Block(16, 32, 12, flavor="enc", **kw), [(2, 8, 8, 16), (2, 12)]),
    "enc_down": (lambda m, **kw: m.EDM2Block(16, 16, 12, flavor="enc", resample_mode="down", **kw), [(2, 8, 6, 16), (2, 12)]),
    "enc_attention": (
        lambda m, **kw: m.EDM2Block(16, 16, 12, flavor="enc", attention=True, channels_per_head=8, **kw),
        [(2, 8, 8, 16), (2, 12)],
    ),
    "dec_skip_attention": (
        lambda m, **kw: m.EDM2Block(32, 16, 12, flavor="dec", attention=True, channels_per_head=8, **kw),
        [(2, 8, 8, 32), (2, 12)],
    ),
    "dec_up": (lambda m, **kw: m.EDM2Block(16, 16, 12, flavor="dec", resample_mode="up", **kw), [(2, 4, 6, 16), (2, 12)]),
    "dec_clip": (
        lambda m, **kw: m.EDM2Block(16, 16, 12, flavor="dec", clip_act=0.5, **kw), [(2, 8, 8, 16), (2, 12)]
    ),
}


@pytest.mark.parametrize("kind", list(LAYERS))
def test_layers_match_jax(kind):
    build, shapes = LAYERS[kind]
    jlayer, tlayer, _ = _pair(build, seed=3)
    arrays = [_normal(4 + i, s) for i, s in enumerate(shapes)]

    if kind.startswith(("linear", "conv")):  # with a gain, as the blocks call them
        want = call(lambda m, x: m(x, gain=0.7), jlayer, jnp.asarray(arrays[0]))
        with torch.no_grad():
            got = tlayer(torch.from_numpy(arrays[0]), gain=0.7)
    else:
        want = call(jlayer, *(jnp.asarray(a) for a in arrays))
        with torch.no_grad():
            got = tlayer(*(torch.from_numpy(a) for a in arrays))

    assert tuple(got.shape) == tuple(want.shape)
    assert _rel_err(got, want) <= (TOL_SOFTMAX if "attention" in kind else TOL)


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


@pytest.mark.parametrize("labels", ["given", "zeros", "unconditional"])
def test_precond_network_matches_jax(labels):
    jmodule, tmodule, _ = _pair(_precond(0 if labels == "unconditional" else 10), seed=5)
    x, sigma = _normal(6, (2, 16, 16, 4)), np.asarray([0.5, 7.0], dtype=np.float32)
    label = np.eye(10, dtype=np.float32)[[2, 9]] if labels == "given" else None

    got, want = _run(jmodule, tmodule, x, sigma, label)

    assert tuple(got.shape) == (2, 16, 16, 4) and got.dtype == torch.float32
    assert _rel_err(got, want) <= TOL_SOFTMAX


# the denoiser


def _denoisers(seed: int):
    jmodule, tmodule, _ = _pair(_precond(10), seed)
    return jeldm.ElucidatedLatentDenoiser(jmodule), teldm.ElucidatedLatentDenoiser(tmodule)


TIMES = {"scalar": np.float32(0.4), "batch": np.asarray([0.15, 0.8], dtype=np.float32)}


def _denoise(jden, tden, x, t, label):
    want = call(lambda d, x, t, c: d(x, t, label=c).mean, jden, jnp.asarray(x), jnp.asarray(t), jnp.asarray(label))
    with torch.no_grad():
        got = tden(torch.from_numpy(x), torch.as_tensor(t), label=torch.from_numpy(label)).mean
    return got, want


@pytest.mark.parametrize("time", list(TIMES))
def test_denoiser_matches_jax(time):
    jden, tden = _denoisers(7)
    x, label = _normal(8, (2, 16, 16, 4)), np.eye(10, dtype=np.float32)[[1, 4]]

    got, want = _denoise(jden, tden, x, TIMES[time], label)

    assert got.dtype == torch.float32
    assert _rel_err(got, want) <= TOL_SOFTMAX


# A bf16 backbone on both sides, held as in `tests/test_torch_sd.py`: no
# farther from JAX's float32 mean than `BF16_SLACK` times JAX's own bf16
# mean, no farther from that than twice.
BF16_SLACK = 1.5


@pytest.mark.parametrize("time", list(TIMES))
def test_denoiser_with_a_bf16_backbone(time):
    jden, tden = _denoisers(9)
    jden16 = jeldm.ElucidatedLatentDenoiser(jden.backbone.astype(jnp.bfloat16))
    tden.backbone.to(torch.bfloat16)
    x, label = _normal(10, (2, 16, 16, 4)), np.eye(10, dtype=np.float32)[[3, 8]]

    got, want16 = _denoise(jden16, tden, x, TIMES[time], label)
    _, want32 = _denoise(jden, tden, x, TIMES[time], label)

    assert want16.dtype == jnp.float32 and got.dtype == torch.float32
    jax_err = _rel_err(want16, want32)
    assert 1e-3 < jax_err < 5e-2
    assert _rel_err(got, want32) <= BF16_SLACK * jax_err
    assert _rel_err(got, want16) <= 2 * jax_err


def test_heun_trajectory_matches_jax():
    jden, tden = _denoisers(11)
    x1 = _normal(12, (2, 16, 16, 4)) * 80.0
    label = np.eye(10, dtype=np.float32)[[0, 5]]

    want = call(lambda d, x, c: JaxHeun(d, steps=4)(x, label=c), jden, jnp.asarray(x1), jnp.asarray(label))
    with torch.no_grad():
        got = TorchHeun(tden, steps=4)(torch.from_numpy(x1), label=torch.from_numpy(label))

    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= TOL_TRAJECTORY


def test_autoencoder_matches_jax():
    cfg = dict(latent_channels=4, block_out_channels=(32, 64), layers_per_block=1)  # noqa: C408
    jvae = skeleton(JaxAutoencoderKL, **cfg)
    sd = random_state(jvae, 13)
    jvae = load_jax(jvae, sd)
    tmodel = tvae.AutoencoderKL(**cfg, device="cpu")
    tmodel.load_state_dict(tvae.from_jax_state_dict(sd, tmodel))
    scale = FINAL_STD / RAW_STD
    shift = -RAW_MEAN * scale
    jae = jeldm.AutoEncoder(jvae, shift=shift, scale=scale)
    tae = teldm.AutoEncoder(tmodel, shift=shift, scale=scale)

    x = _normal(14, (2, 32, 32, 3))
    key = jnp.asarray(np.uint32([0, 15]))
    noise = np.asarray(jax.random.normal(key, (2, 16, 16, 4)))

    want = call(lambda m, x, k: m.encode(x, k), jae, jnp.asarray(x), key)
    tae._normal = lambda generator, like: torch.from_numpy(noise.copy())  # JAX's draws
    with torch.no_grad():
        got = tae.encode(torch.from_numpy(x))

    assert tuple(got.shape) == (2, 16, 16, 4)
    assert _rel_err(got, want) <= TOL_SOFTMAX  # the encoder's softmax over 256 keys

    z = _normal(16, (1, 4, 4, 4))
    want = decode(jae, jnp.asarray(z))
    with torch.no_grad():
        got = tae.decode(torch.from_numpy(z))

    assert tuple(got.shape) == (1, 8, 8, 3)
    assert _rel_err(got, want) <= TOL


# the weights both ways


@pytest.mark.parametrize("label_dim", [10, 0], ids=["cond", "uncond"])
def test_converter_round_trip(label_dim):
    jmodule, tmodule, sd = _pair(_precond(label_dim), seed=17)

    back = convert_eldm_state_dict(jmodule, tmodule.state_dict())

    assert set(back) == set(sd)
    for key, value in sd.items():
        assert np.array_equal(np.asarray(back[key]), value), key


@pytest.mark.parametrize("label_dim", [10, 0], ids=["cond", "uncond"])
def test_twin_state_dict_loads_as_it_is(label_dim):
    from torch_twins import edm2_unet as twin_mod

    torch.manual_seed(0)
    cfg = {**SMALL, "label_dim": label_dim}
    twin = twin_mod.Precond(twin_mod.UNet(**cfg), label_dim=label_dim).eval()
    with torch.no_grad():  # gains that act (the twin starts them at 0)
        for name, p in twin.named_parameters():
            if name.endswith("_gain"):
                p.fill_(0.3)
    tmodule = tbackbone.EDM2Precond(tbackbone.EDM2UNet(**cfg, device="cpu"), label_dim=label_dim)
    tmodule.load_state_dict(twin.state_dict())

    x, sigma = _normal(18, (2, 16, 16, 4)), np.asarray([0.5, 7.0], dtype=np.float32)
    label = torch.eye(10)[[2, 9]] if label_dim else None
    with torch.no_grad():
        want = twin(torch.from_numpy(np.moveaxis(x, -1, 1).copy()), torch.from_numpy(sigma), class_labels=label)
        got = tmodule(torch.from_numpy(x), torch.from_numpy(sigma), class_labels=label)

    assert _rel_err(got, want.movedim(1, -1)) <= TOL_SOFTMAX


# full size and cards


def test_full_size_edm2_xxl_matches_jax():
    tmodule = tbackbone.EDM2Precond(tbackbone.EDM2UNet(**EDM2_XXL, device="meta"), label_dim=1000)
    jmodule = filter_eval_shape(
        lambda: jbackbone.EDM2Precond(jbackbone.EDM2UNet(**EDM2_XXL, key=jax.random.key(0)), label_dim=1000)
    )

    n = sum(p.numel() for p in tmodule.parameters())
    buffers = {k: tuple(v.shape) for k, v in tmodule.named_buffers()}
    jax_shapes = {k: tuple(v.shape) for k, v in state_dict(jmodule).items()}
    assert n + sum(math.prod(s) for s in buffers.values()) == sum(math.prod(s) for s in jax_shapes.values())
    assert buffers == {"unet.emb_fourier.freqs": (448,), "unet.emb_fourier.phases": (448,)}
    assert 1.5e9 < n < 1.6e9  # EDM2-XXL: 1.5B parameters
    heads = [b.num_heads for b in tmodule.modules() if isinstance(b, tbackbone.EDM2Block) and b.num_heads]
    assert set(heads) == {21, 28}


def test_cards_equal_jax():
    cards = load_cards(teldm)
    with open(jeldm.__file__.replace("__init__.py", "cards.yaml")) as f:
        jax_cards = yaml.safe_load(f)
    assert {name: vars(card) for name, card in cards.items()} == jax_cards
    assert "imagenet_512x512_xxl" in cards
