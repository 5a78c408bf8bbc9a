r"""The PyTorch port's Stable Diffusion family (`azula_tpu_torch.models.sd`)
against the JAX package's, on the CPU: the `SDUNet` with both transformer
projection layouts (SD 1's 1x1 convolutions, SD 2's linears) and each of its
blocks, the timestep embedding, `StableDenoiser` with both predictions (a
float32 time of shape () and (B,), and a bf16 backbone), a DDIM-4
trajectory under CFG, the discrete timesteps and `sd_sigmas`, the
`AutoEncoder` with JAX's draws injected and the CLIP `TextEncoder`; the
weights both ways (JAX -> port by `from_jax_state_dict`, port -> JAX by
`convert_unet_state_dict`, exact) and the diffusers twin's state dict as it
is; the full-size SD 1 and SD 2 modules (meta device) against the port's
manifests and JAX's parameter counts.

The small configuration is that of `tests/test_models_sd.py` (channels
(32, 64), one resnet a level, two heads of 16, 24-d prompts). Inputs and
weights come from seeded numpy generators. Tolerances are relative to
max |JAX|: float32 1e-5 (the same arithmetic in another order), 2e-5 where
a softmax sums 64 keys or more (every UNet call: 256 queries and keys at
16 x 16), 1e-4 over a trajectory.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process
import yaml

from azula_tpu.guidance import CFGDenoiser as JaxCFG
from azula_tpu.models import sd as jsd
from azula_tpu.models.autoencoder import AutoencoderKL as JaxAutoencoderKL
from azula_tpu.models.clip import CLIPTextEncoder as JaxCLIP
from azula_tpu.models.sd import backbone as jbackbone
from azula_tpu.models.sd.convert import convert_unet_state_dict
from azula_tpu.sample import DDIMSampler as JaxDDIM
from azula_tpu.utils.pytree import filter_eval_shape
from azula_tpu_torch.guidance import CFGDenoiser
from azula_tpu_torch.models import autoencoder as tvae
from azula_tpu_torch.models import clip as tclip
from azula_tpu_torch.models import sd as tsd
from azula_tpu_torch.models.sd import backbone as tbackbone
from azula_tpu_torch.models.sd.convert import from_jax_state_dict
from azula_tpu_torch.models.utils import SeededTokenizer, check_manifest, load_cards
from azula_tpu_torch.sample import DDIMSampler as TorchDDIM

from test_torch_vae import _f64, _rel_err, call, decode, load_jax, random_state, skeleton

TOL = 1e-5
TOL_SOFTMAX = 2e-5
TOL_TRAJECTORY = 1e-4

SMALL = dict(  # noqa: C408
    in_channels=4,
    out_channels=4,
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention_dim=24,
    attention_head_dim=2,
    cross_attention_levels=(True, False),
)
LAYOUTS = {"sd1_conv": False, "sd2_linear": True}


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _unet_pair(seed: int, **config):
    cfg = {**SMALL, **config}
    jmodel = skeleton(jbackbone.SDUNet, **cfg)
    sd = random_state(jmodel, seed)
    jmodel = load_jax(jmodel, sd)

    tmodel = tbackbone.SDUNet(**cfg, device="cpu")
    tmodel.load_state_dict(from_jax_state_dict(sd, tmodel))

    return jmodel, tmodel, sd


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unet_matches_jax(layout):
    jmodel, tmodel, _ = _unet_pair(1, use_linear_projection=LAYOUTS[layout])
    z, ctx = _normal(2, (2, 16, 16, 4)), _normal(3, (2, 7, 24))
    t = np.asarray([10, 999], dtype=np.int32)

    want = call(jmodel, jnp.asarray(z), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(ctx))

    assert tuple(got.shape) == (2, 16, 16, 4)
    assert _rel_err(got, want) <= TOL_SOFTMAX


BLOCKS = {
    "resnet": (lambda m, **kw: m.ResnetBlock2D(32, 32, 16, **kw), [(2, 8, 8, 32), (2, 16)]),
    "resnet_shortcut": (lambda m, **kw: m.ResnetBlock2D(32, 64, 16, **kw), [(2, 8, 8, 32), (2, 16)]),
    "self_attention": (lambda m, **kw: m.CrossAttention(32, heads=2, **kw), [(2, 9, 32)]),
    "cross_attention": (lambda m, **kw: m.CrossAttention(32, context_dim=24, heads=4, **kw), [(2, 9, 32), (2, 5, 24)]),
    "geglu": (lambda m, **kw: m.GEGLUFeedForward(32, **kw), [(2, 9, 32)]),
    "transformer_block": (lambda m, **kw: m.BasicTransformerBlock(32, 24, 2, **kw), [(2, 9, 32), (2, 5, 24)]),
    "transformer2d_conv": (lambda m, **kw: m.Transformer2DModel(32, 24, 2, **kw), [(2, 4, 6, 32), (2, 5, 24)]),
    "transformer2d_linear": (
        lambda m, **kw: m.Transformer2DModel(32, 24, 2, use_linear_projection=True, **kw),
        [(2, 4, 6, 32), (2, 5, 24)],
    ),
    "downsample": (lambda m, **kw: m.Downsample2D(32, 16, **kw), [(2, 9, 8, 32)]),
    "upsample": (lambda m, **kw: m.Upsample2D(32, **kw), [(2, 5, 4, 32)]),
    "layer_norm": (lambda m, **kw: m.AffineLayerNorm(32), [(2, 9, 32)]),
}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_blocks_match_jax(kind):
    build, shapes = BLOCKS[kind]
    jblock = skeleton(lambda key: build(jbackbone, key=key) if kind != "layer_norm" else build(jbackbone))
    sd = random_state(jblock, 4)
    jblock = load_jax(jblock, sd)
    tblock = build(tbackbone, device="cpu")
    # the feed-forward's renames key on its name in its block, and a leaf
    # converts under a module's name: both are converted as their block holds them
    prefix = {"geglu": "ff.", "layer_norm": "norm1."}.get(kind, "")
    state = from_jax_state_dict({prefix + k: v for k, v in sd.items()})
    tblock.load_state_dict({k.removeprefix(prefix): v for k, v in state.items()})

    arrays = [_normal(5 + i, s) for i, s in enumerate(shapes)]
    want = call(jblock, *(jnp.asarray(a) for a in arrays))
    with torch.no_grad():
        got = tblock(*(torch.from_numpy(a) for a in arrays))

    assert tuple(got.shape) == tuple(want.shape)
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("flip, shift", [(True, 0.0), (False, 1.0)])
def test_timestep_embedding_matches_jax(flip, shift):
    t = np.asarray([0, 1, 37, 500, 998, 999], dtype=np.int32)

    want = jbackbone.sinusoidal_timestep_embedding(jnp.asarray(t), 320, flip_sin_to_cos=flip, freq_shift=shift)
    got = tbackbone.sinusoidal_timestep_embedding(torch.from_numpy(t), 320, flip_sin_to_cos=flip, freq_shift=shift)

    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 320)
    # an ulp of the largest argument: XLA's and PyTorch's float32 exp differ
    assert np.abs(_f64(got) - _f64(want)).max() <= 2 * np.spacing(np.float32(999))


# the denoiser


def _denoisers(seed: int, prediction: str, **config):
    jmodel, tmodel, _ = _unet_pair(seed, **config)
    return jsd.StableDenoiser(jmodel, prediction=prediction), tsd.StableDenoiser(tmodel, prediction=prediction)


TIMES = {"scalar": np.float32(0.3), "batch": np.asarray([0.2, 0.9], dtype=np.float32)}


@pytest.mark.parametrize("time", list(TIMES))
@pytest.mark.parametrize("prediction", ["epsilon", "velocity"])
def test_denoiser_matches_jax(prediction, time):
    jden, tden = _denoisers(6, prediction, use_linear_projection=prediction == "velocity")
    z, ctx = _normal(7, (2, 16, 16, 4)), _normal(8, (1, 7, 24))
    t = TIMES[time]

    want = call(lambda d, z, t, c: d(z, t, prompt_embeds=c).mean, jden, jnp.asarray(z), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = tden(torch.from_numpy(z), torch.as_tensor(t), prompt_embeds=torch.from_numpy(ctx)).mean

    assert got.dtype == torch.float32
    # epsilon: c_out = -sigma / alpha scales the backbone's error by up to ~3
    alpha, sigma = jden.schedule(jnp.asarray(t))
    scale = 1.0 if prediction == "velocity" else max(1.0, float(jnp.max(sigma / alpha)))
    assert _rel_err(got, want) <= TOL_SOFTMAX * scale


# A bf16 backbone on both sides (JAX's `astype`, the port's `.to`) with a
# float32 latent and time: float32 coefficients around the bf16 network, a
# float32 mean. Both networks round to bf16 after every operation, each in
# its own order, so the bf16 means are held to JAX's float32 mean: the
# port's may lie no farther from it than `BF16_SLACK` times JAX's own bf16
# mean does (measured 0.87-0.90 of it), and no farther from JAX's bf16 mean
# than twice that (measured 1.17-1.27).
BF16_SLACK = 1.5


@pytest.mark.parametrize("time", list(TIMES))
def test_denoiser_with_a_bf16_backbone(time):
    jden, tden = _denoisers(9, "velocity", use_linear_projection=True)
    jden16 = jsd.StableDenoiser(jden.backbone.astype(jnp.bfloat16), prediction="velocity")
    tden.backbone.to(torch.bfloat16)
    z, ctx = _normal(10, (2, 16, 16, 4)), _normal(11, (1, 7, 24))
    t = TIMES[time]

    def mean(d, z, t, c):
        return d(z, t, prompt_embeds=c).mean

    want32 = call(mean, jden, jnp.asarray(z), jnp.asarray(t), jnp.asarray(ctx))
    want16 = call(mean, jden16, jnp.asarray(z), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = tden(torch.from_numpy(z), torch.as_tensor(t), prompt_embeds=torch.from_numpy(ctx)).mean

    assert want16.dtype == jnp.float32 and got.dtype == torch.float32
    jax_err = _rel_err(want16, want32)
    assert 1e-3 < jax_err < 5e-2  # the bf16 network's own rounding
    assert _rel_err(got, want32) <= BF16_SLACK * jax_err
    assert _rel_err(got, want16) <= 2 * jax_err


def test_denoiser_rounds_the_backbone_inputs():
    _, tden = _denoisers(12, "velocity")
    tden.backbone.to(torch.bfloat16)
    seen = {}

    def spy(**kwargs):
        seen.update({k: (v.dtype, tuple(v.shape)) for k, v in kwargs.items()})
        return kwargs["sample"]

    tden.backbone.forward = spy
    out = tden(torch.zeros(3, 16, 16, 4), torch.tensor(0.5), prompt_embeds=torch.zeros(1, 7, 24)).mean

    assert out.dtype == torch.float32
    assert seen == {
        "timestep": (torch.int64, (3,)),
        "sample": (torch.bfloat16, (3, 16, 16, 4)),
        "encoder_hidden_states": (torch.bfloat16, (3, 7, 24)),
    }


def test_unknown_prediction_raises():
    _, tden = _denoisers(13, "sample")
    with pytest.raises(ValueError, match="Unknown prediction type"):
        tden(torch.zeros(1, 16, 16, 4), torch.tensor(0.5), prompt_embeds=torch.zeros(1, 7, 24))


GUIDANCE = 6.5


def test_cfg_ddim_trajectory_matches_jax():
    jden, tden = _denoisers(14, "velocity", use_linear_projection=True)
    z = _normal(15, (2, 16, 16, 4))
    pos, neg = _normal(16, (2, 7, 24)), _normal(17, (1, 7, 24))

    def jax_run(d, z, p, n):
        sampler = JaxDDIM(JaxCFG(d, batched=True), eta=0.0, steps=4)
        return sampler(z, positive={"prompt_embeds": p}, negative={"prompt_embeds": n}, guidance=GUIDANCE)

    want = call(jax_run, jden, jnp.asarray(z), jnp.asarray(pos), jnp.asarray(neg))
    with torch.no_grad():
        got = TorchDDIM(CFGDenoiser(tden, batched=True), eta=0.0, steps=4)(
            torch.from_numpy(z),
            positive={"prompt_embeds": torch.from_numpy(pos)},
            negative={"prompt_embeds": torch.from_numpy(neg)},
            guidance=GUIDANCE,
        )

    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= TOL_TRAJECTORY


def test_sd_sigmas_equal_jax():
    for steps in (1000, 10):
        assert np.array_equal(tsd.sd_sigmas(steps), jsd.sd_sigmas(steps))
    tden = tsd.StableDenoiser(tbackbone.SDUNet(**SMALL, device="meta"))
    assert tden.sigmas.dtype == torch.float32


@pytest.mark.parametrize("steps", [4, 25, 50, 1000])
def test_discrete_timesteps_equal_jax(steps):
    # The checkpoint's index of each time of JAX's DDIM grid: a left search
    # of the float32 noise ratio in the float32 table, both sides (no tie on
    # these grids). JAX's grid is taken for both: at 1000 steps XLA's FMAs
    # move some times by an ulp from the port's.
    jden = jsd.StableDenoiser(None)
    tden = tsd.StableDenoiser(tbackbone.SDUNet(**SMALL, device="cpu"))
    seen = []
    tden.backbone.forward = lambda timestep, sample, **kwargs: (seen.append(timestep), sample)[1]
    times = np.asarray(JaxDDIM(jden, steps=steps).timesteps)

    def jax_index(t):
        alpha, sigma = jden.schedule(t)
        return jnp.searchsorted(jden.sigmas, (sigma * jax.lax.rsqrt(alpha**2 + sigma**2)).ravel())

    want = np.asarray(jax.jit(jax_index)(jnp.asarray(times)))
    assert np.array_equal(want, np.asarray(jax_index(jnp.asarray(times))))  # eager and jitted agree

    with torch.no_grad():
        tden(torch.zeros(len(times), 1, 1, 4), torch.from_numpy(times.copy()), prompt_embeds=torch.zeros(1, 1, 24))
        for t in times[:: max(1, steps // 8)]:
            tden(torch.zeros(1, 1, 1, 4), torch.tensor(t), prompt_embeds=torch.zeros(1, 1, 24))

    assert np.array_equal(seen[0].numpy(), want)
    assert [int(s[0]) for s in seen[1:]] == [int(i) for i in want[:: max(1, steps // 8)]]
    # at t = 1 the ratio lies above the table's last entry (the schedule's
    # sigma_min^2 term), so both sides give 1000, one past the table
    assert want[0] == 1000 and want[-1] == 0 and np.all(np.diff(want) <= 0)


# the auto-encoder and the text encoder


def test_autoencoder_matches_jax():
    cfg = dict(latent_channels=4, block_out_channels=(32, 64), layers_per_block=1)  # noqa: C408
    jvae = skeleton(JaxAutoencoderKL, **cfg)
    sd = random_state(jvae, 18)
    jvae = load_jax(jvae, sd)
    tmodel = tvae.AutoencoderKL(**cfg, device="cpu")
    tmodel.load_state_dict(tvae.from_jax_state_dict(sd, tmodel))
    jae, tae = jsd.AutoEncoder(jvae, scale=0.18215), tsd.AutoEncoder(tmodel, scale=0.18215)

    x = _normal(19, (2, 32, 32, 3))
    key = jnp.asarray(np.uint32([0, 20]))
    noise = np.asarray(jax.random.normal(key, (2, 16, 16, 4)))

    want = call(lambda m, x, k: m.encode(x, k), jae, jnp.asarray(x), key)
    tae._normal = lambda generator, like: torch.from_numpy(noise.copy())  # JAX's draws
    with torch.no_grad():
        got = tae.encode(torch.from_numpy(x))

    assert tuple(got.shape) == (2, 16, 16, 4)
    assert _rel_err(got, want) <= TOL_SOFTMAX  # the encoder's softmax over 256 keys

    z = _normal(21, (1, 4, 4, 4))
    want = decode(jae, jnp.asarray(z))
    with torch.no_grad():
        got = tae.decode(torch.from_numpy(z))

    assert tuple(got.shape) == (1, 8, 8, 3)
    assert _rel_err(got, want) <= TOL


def test_text_encoder_matches_jax():
    cfg = dict(vocab_size=99, hidden=32, layers=2, heads=4, intermediate=64, max_positions=16, act="gelu")  # noqa: C408
    jclip = skeleton(JaxCLIP, **cfg)
    sd = random_state(jclip, 22)
    jclip = load_jax(jclip, sd)
    tmodel = tclip.CLIPTextEncoder(**cfg, device="cpu")
    tmodel.load_state_dict(tclip.from_jax_state_dict(sd, tmodel))

    def tokenizer():
        return SeededTokenizer(99, model_max_length=16, bos=97, eos=98, pad=98, seed=1)

    prompts = ["an astronaut riding a horse", ""]
    jitted = lambda input_ids: call(lambda m, i: m(i), jclip, input_ids)  # noqa: E731
    want = jsd.TextEncoder(jitted, tokenizer())(prompts)
    with torch.no_grad():
        got = tsd.TextEncoder(tmodel, tokenizer())(prompts)

    assert set(got) == {"prompt_embeds"} and tuple(got["prompt_embeds"].shape) == (2, 16, 32)
    assert _rel_err(got["prompt_embeds"], want["prompt_embeds"]) <= TOL


# the weights both ways


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_converter_round_trip(layout):
    jmodel, tmodel, sd = _unet_pair(23, use_linear_projection=LAYOUTS[layout])

    back = convert_unet_state_dict(jmodel, tmodel.state_dict())

    assert set(back) == set(sd)
    for key, value in sd.items():
        assert np.array_equal(np.asarray(back[key]), value), key


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_twin_state_dict_loads_as_it_is(layout):
    from torch_twins.sd_unet import UNet2DConditionTwin

    torch.manual_seed(0)
    cfg = {**SMALL, "use_linear_projection": LAYOUTS[layout]}
    twin = UNet2DConditionTwin(**cfg).eval()
    tmodel = tbackbone.SDUNet(**cfg, device="cpu")
    tmodel.load_state_dict(twin.state_dict())

    z, ctx = _normal(24, (2, 16, 16, 4)), _normal(25, (2, 7, 24))
    t = np.asarray([10.0, 500.0], dtype=np.float32)
    with torch.no_grad():
        want = twin(torch.from_numpy(np.moveaxis(z, -1, 1).copy()), torch.from_numpy(t), torch.from_numpy(ctx))
        got = tmodel(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(ctx))

    assert _rel_err(got, want.movedim(1, -1)) <= TOL_SOFTMAX


# full size, architectures and cards


def _jax_parameters(module) -> int:
    return sum(math.prod(leaf.shape) for leaf in jax.tree.leaves(module) if hasattr(leaf, "shape"))


@pytest.mark.parametrize("card", ["sd_1.5", "sd_2"])
def test_full_size_unet_matches_manifest_and_jax(card):
    unet = tsd.make_backbone(card, device="meta")

    check_manifest(unet.state_dict(), "sd", card, "unet")
    n = sum(p.numel() for p in unet.parameters())
    assert n == {"sd_1.5": 859_520_964, "sd_2": 865_910_724}[card]
    assert n == _jax_parameters(filter_eval_shape(jsd.make_backbone, card))


@pytest.mark.parametrize("card", ["sd_1.5", "sd_2"])
def test_full_size_encoders_match_manifest(card):
    arch = tsd._arch(card)
    clip = tclip.CLIPTextEncoder(**arch["clip"], device="meta")
    vae = tvae.AutoencoderKL(device="meta")

    check_manifest(clip.state_dict(), "sd", card, "text_encoder", tclip.canonicalize_clip_keys)
    check_manifest(vae.state_dict(), "sd", card, "vae", tvae.canonicalize_vae_keys)


def test_archs_and_cards_equal_jax():
    assert tsd.ARCHS == jsd.ARCHS
    assert tsd._arch("sd_2") is tsd.ARCHS["sd2"] and tsd._arch("sd_1.4") is tsd.ARCHS["sd1"]

    cards = load_cards(tsd)
    with open(jsd.__file__.replace("__init__.py", "cards.yaml")) as f:
        jax_cards = yaml.safe_load(f)
    assert set(cards) == set(jax_cards)
    for name, card in cards.items():
        assert card.config == jax_cards[name]["config"] and card.dtype_map == {"default": torch.float16}
    assert cards["sd_2"].config == {"prediction": "velocity"}
