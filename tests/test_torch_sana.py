r"""The PyTorch port's Sana family against the JAX package's, on the CPU: the
linear-attention `SanaTransformer` (with and without the prompt mask, with
the SANA 1.5 q/k norms, patch size 2), `SanaDenoiser` (one call and a DDIM-4
trajectory), the DC-AE (`AutoencoderDC`: both attention branches, both
upsamplers), the `TextEncoder` over a small Gemma and the `AutoEncoder`
wrapper; the weights both ways (JAX -> port by `from_jax_state_dict`, port
-> JAX by `convert_sana_state_dict` and `convert_dcae_state_dict`, exact);
the full-size modules against the port's manifests (meta device); the
architectures and cards.

The small configurations are those of `tests/test_models_sana.py` and
`tests/test_models_dcae.py`. Inputs and weights come from seeded numpy
generators. Tolerances are relative to max |JAX|: 2e-5 where a float32
linear attention divides (every Sana and DC-AE forward), 1e-5 elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process
import yaml

from azula_tpu import noise as jnoise
from azula_tpu.models import sana as jsana
from azula_tpu.models.gemma import Gemma2TextModel as JaxGemma
from azula_tpu.models.sana import autoencoder as jdcae
from azula_tpu.models.sana import backbone as jbackbone
from azula_tpu.models.sana.convert import convert_sana_state_dict
from azula_tpu.models.sd.backbone import sinusoidal_timestep_embedding as jax_timestep_embedding
from azula_tpu.sample import DDIMSampler as JaxDDIM
from azula_tpu.utils.pytree import filter_jit
from azula_tpu_torch import noise as tnoise
from azula_tpu_torch.models import gemma as tgemma
from azula_tpu_torch.models import sana as tsana
from azula_tpu_torch.models.flux.backbone import sinusoidal_timestep_embedding
from azula_tpu_torch.models.sana import autoencoder as tdcae
from azula_tpu_torch.models.sana import backbone as tbackbone
from azula_tpu_torch.models.sana.convert import from_jax_state_dict
from azula_tpu_torch.models.utils import SeededTokenizer, check_manifest, load_cards
from azula_tpu_torch.sample import DDIMSampler as TorchDDIM

from test_torch_vae import _f64, _rel_err, call, decode, load_jax, random_state, skeleton

TOL = 1e-5
TOL_LINEAR = 2e-5

SMALL = dict(  # noqa: C408
    in_channels=8,
    out_channels=8,
    num_attention_heads=4,
    attention_head_dim=8,
    num_cross_attention_heads=2,
    cross_attention_head_dim=16,
    caption_channels=24,
    num_layers=2,
    patch_size=1,
    mlp_ratio=2.5,
)
DCAE = dict(  # noqa: C408
    in_channels=3,
    latent_channels=4,
    block_types=("ResBlock", "EfficientViTBlock"),
    block_out_channels=(8, 16),
    encoder_layers_per_block=(1, 1),
    decoder_layers_per_block=(2, 1),
    qkv_multiscales=((), (5,)),
    head_dim=4,
)
GEMMA = dict(vocab_size=127, dim=24, layers=2, heads=2, kv_heads=1, head_dim=8, intermediate=48, query_pre_attn_scalar=8.0)  # noqa: C408


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _transformer_pair(seed: int, **config):
    cfg = {**SMALL, **config}
    jmodel = skeleton(jbackbone.SanaTransformer, **cfg)
    sd = random_state(jmodel, seed)
    jmodel = load_jax(jmodel, sd)

    tmodel = tbackbone.SanaTransformer(**cfg, device="cpu")
    tmodel.load_state_dict(from_jax_state_dict(sd, tmodel))

    return jmodel, tmodel, sd


def _dcae_pair(seed: int, **config):
    cfg = {**DCAE, **config}
    jmodel = skeleton(jdcae.AutoencoderDC, **cfg)
    sd = random_state(jmodel, seed)
    jmodel = load_jax(jmodel, sd)

    tmodel = tdcae.AutoencoderDC(**cfg, device="cpu")
    tmodel.load_state_dict(tdcae.from_jax_state_dict(sd, tmodel))

    return jmodel, tmodel, sd


def _inputs(seed: int, side: int = 8, masked: bool = True) -> dict[str, np.ndarray]:
    mask = np.ones((2, 6), dtype=np.float32)
    mask[1, 4:] = 0
    return {
        "hidden_states": _normal(seed, (2, side, side, 8)),
        "timestep": np.asarray([125.0, 875.0], dtype=np.float32),
        "encoder_hidden_states": _normal(seed + 1, (2, 6, 24)),
        "encoder_attention_mask": mask if masked else None,
    }


def _as(kind, inputs: dict) -> dict:
    if kind == "jax":
        return {k: None if v is None else jnp.asarray(v) for k, v in inputs.items()}
    return {k: None if v is None else torch.from_numpy(v) for k, v in inputs.items()}


_forward = filter_jit(lambda m, kw: m(**kw))


@pytest.mark.parametrize("case", ["masked", "unmasked", "qk_norm", "patch_2"])
def test_transformer_matches_jax(case):
    config = {"qk_norm": {"qk_norm": True}, "patch_2": {"patch_size": 2}}.get(case, {})
    jmodel, tmodel, _ = _transformer_pair(seed=1, **config)
    inputs = _inputs(2, masked=case != "unmasked")

    want = _forward(jmodel, _as("jax", inputs))
    with torch.no_grad():
        got = tmodel(**_as("torch", inputs))

    assert tuple(got.shape) == (2, 8, 8, 8)
    assert _rel_err(got, want) <= TOL_LINEAR


@pytest.mark.parametrize("kind", ["linear", "cross_masked", "cross", "glumbconv", "caption"])
def test_layers_match_jax(kind):
    build, args = {
        "linear": (lambda m, **kw: m.SanaLinearAttention(32, 4, 8, **kw), [(2, 16, 32)]),
        "cross_masked": (lambda m, **kw: m.SanaCrossAttention(32, 2, 16, **kw), [(2, 16, 32), (2, 6, 32), "mask"]),
        "cross": (lambda m, **kw: m.SanaCrossAttention(32, 2, 16, **kw), [(2, 16, 32), (2, 6, 32)]),
        "glumbconv": (lambda m, **kw: m.GLUMBConv(32, **kw), [(2, 4, 4, 32)]),
        "caption": (lambda m, **kw: m.CaptionProjection(24, 32, **kw), [(2, 6, 24)]),
    }[kind]

    jlayer = skeleton(lambda **kw: build(jbackbone, **kw))
    sd = random_state(jlayer, 3)
    jlayer = load_jax(jlayer, sd)
    tlayer = build(tbackbone, device="cpu")
    tlayer.load_state_dict(from_jax_state_dict(sd, tlayer))

    mask = np.asarray([[1, 1, 1, 1, 1, 1], [1, 1, 1, 0, 0, 0]], dtype=np.float32)
    arrays = [mask if a == "mask" else _normal(4 + i, a) for i, a in enumerate(args)]

    want = call(jlayer, *(jnp.asarray(a) for a in arrays))
    with torch.no_grad():
        got = tlayer(*(torch.from_numpy(a) for a in arrays))

    assert _rel_err(got, want) <= (TOL_LINEAR if kind == "linear" else TOL)


def test_timestep_embedding_is_sd_s():
    # Sana's `sd.backbone.sinusoidal_timestep_embedding(t, 256)` at the
    # denoiser's 1000 c_time, against the port's shared copy
    t = np.asarray([0.0, 1.0, 37.5, 500.0, 999.0, 1000.0], dtype=np.float32)

    want = jax_timestep_embedding(jnp.asarray(t), 256)
    got = sinusoidal_timestep_embedding(torch.from_numpy(t), 256)

    # an ulp of the largest argument: XLA's and PyTorch's float32 exp differ
    assert np.abs(_f64(got) - _f64(want)).max() <= 2 * np.spacing(np.float32(1000))


def _denoisers(seed: int):
    jmodel, tmodel, _ = _transformer_pair(seed)
    return jsana.SanaDenoiser(jmodel), tsana.SanaDenoiser(tmodel)


def _cond(seed: int) -> dict[str, np.ndarray]:
    mask = np.ones((1, 6), dtype=np.float32)
    mask[0, 5] = 0
    return {"prompt_embeds": _normal(seed, (1, 6, 24)), "prompt_mask": mask}


@pytest.mark.parametrize("t", [0.3, "batch"])
def test_denoiser_matches_jax(t):
    jden, tden = _denoisers(5)
    x = _normal(6, (2, 8, 8, 8))
    t = np.float32(0.3) if t == 0.3 else np.asarray([0.2, 0.9], dtype=np.float32)
    cond = _cond(7)

    want = call(lambda d, x, t, c: d(x, t, **c).mean, jden, jnp.asarray(x), jnp.asarray(t), _as("jax", cond))
    with torch.no_grad():
        got = tden(torch.from_numpy(x), torch.as_tensor(t), **_as("torch", cond)).mean

    assert _rel_err(got, want) <= TOL_LINEAR


def test_ddim_trajectory_matches_jax():
    jden, tden = _denoisers(8)
    x1 = _normal(9, (2, 8, 8, 8))
    cond = _cond(10)

    want = call(lambda d, x, c: JaxDDIM(d, eta=0.0, steps=4)(x, **c), jden, jnp.asarray(x1), _as("jax", cond))
    with torch.no_grad():
        got = TorchDDIM(tden, eta=0.0, steps=4)(torch.from_numpy(x1), **_as("torch", cond))

    assert _rel_err(got, want) <= TOL_LINEAR


def test_denoiser_rounds_the_backbone_inputs():
    _, tden = _denoisers(11)
    tden.backbone.to(torch.bfloat16)
    seen = {}

    def spy(**kwargs):
        seen.update({k: v.dtype for k, v in kwargs.items()})
        return kwargs["hidden_states"]

    tden.backbone.forward = spy
    out = tden(torch.zeros(2, 8, 8, 8), torch.tensor(0.5), **_as("torch", _cond(12))).mean

    assert out.dtype == torch.float32 and set(seen.values()) == {torch.bfloat16}
    assert tnoise.DecaySchedule is type(tden.schedule) and jnoise.DecaySchedule is type(jsana.SanaDenoiser(None).schedule)


def test_converter_round_trip():
    jmodel, tmodel, sd = _transformer_pair(13, qk_norm=True)

    back = convert_sana_state_dict(jmodel, tmodel.state_dict())

    assert set(back) == set(sd)
    for key, value in sd.items():
        assert np.array_equal(np.asarray(back[key]), value), key


# DC-AE


@pytest.mark.parametrize("side", [16, 4], ids=["linear", "quadratic"])
def test_dcae_encode_matches_jax(side):
    # at 16 x 16 the attention stage holds 8 x 8 = 64 > d = 4 positions
    # (linear attention); at 4 x 4 it holds 4 <= d (quadratic)
    jmodel, tmodel, _ = _dcae_pair(14)
    x = _normal(15, (2, side, side, 3))

    want = call(lambda m, x: m.encode(x), jmodel, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(x))

    assert tuple(got.shape) == (2, side // 2, side // 2, 4)
    assert _rel_err(got, want) <= TOL_LINEAR


@pytest.mark.parametrize("upsample", ["interpolate", "pixel_shuffle"])
@pytest.mark.parametrize("side", [8, 2], ids=["linear", "quadratic"])
def test_dcae_decode_matches_jax(upsample, side):
    jmodel, tmodel, _ = _dcae_pair(16, upsample_interpolate=upsample == "interpolate")
    z = _normal(17, (2, side, side, 4))

    want = decode(jmodel, jnp.asarray(z))
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z))

    assert tuple(got.shape) == (2, 2 * side, 2 * side, 3)
    assert _rel_err(got, want) <= TOL_LINEAR


def test_dcae_round_trip():
    jmodel, tmodel, sd = _dcae_pair(18, upsample_interpolate=False)

    back = jdcae.convert_dcae_state_dict(jmodel, tmodel.state_dict())

    assert set(back) == set(sd)
    for key, value in sd.items():
        assert np.array_equal(np.asarray(back[key]), value), key


def test_autoencoder_matches_jax():
    jmodel, tmodel, _ = _dcae_pair(19)
    jae, tae = jsana.AutoEncoder(jmodel, scale=0.41407), tsana.AutoEncoder(tmodel, scale=0.41407)
    x = _normal(20, (1, 16, 16, 3))

    want = call(lambda a, x: a.decode(a.encode(x)), jae, jnp.asarray(x))
    with torch.no_grad():
        got = tae.decode(tae.encode(torch.from_numpy(x)))

    assert _rel_err(got, want) <= TOL_LINEAR


# the text encoder


def test_text_encoder_matches_jax():
    jgemma = skeleton(JaxGemma, **GEMMA)
    sd = random_state(jgemma, 21)
    jgemma = load_jax(jgemma, sd)
    tmodel = tgemma.Gemma2TextModel(**GEMMA, device="cpu")
    tmodel.load_state_dict(tgemma.from_jax_state_dict(sd, tmodel))

    def tokenizer():
        return SeededTokenizer(127, model_max_length=8192, bos=2, pad=0, seed=3)

    prompts = ["A red cube on a blue sphere", "  Cat  "]
    # the JAX model jitted, as the encoder would call it op by op
    jitted = lambda ids, attention_mask: call(lambda m, i, a: m(i, attention_mask=a), jgemma, ids, attention_mask)  # noqa: E731
    want = jsana.TextEncoder(jitted, tokenizer(), max_length=20)(prompts)
    with torch.no_grad():
        got = tsana.TextEncoder(tmodel, tokenizer(), max_length=20)(prompts)

    assert tuple(got["prompt_embeds"].shape) == (2, 20, 24) and tuple(got["prompt_mask"].shape) == (2, 20)
    assert np.array_equal(_f64(got["prompt_mask"]), _f64(want["prompt_mask"]))
    assert 0 < float(got["prompt_mask"].sum()) < 40  # the prompts end before the selection does
    assert _rel_err(got["prompt_embeds"], want["prompt_embeds"]) <= TOL


# full size, architectures and cards


@pytest.mark.parametrize("component", ["transformer", "vae"])
def test_full_size_matches_manifest(component):
    if component == "transformer":
        module, n = tbackbone.SanaTransformer(**tsana.ARCHS["1.6b"], device="meta"), 1_604_462_752
    else:
        module, n = tdcae.AutoencoderDC(device="meta"), 312_250_275

    check_manifest(module.state_dict(), "sana", "sana_1.6b_1024", component)
    assert sum(p.numel() for p in module.parameters()) == n


def test_archs_and_cards_equal_jax():
    assert tsana.ARCHS == jsana.ARCHS and tsana.CARD_ARCHS == jsana.CARD_ARCHS

    cards = load_cards(tsana)
    with open(jsana.__file__.replace("__init__.py", "cards.yaml")) as f:
        jax_cards = yaml.safe_load(f)
    assert set(cards) == set(jax_cards) == set(tsana.CARD_ARCHS)
    assert cards["sana_1.6b_1024"].dtype_map == {
        "default": torch.bfloat16, "text_encoder": torch.bfloat16, "vae": torch.float32
    }
