r"""The PyTorch port's text encoders against the JAX package's, on the CPU:
CLIP (`models/clip.py`, quick-GELU and GELU), T5 (`models/t5.py`: the
relative-position buckets at L = 512, the unscaled logits under the bias),
Gemma 2 (`models/gemma.py`: a sliding window shorter than L, a soft cap
that clips, a padding mask), Flux's `TextEncoder` and `AutoEncoder`; the
weights both ways (JAX -> port by each `from_jax_state_dict`, port -> JAX by
the JAX package's `convert_*_state_dict`, exact), and the full-size modules
against the port's manifests, built on the meta device.

Inputs and weights come from seeded numpy generators; weights at ordinary
scale (1 / sqrt(fan in), embedding tables at 1), as a T5 that scaled its
logits or added its bias in float32 would not pass with tiny weights
otherwise. The tokenizers are `SeededTokenizer` stand-ins. Tolerances are
relative to max |JAX|: float32 1e-5, 2e-5 where a softmax sums 64 or more
keys (T5 at L = 64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu.models import clip as jclip
from azula_tpu.models import flux as jflux
from azula_tpu.models import gemma as jgemma
from azula_tpu.models import t5 as jt5
from azula_tpu.models.autoencoder import AutoencoderKL as JaxAutoencoderKL
from azula_tpu_torch.models import clip as tclip
from azula_tpu_torch.models import flux as tflux
from azula_tpu_torch.models import gemma as tgemma
from azula_tpu_torch.models import t5 as tt5
from azula_tpu_torch.models.autoencoder import AutoencoderKL as TorchAutoencoderKL
from azula_tpu_torch.models.autoencoder import from_jax_state_dict as vae_from_jax
from azula_tpu_torch.models.utils import SeededTokenizer, check_manifest

from test_torch_vae import _rel_err, call, decode, load_jax, random_state, skeleton

TOL = 1e-5
TOL_SOFTMAX = 2e-5

CLIP = {
    "quick_gelu": dict(vocab_size=99, hidden=32, layers=2, heads=4, intermediate=64, max_positions=16, act="quick_gelu"),  # noqa: C408
    "gelu": dict(vocab_size=99, hidden=48, layers=3, heads=6, intermediate=96, max_positions=16, act="gelu"),  # noqa: C408
}
T5 = dict(vocab_size=99, dim=32, heads=4, head_dim=8, ff_dim=64, layers=3)  # noqa: C408
GEMMA = dict(  # noqa: C408  a window shorter than L = 12, a cap that clips
    vocab_size=127,
    dim=32,
    layers=3,
    heads=4,
    kv_heads=2,
    head_dim=8,
    intermediate=64,
    query_pre_attn_scalar=8.0,
    attn_logit_softcapping=1.5,
    sliding_window=5,
)


def _pair(jcls, tmodule, config, seed):
    jmodel = skeleton(jcls, **config)
    sd = random_state(jmodel, seed)
    jmodel = load_jax(jmodel, sd)

    tmodel = getattr(tmodule, jcls.__name__)(**config, device="cpu")
    tmodel.load_state_dict(tmodule.from_jax_state_dict(sd, tmodel))

    return jmodel, tmodel, sd


def _ids(seed: int, shape, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _round_trip(convert, jmodel, tmodel, sd):
    back = convert(jmodel, tmodel.state_dict())

    assert set(back) == set(sd)
    for key, value in sd.items():
        assert np.array_equal(np.asarray(back[key]), value), key


# CLIP


@pytest.mark.parametrize("name", list(CLIP))
def test_clip_matches_jax(name):
    jmodel, tmodel, _ = _pair(jclip.CLIPTextEncoder, tclip, CLIP[name], seed=1)
    ids = _ids(2, (2, 16), 99)

    want = call(jmodel, jnp.asarray(ids))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids))

    assert tuple(got.shape) == (2, 16, CLIP[name]["hidden"])
    assert _rel_err(got, want) <= TOL


def test_clip_round_trip():
    _round_trip(jclip.convert_clip_state_dict, *_pair(jclip.CLIPTextEncoder, tclip, CLIP["gelu"], seed=3))


def test_clip_causal_mask():
    # the first token's state does not depend on the later tokens
    _, tmodel, _ = _pair(jclip.CLIPTextEncoder, tclip, CLIP["quick_gelu"], seed=4)
    ids = _ids(5, (2, 16), 99)
    ids[1, 0] = ids[0, 0]

    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids))

    assert torch.allclose(out[0, 0], out[1, 0], atol=1e-6) and not torch.allclose(out[0, 1:], out[1, 1:])


# T5


def test_relative_position_bucket_matches_jax():
    pos = np.arange(512)
    relative = pos[None, :] - pos[:, None]

    got = tt5.relative_position_bucket(relative)
    want = jt5.relative_position_bucket(relative)

    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.min() == 0 and got.max() == 31


@pytest.mark.parametrize("L", [12, 64])
def test_t5_matches_jax(L):
    jmodel, tmodel, _ = _pair(jt5.T5Encoder, tt5, T5, seed=7)
    ids = _ids(8, (2, L), 99)

    want = call(jmodel, jnp.asarray(ids))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids))

    assert tuple(got.shape) == (2, L, 32)
    assert _rel_err(got, want) <= (TOL if L < 64 else TOL_SOFTMAX)


def test_t5_logits_are_not_scaled():
    # the first block's attention at ordinary scale: unscaled logits plus
    # the bias, against the same block computed with 1 / sqrt(d) (a port
    # that scaled would be this far off)
    _, tmodel, _ = _pair(jt5.T5Encoder, tt5, T5, seed=9)
    block = tmodel.blocks[0]
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((1, 12, 32)).astype(np.float32))
    bias = torch.zeros(1, 4, 12, 12)

    with torch.no_grad():
        got = block.attn(x, bias)
        q = block.attn.q(x).reshape(1, 12, 4, 8).transpose(1, 2)
        k = block.attn.k(x).reshape(1, 12, 4, 8).transpose(1, 2)
        v = block.attn.v(x).reshape(1, 12, 4, 8).transpose(1, 2)
        scaled = torch.softmax(q @ k.transpose(-1, -2) / 8**0.5, dim=-1) @ v
        scaled = block.attn.o(scaled.transpose(1, 2).reshape(1, 12, 32))

    assert _rel_err(scaled, got) > 1e-2


def test_t5_round_trip():
    _round_trip(jt5.convert_t5_state_dict, *_pair(jt5.T5Encoder, tt5, T5, seed=11))


# Gemma 2


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "padded"])
def test_gemma_matches_jax(masked):
    jmodel, tmodel, _ = _pair(jgemma.Gemma2TextModel, tgemma, GEMMA, seed=12)
    ids = _ids(13, (2, 12), 127)
    mask = np.ones((2, 12), dtype=np.int64)
    if masked:
        mask[1, 7:] = 0

    want = call(lambda m, i, a: m(i, attention_mask=a), jmodel, jnp.asarray(ids), jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask) if masked else None)

    assert tuple(got.shape) == (2, 12, 32)
    assert _rel_err(got, want) <= TOL


def test_gemma_window_and_cap_bite():
    # the small configuration's window and soft cap change the output
    _, tmodel, sd = _pair(jgemma.Gemma2TextModel, tgemma, GEMMA, seed=14)
    ids = torch.from_numpy(_ids(15, (1, 12), 127))

    with torch.no_grad():
        base = tmodel(ids)
        for change in ({"sliding_window": 64}, {"attn_logit_softcapping": None}):
            other = tgemma.Gemma2TextModel(**{**GEMMA, **change}, device="cpu")
            other.load_state_dict(tmodel.state_dict())
            assert _rel_err(other(ids), base) > 1e-3, change


def test_gemma_round_trip():
    _round_trip(jgemma.convert_gemma_state_dict, *_pair(jgemma.Gemma2TextModel, tgemma, GEMMA, seed=16))


# Flux's text encoder and auto-encoder


def _tokenizers():
    clip = SeededTokenizer(99, model_max_length=16, bos=97, eos=98, pad=98, seed=1)
    t5 = SeededTokenizer(99, model_max_length=512, eos=1, pad=0, seed=2)
    return clip, t5


def test_flux_text_encoder_matches_jax():
    jc, tc, _ = _pair(jclip.CLIPTextEncoder, tclip, CLIP["quick_gelu"], seed=17)
    jt, tt, _ = _pair(jt5.T5Encoder, tt5, T5, seed=18)
    prompts = ["a photograph of an astronaut riding a horse", "a cat"]

    # the JAX models jitted, as the encoder would call them op by op
    clip, t5 = (lambda input_ids, m=m: call(m, jnp.asarray(input_ids)) for m in (jc, jt))
    want = jflux.TextEncoder(clip, _tokenizers()[0], t5, _tokenizers()[1], max_length=24)(prompts)
    with torch.no_grad():
        got = tflux.TextEncoder(tc, _tokenizers()[0], tt, _tokenizers()[1], max_length=24)(prompts)

    assert tuple(got["prompt_clip"].shape) == (2, 32) and tuple(got["prompt_t5"].shape) == (2, 24, 32)
    assert _rel_err(got["prompt_clip"], want["prompt_clip"]) <= TOL
    assert _rel_err(got["prompt_t5"], want["prompt_t5"]) <= TOL


def test_seeded_tokenizer():
    tok = SeededTokenizer(49408, model_max_length=77, bos=49406, eos=49407, pad=49407)
    a = tok(["a cat", "a photograph of an astronaut"], truncation=True, max_length=77, padding="max_length")

    assert a.input_ids.shape == (2, 77) and a.attention_mask.shape == (2, 77)
    assert np.array_equal(a.input_ids, tok(["a cat", "a photograph of an astronaut"], padding="max_length").input_ids)
    assert (a.input_ids[:, 0] == 49406).all() and (a.input_ids.argmax(-1) == a.attention_mask.sum(-1) - 1).all()
    assert a.input_ids[0, 1:3].max() < 49406
    assert len(tok.encode("x" * 40)) == 12 and len(tok.encode("x" * 40, add_special_tokens=False)) == 10


def _autoencoder_pair(seed):
    cfg = dict(latent_channels=4, block_out_channels=(32, 64), layers_per_block=1, use_quant_conv=False)  # noqa: C408
    jvae = skeleton(JaxAutoencoderKL, **cfg)
    sd = random_state(jvae, seed)
    jvae = load_jax(jvae, sd)
    tvae = TorchAutoencoderKL(**cfg, device="cpu")
    tvae.load_state_dict(vae_from_jax(sd, tvae))
    return jflux.AutoEncoder(jvae, shift=0.1159, scale=0.3611), tflux.AutoEncoder(tvae, shift=0.1159, scale=0.3611)


def test_flux_autoencoder_matches_jax():
    jae, tae = _autoencoder_pair(seed=19)
    x = np.random.default_rng(20).standard_normal((2, 32, 32, 3)).astype(np.float32)
    key = jnp.asarray(np.uint32([0, 21]))
    noise = np.asarray(jax.random.normal(key, (2, 16, 16, 4)))

    want = call(lambda m, x, k: m.encode(x, k), jae, jnp.asarray(x), key)
    tae._normal = lambda generator, like: torch.from_numpy(noise.copy())  # JAX's draws
    with torch.no_grad():
        got = tae.encode(torch.from_numpy(x))

    assert tuple(got.shape) == (2, 8, 8, 16)
    assert _rel_err(got, want) <= 2e-5  # the encoder's softmax over 256 keys

    z = np.random.default_rng(22).standard_normal((1, 4, 4, 16)).astype(np.float32)
    want = decode(jae, jnp.asarray(z))
    with torch.no_grad():
        got = tae.decode(torch.from_numpy(z))

    assert tuple(got.shape) == (1, 16, 16, 3)
    assert _rel_err(got, want) <= TOL


def test_flux_autoencoder_packs_and_unpacks():
    _, tae = _autoencoder_pair(seed=23)
    tae.vae.decode = lambda z: z  # the packing alone
    tae.vae.encode = lambda x: (x, torch.zeros_like(x))
    z = torch.randn(2, 6, 8, 4, generator=torch.Generator().manual_seed(0))

    packed = tae.encode(z)
    assert tuple(packed.shape) == (2, 3, 4, 16)
    assert torch.allclose(tae.decode(packed), z, atol=1e-6)


# full-size modules against the port's manifests (meta device)


@pytest.mark.parametrize(
    "name",
    ["flux_1_dev.text_encoder", "flux_1_dev.text_encoder_2", "flux_1_dev.transformer", "sana_1.6b_1024.text_encoder"],
)
def test_full_size_matches_manifest(name):
    card, component = name.rsplit(".", 1)
    module, canonicalize, n = {
        "flux_1_dev.text_encoder": (tclip.CLIPTextEncoder, tclip.canonicalize_clip_keys, 123_060_480),
        "flux_1_dev.text_encoder_2": (tt5.T5Encoder, tt5.canonicalize_t5_keys, 4_762_310_656),
        "flux_1_dev.transformer": (tflux.FluxTransformer, None, 11_901_408_320),
        "sana_1.6b_1024.text_encoder": (tgemma.Gemma2TextModel, tgemma.canonicalize_gemma_keys, 2_614_341_888),
    }[name]
    model = module(device="meta")

    check_manifest(model.state_dict(), "flux" if card.startswith("flux") else "sana", card, component, canonicalize)
    assert sum(p.numel() for p in model.parameters()) == n


@pytest.mark.parametrize("canonicalize", ["clip", "t5", "gemma"])
def test_canonicalize_equals_jax(canonicalize):
    names = {
        "clip": ["text_model.embeddings.token_embedding.weight", "text_model.encoder.layers.3.mlp.fc1.bias",
                 "text_model.final_layer_norm.weight", "text_model.embeddings.position_ids"],
        "t5": ["shared.weight", "encoder.embed_tokens.weight", "encoder.block.0.layer.0.SelfAttention.q.weight",
               "encoder.block.2.layer.1.DenseReluDense.wi_0.weight", "encoder.final_layer_norm.weight"],
        "gemma": ["model.embed_tokens.weight", "model.layers.11.self_attn.q_proj.weight", "model.norm.weight"],
    }[canonicalize]
    port = {"clip": tclip, "t5": tt5, "gemma": tgemma}[canonicalize]
    jax_module = {"clip": jclip, "t5": jt5, "gemma": jgemma}[canonicalize]
    fn = f"canonicalize_{canonicalize}_keys"

    sd = dict.fromkeys(names)
    assert getattr(port, fn)(sd) == getattr(jax_module, fn)(sd)
