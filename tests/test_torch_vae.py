r"""The PyTorch port's `AutoencoderKL` (`azula_tpu_torch.models.autoencoder`)
against the JAX package's, on the CPU: encode and decode with and without
the quant convolutions, each block kind, the GroupNorm calls of a decode,
the weights both ways (JAX -> port by `from_jax_state_dict`, port -> JAX by
the JAX package's `convert_vae_state_dict`), the full-size FLUX.1 VAE
against the port's manifest, and `check_manifest`'s named diffs.

The small configuration is that of `tests/test_models_vae.py`: channels
(32, 64), one resnet a level, 32x32 images. Inputs and weights come from
seeded numpy generators; weights at ordinary scale (1 / sqrt(fan in)).
Tolerances are relative to max |JAX|: float32 1e-5 (the same arithmetic in
another order), 2e-5 where the mid-block softmax sums 64 or more keys.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import re
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu.models import autoencoder as jvae
from azula_tpu.utils.pytree import filter_eval_shape, filter_jit, load_state_dict, state_dict
from azula_tpu_torch.models import autoencoder as tvae
from azula_tpu_torch.models.utils import check_manifest
from azula_tpu_torch.ops import norm

SMALL = dict(in_channels=3, latent_channels=4, block_out_channels=(32, 64), layers_per_block=1)  # noqa: C408

TOL = 1e-5
TOL_SOFTMAX = 2e-5


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def random_state(module, seed: int, tables: float = 1.0) -> dict[str, np.ndarray]:
    r"""Random float32 arrays for every leaf of a JAX model-zoo module:
    norm scales about 1, biases and scale-shift tables at 0.2, Linear and
    convolution weights (fan-in first) at 1 / sqrt(fan in), other arrays
    (embedding tables) at `tables`."""

    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in state_dict(module).items():
        shape = tuple(leaf.shape)
        leaf_name = key.rpartition(".")[2]
        if leaf_name == "scale":
            value = 1 + 0.2 * rng.standard_normal(shape)
        elif leaf_name in ("bias", "scale_shift_table"):
            value = 0.2 * rng.standard_normal(shape)
        elif leaf_name == "weight":
            value = rng.standard_normal(shape) / math.sqrt(math.prod(shape[:-1]))
        else:
            value = tables * rng.standard_normal(shape)
        out[key] = value.astype(np.float32)
    return out


# the JAX forwards, jitted: one compilation each instead of one per operation
call = filter_jit(lambda f, *args: f(*args))
encode = filter_jit(lambda m, x: m.encode(x))
decode = filter_jit(lambda m, z: m.decode(z))


def skeleton(cls, *args, **kwargs):
    r"""A JAX module built abstractly (no initial values drawn)."""

    return filter_eval_shape(cls, *args, **kwargs, key=jax.random.key(0))


def load_jax(module, sd):
    return load_state_dict(module, {k: jnp.asarray(v) for k, v in sd.items()})


def _vae_pair(seed: int = 0, **config):
    cfg = {**SMALL, **config}
    jmodel = skeleton(jvae.AutoencoderKL, **cfg)
    sd = random_state(jmodel, seed)
    jmodel = load_jax(jmodel, sd)

    tmodel = tvae.AutoencoderKL(**cfg, device="cpu")
    tmodel.load_state_dict(tvae.from_jax_state_dict(sd, tmodel))

    return jmodel, tmodel, sd


def _images(seed: int, shape=(2, 32, 32, 3)) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("quant", [True, False], ids=["sd", "flux"])
def test_encode_matches_jax(quant):
    jmodel, tmodel, _ = _vae_pair(seed=1, use_quant_conv=quant)
    x = _images(2)

    want_mean, want_std = encode(jmodel, jnp.asarray(x))
    with torch.no_grad():
        mean, std = tmodel.encode(torch.from_numpy(x))

    assert tuple(mean.shape) == (2, 16, 16, 4) and mean.dtype == torch.float32
    # the encoder's mid block attends over 16 x 16 = 256 keys
    assert _rel_err(mean, want_mean) <= TOL_SOFTMAX
    assert _rel_err(std, want_std) <= TOL_SOFTMAX


@pytest.mark.parametrize("quant", [True, False], ids=["sd", "flux"])
def test_decode_matches_jax(quant):
    jmodel, tmodel, _ = _vae_pair(seed=3, use_quant_conv=quant)
    z = _images(4, (2, 8, 8, 4))

    want = decode(jmodel, jnp.asarray(z))
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z))

    assert tuple(got.shape) == (2, 16, 16, 3)
    assert _rel_err(got, want) <= TOL_SOFTMAX


@pytest.mark.parametrize("kind", ["resnet", "resnet_shortcut", "attention", "down", "up"])
def test_blocks_match_jax(kind):
    C = 32
    build, shape = {
        "resnet": (lambda m, **kw: m.VAEResnetBlock(C, C, **kw), (2, 8, 8, C)),
        "resnet_shortcut": (lambda m, **kw: m.VAEResnetBlock(C, 2 * C, **kw), (2, 8, 8, C)),
        "attention": (lambda m, **kw: m.VAEAttention(C, **kw), (2, 8, 8, C)),
        "down": (lambda m, **kw: m.VAEDownBlock(C, C, 1, True, **kw), (2, 9, 8, C)),
        "up": (lambda m, **kw: m.VAEUpBlock(C, C, 1, True, **kw), (2, 5, 4, C)),
    }[kind]

    jblock = skeleton(lambda **kw: build(jvae, **kw))
    sd = random_state(jblock, seed=5)
    jblock = load_jax(jblock, sd)
    tblock = build(tvae, device="cpu")
    tblock.load_state_dict(tvae.from_jax_state_dict(sd, tblock))

    x = _images(6, shape)
    want = call(jblock, jnp.asarray(x))
    with torch.no_grad():
        got = tblock(torch.from_numpy(x))

    assert tuple(got.shape) == tuple(want.shape)
    assert _rel_err(got, want) <= TOL


def test_decode_group_norms_are_plain_group_norm(monkeypatch):
    # every GroupNorm of a decode goes through `group_norm` (the kernel on
    # the card), none through `group_norm_silu`: the mid block's 5, two per
    # resnet of each up block, and `conv_norm_out`
    _, tmodel, _ = _vae_pair(seed=7, use_quant_conv=False)
    calls = []
    plain = norm._gn_forward

    def spy(x, P, Q, groups, eps, silu, implementation):
        calls.append((tuple(x.shape), groups, eps, silu))
        return plain(x, P, Q, groups, eps, silu, implementation)

    monkeypatch.setattr(norm, "_gn_forward", spy)
    with torch.no_grad():
        tmodel.decode(torch.from_numpy(_images(8, (1, 8, 8, 4))))

    layers = SMALL["layers_per_block"] + 1
    assert len(calls) == 5 + len(SMALL["block_out_channels"]) * layers * 2 + 1
    assert all(groups == 32 and eps == 1e-6 and not silu for _, groups, eps, silu in calls)


def test_converter_round_trip():
    jmodel, tmodel, sd = _vae_pair(seed=9, use_quant_conv=True)

    back = jvae.convert_vae_state_dict(jmodel, tmodel.state_dict())

    assert set(back) == set(sd)
    for key, value in sd.items():
        assert np.array_equal(np.asarray(back[key]), value), key


def test_canonicalize_maps_checkpoint_names():
    names = {
        "encoder.down_blocks.0.downsamplers.0.conv.weight": "encoder.down_blocks.0.downsamplers.0.weight",
        "decoder.up_blocks.0.upsamplers.0.conv.bias": "decoder.up_blocks.0.upsamplers.0.bias",
        "decoder.mid_block.attentions.0.query.weight": "decoder.mid_block.attentions.0.to_q.weight",
        "decoder.mid_block.attentions.0.proj_attn.bias": "decoder.mid_block.attentions.0.to_out.0.bias",
        "decoder.mid_block.attentions.0.to_out.0.bias": "decoder.mid_block.attentions.0.to_out.0.bias",
    }
    assert tvae.canonicalize_vae_keys(dict.fromkeys(names)) == dict.fromkeys(names.values())
    assert tvae.canonicalize_vae_keys(dict.fromkeys(names)) == jvae.canonicalize_vae_keys(dict.fromkeys(names))


def test_flux_vae_matches_manifest():
    vae = tvae.AutoencoderKL(latent_channels=16, use_quant_conv=False, device="meta")

    check_manifest(vae.state_dict(), "flux", "flux_1_dev", "vae", canonicalize=tvae.canonicalize_vae_keys)
    assert sum(p.numel() for p in vae.parameters()) == 83_819_683


@pytest.mark.parametrize("fault", ["dropped", "misshaped", "extra"])
def test_check_manifest_names_the_fault(fault):
    vae = tvae.AutoencoderKL(latent_channels=16, use_quant_conv=False, device="meta")
    sd = dict(vae.state_dict())

    key = "decoder.up_blocks.1.resnets.0.conv1.weight"
    if fault == "dropped":
        del sd[key]
    elif fault == "misshaped":
        sd[key] = torch.empty((512, 512, 1, 3), device="meta")
    else:
        sd["decoder.up_blocks.9.weight"] = torch.empty(3, device="meta")

    want = {"dropped": "missing keys (1)", "misshaped": "shape mismatches (1)", "extra": "unexpected keys (1)"}[fault]
    with pytest.raises(ValueError, match=r"flux/flux_1_dev' vae manifest[\s\S]*" + re.escape(want)):
        check_manifest(sd, "flux", "flux_1_dev", "vae", canonicalize=tvae.canonicalize_vae_keys)


def test_check_manifest_tolerates_trailing_singletons_and_absent_manifests():
    vae = tvae.AutoencoderKL(latent_channels=16, use_quant_conv=False, device="meta")
    sd = dict(vae.state_dict())
    key = "decoder.mid_block.attentions.0.to_q.weight"
    sd[key] = torch.empty((512, 512, 1, 1), device="meta")  # a 1x1 conv stored for a Linear

    check_manifest(sd, "flux", "flux_1_dev", "vae", canonicalize=tvae.canonicalize_vae_keys)
    check_manifest({}, "flux", "no_such_card", "vae")

