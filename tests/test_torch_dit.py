r"""The PyTorch port's transformer path (`azula_tpu_torch.nn` layers, DiT,
ViT, `Modulated`, `KarrasDenoiser`) against the JAX package's, on the CPU.

The tiny ViT slice draws every weight from a seeded numpy generator, loads it
into JAX with `load_state_dict` and into the port with `from_jax_state_dict`.
The JAX modules scale some initial weights by 1e-2 (AdaLN-Zero, `pos_proj`),
which would leave the comparison little to see; drawn weights exercise every
layer. Tolerances are relative to max |reference| unless stated: float32
matmuls summed in other orders through a few layers.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu import denoise as jdenoise
from azula_tpu import noise as jnoise
from azula_tpu.nn import dit as jdit
from azula_tpu.nn import embedding as jembedding
from azula_tpu.nn import layers as jlayers
from azula_tpu.nn import vit as jvit
from azula_tpu.sample import DDIMSampler as JaxDDIM
from azula_tpu.utils.pytree import filter_jit, load_state_dict, state_dict
from azula_tpu_torch import denoise as tdenoise
from azula_tpu_torch import noise as tnoise
from azula_tpu_torch.nn import dit as tdit
from azula_tpu_torch.nn import embedding as tembedding
from azula_tpu_torch.nn import layers as tlayers
from azula_tpu_torch.nn import vit as tvit
from azula_tpu_torch.nn.convert import from_jax_state_dict
from azula_tpu_torch.sample import DDIMSampler as TorchDDIM

TOL = 1e-4

# the tiny ViT: 8 x 8 x 3 images, patch 2 (16 tokens), 64 channels, 2 blocks of 2 heads
TINY = dict(mod_features=16, hid_channels=64, hid_blocks=2, patch_size=2, attention_heads=2)  # noqa: C408


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# layers


@pytest.mark.parametrize("dim", [-1, (-2, -1)], ids=["last", "last_two"])
@pytest.mark.parametrize("name", ["rms_norm", "layer_norm"])
def test_norms_match_jax(name, dim):
    x = _x((2, 16, 24)) * 3 + 0.5

    want = getattr(jlayers, name)(jnp.asarray(x), dim=dim, eps=1e-5)
    got = getattr(tlayers, name)(torch.from_numpy(x), dim=dim, eps=1e-5)

    assert got.dtype == torch.float32
    assert np.abs(_f64(got) - _f64(want)).max() <= 1e-6 * np.abs(_f64(want)).max()

    # bfloat16 in, float32 inside, bfloat16 out
    xb = torch.from_numpy(x).to(torch.bfloat16)
    module = tlayers.RMSNorm(dim) if name == "rms_norm" else tlayers.LayerNorm(dim)
    out = module(xb)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, getattr(tlayers, name)(xb.float(), dim=dim).to(torch.bfloat16))


@pytest.mark.parametrize("features,omega", [(16, 1e4), (64, 1e2), (384, 1e2)])
def test_sine_encoding_matches_jax(features, omega):
    x = np.linspace(-3, 40, 37, dtype=np.float32).reshape(37, 1)

    want = jlayers.SineEncoding(features, omega=omega)(jnp.asarray(x))
    got = tlayers.SineEncoding(features, omega=omega)(torch.from_numpy(x))

    assert tuple(got.shape) == (37, 1, features) and got.dtype == torch.float32
    # sin / cos of arguments up to 40: one float32 ulp of the argument is
    # ~4e-6, and the two libraries' sin and cos differ by about an ulp
    assert np.abs(_f64(got) - _f64(want)).max() <= 1e-5

    # the frequencies themselves: XLA's linspace, then exp
    got0 = tlayers.sine_encoding(torch.ones(()), features=features, omega=omega)
    want0 = jlayers.sine_encoding(jnp.ones(()), features=features, omega=omega)
    assert np.abs(_f64(got0) - _f64(want0)).max() <= 1e-6

    # a bf16 position is encoded in float32 and rounded once
    half = tlayers.sine_encoding(torch.from_numpy(x).to(torch.bfloat16), features=features, omega=omega)
    assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("patch", [(2, 2), (1, 4), (2,), (2, 1, 2)], ids=["2x2", "1x4", "1d", "3d"])
def test_patchify_matches_jax(patch):
    shape = (2, *(4 * p for p in patch), 3)
    x = _x(shape)

    want = jlayers.Patchify(patch)(jnp.asarray(x))
    got = tlayers.Patchify(patch)(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape)
    assert np.array_equal(_f64(got), _f64(want))

    back = tlayers.Unpatchify(patch)(got)
    assert torch.equal(back, torch.from_numpy(x))
    assert np.array_equal(_f64(back), _f64(jlayers.Unpatchify(patch)(want)))


@pytest.mark.parametrize("name", ["relu2", "swiglu"])
def test_activations_match_jax(name):
    x = _x((2, 5, 12)) * 2

    want = getattr(jlayers, name)(jnp.asarray(x))
    got = getattr(tlayers, name)(torch.from_numpy(x))

    assert tuple(got.shape) == tuple(want.shape)
    assert np.abs(_f64(got) - _f64(want)).max() <= 1e-6 * np.abs(_f64(want)).max()

    module = {"relu2": tlayers.ReLU2, "swiglu": tlayers.SwiGLU}[name]()
    assert torch.equal(module(torch.from_numpy(x)), got)


def test_swiglu_pairs_are_interleaved():
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    assert torch.allclose(tlayers.swiglu(x), torch.tensor([[1.0, 3.0]]) * torch.nn.functional.silu(torch.tensor([[2.0, 4.0]])))


# weights


def _random_state(module, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in state_dict(module).items():
        shape = tuple(leaf.shape)
        if key.endswith("bias"):
            value = 0.2 * rng.standard_normal(shape)
        elif key.endswith("param"):  # DiTAdaZero (a, b, c)
            value = 0.5 * rng.standard_normal(shape)
        else:  # (in, out) linear: 1 / sqrt(fan in)
            value = rng.standard_normal(shape) / math.sqrt(shape[0])
        out[key] = value.astype(np.float32)
    return out


def _load_jax(module, sd):
    return load_state_dict(module, {k: jnp.asarray(v) for k, v in sd.items()})


def _slice_pair(rope: bool, seed: int = 0):
    r"""The same random tiny ViT denoiser in JAX and in the port (on the CPU)."""

    k1, k2 = jax.random.split(jax.random.key(0))
    jbackbone = jembedding.Modulated(jvit.ViT(3, 3, rope=rope, **TINY, key=k1), 16, key=k2)
    sd = _random_state(jbackbone, seed)
    jbackbone = _load_jax(jbackbone, sd)

    tbackbone = tembedding.Modulated(tvit.ViT(3, 3, rope=rope, **TINY, device="cpu"), 16, device="cpu")
    tbackbone.load_state_dict(from_jax_state_dict(sd, tbackbone))

    jd = jdenoise.KarrasDenoiser(jbackbone, jnoise.VPSchedule())
    td = tdenoise.KarrasDenoiser(tbackbone, tnoise.VPSchedule())

    return jd, td


_jax_denoise = filter_jit(lambda d, x, t: d(x, t).mean)


@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
def test_denoiser_matches_jax(rope):
    jd, td = _slice_pair(rope)
    x = _x((2, 8, 8, 3), seed=1)

    for t in (0.2, 0.7):
        want = _jax_denoise(jd, jnp.asarray(x), jnp.float32(t))
        with torch.no_grad():
            got = td(torch.from_numpy(x), torch.tensor(t))

        assert isinstance(got, tdenoise.DiracPosterior)
        assert got.mean.dtype == torch.float32 and tuple(got.mean.shape) == (2, 8, 8, 3)
        assert _rel_err(got.mean, want) <= TOL


@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
def test_ddim_trajectory_matches_jax(rope):
    jd, td = _slice_pair(rope, seed=2)
    x = _x((2, 8, 8, 3), seed=3)

    want = JaxDDIM(jd, steps=4)(jnp.asarray(x))
    with torch.no_grad():
        got = TorchDDIM(td, steps=4)(torch.from_numpy(x))

    # each step carries the backbone's differences on
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 5 * TOL


@pytest.mark.parametrize("activation", ["relu", "relu2", "silu", "swiglu"])
def test_dit_without_modulation_matches_jax(activation):
    # mod_features = 0: DiTAdaZero's (3, C) `param` crosses as it is; pos = None
    # falls back to the sequence indices
    kwargs = dict(hid_channels=64, hid_blocks=1, attention_heads=2, ffn_activation=activation)  # noqa: C408
    jbackbone = jdit.DiT(5, 7, key=jax.random.key(1), **kwargs)
    sd = _random_state(jbackbone, 4)
    assert "blocks.0.ada_zero.param" in sd
    jbackbone = _load_jax(jbackbone, sd)

    tbackbone = tdit.DiT(5, 7, device="cpu", **kwargs)
    tbackbone.load_state_dict(from_jax_state_dict(sd, tbackbone))

    x = _x((2, 12, 5), seed=5)
    want = jbackbone(jnp.asarray(x))
    with torch.no_grad():
        got = tbackbone(torch.from_numpy(x))

    assert tuple(got.shape) == (2, 12, 7)
    assert _rel_err(got, want) <= TOL


def test_checkpointing_keeps_output_and_gradients():
    block = tdit.DiTBlock(32, mod_features=8, attention_heads=2, device="cpu")
    x = torch.from_numpy(_x((2, 6, 32))).requires_grad_()
    mod = torch.from_numpy(_x((2, 8), seed=1))

    want = block(x, mod)
    (grad,) = torch.autograd.grad(want.square().sum(), x)

    block.checkpointing = True
    got = block(x, mod)
    (grad_ckpt,) = torch.autograd.grad(got.square().sum(), x)

    assert torch.equal(got, want)
    assert torch.allclose(grad_ckpt, grad, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert torch.equal(block(x, mod), want)


def test_converter_is_strict():
    jbackbone = jembedding.Modulated(jvit.ViT(3, 3, rope=True, **TINY, key=jax.random.key(0)), 16, key=jax.random.key(1))
    tbackbone = tembedding.Modulated(tvit.ViT(3, 3, rope=True, **TINY, device="cpu"), 16, device="cpu")
    sd = _random_state(jbackbone, 0)

    converted = from_jax_state_dict(sd, tbackbone)
    assert set(converted) == set(tbackbone.state_dict())
    assert tuple(converted["backbone.blocks.1.msa.qkv_proj.weight"].shape) == (192, 64)
    assert tuple(converted["backbone.blocks.0.msa.theta_proj.weight"].shape) == (32, 2)
    assert np.array_equal(converted["time_embedding.lin1.weight"].numpy(), sd["time_embedding.lin1.weight"].T)

    missing = dict(sd)
    del missing["backbone.blocks.1.ffn2.bias"]
    with pytest.raises(KeyError):
        from_jax_state_dict(missing, tbackbone)

    extra = dict(sd, **{"backbone.blocks.1.extra.weight": np.zeros((3, 3), np.float32)})
    with pytest.raises(KeyError):
        from_jax_state_dict(extra, tbackbone)

    with pytest.raises(KeyError):
        from_jax_state_dict({"backbone.blocks.0.norm.eps": np.zeros(1, np.float32)})

    wrong = dict(sd, **{"backbone.in_proj.bias": np.zeros(7, np.float32)})
    with pytest.raises(ValueError):
        from_jax_state_dict(wrong, tbackbone)


def test_vit_positions_keep_the_dtype():
    vit = tvit.ViT(3, 3, **TINY, device="cpu").to(torch.bfloat16)
    seen = []
    vit.blocks[0].msa.register_forward_pre_hook(lambda m, args: seen.append(args[1]))

    with torch.no_grad():
        y = vit(torch.zeros((1, 8, 8, 3), dtype=torch.bfloat16), torch.zeros((1, 16), dtype=torch.bfloat16))

    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 8, 8, 3)
    (pos,) = seen
    assert pos.dtype == torch.bfloat16 and tuple(pos.shape) == (16, 2)
    assert pos[5].tolist() == [1.0, 1.0]


def test_modules_default_to_the_card():
    if torch.cuda.is_available():
        vit = tvit.ViT(3, 3, **TINY)
        assert next(vit.parameters()).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tvit.ViT(3, 3, **TINY)
