r"""The PyTorch port's UNet path (`azula_tpu_torch.nn` convolutions,
`Upsample`, `AdaZero`, `UNetBlock`, `UNet`, the tiny
`KarrasDenoiser(Modulated(UNet))` and its training) against the JAX
package's, on the CPU.

Weights are drawn from seeded numpy generators, loaded into JAX with
`load_state_dict` and into the port with `from_jax_state_dict`: the JAX
modules scale some initial weights by 1e-2 (AdaLN-Zero), which would leave
the comparison little to see. Tolerances are relative to max |reference|:
1e-5 for outputs (float32 convolutions and matmuls summed in other orders
through a few layers), 1e-4 for gradients (the same, through the backward),
and five times the output's for a trajectory, whose steps carry the
differences on.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import optax
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu import denoise as jdenoise
from azula_tpu import noise as jnoise
from azula_tpu.nn import embedding as jembedding
from azula_tpu.nn import layers as jlayers
from azula_tpu.nn import unet as junet
from azula_tpu.sample import DDIMSampler as JaxDDIM
from azula_tpu.utils.pytree import combine, filter_eval_shape, filter_jit, load_state_dict, partition, state_dict
from azula_tpu_torch import denoise as tdenoise
from azula_tpu_torch import noise as tnoise
from azula_tpu_torch import train as ttrain
from azula_tpu_torch.nn import embedding as tembedding
from azula_tpu_torch.nn import layers as tlayers
from azula_tpu_torch.nn import unet as tunet
from azula_tpu_torch.nn.convert import from_jax_state_dict
from azula_tpu_torch.ops import _build
from azula_tpu_torch.sample import DDIMSampler as TorchDDIM

TOL = 1e-5
TOL_GRAD = 1e-4

# the tiny UNet of chip_smoke.py's slice: two depths of 16 and 32 channels,
# one block each, 16 modulating features
TINY = dict(mod_features=16, hid_channels=(16, 32), hid_blocks=(1, 1))  # noqa: C408


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _random_state(module, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in state_dict(module).items():
        shape = tuple(leaf.shape)
        if key.endswith("bias"):
            value = 0.2 * rng.standard_normal(shape)
        elif key.endswith("param"):  # AdaZero (a, b, c)
            value = 0.5 * rng.standard_normal(shape)
        else:  # (*k, in, out) or (in, out): 1 / sqrt(fan in)
            value = rng.standard_normal(shape) / math.sqrt(math.prod(shape[:-1]))
        out[key] = value.astype(np.float32)
    return out


def _load_jax(module, sd):
    return load_state_dict(module, {k: jnp.asarray(v) for k, v in sd.items()})


def _skeleton(cls, *args, **kwargs):
    r"""A JAX module built abstractly: `_pair` draws every leaf of it."""

    return filter_eval_shape(cls, *args, **kwargs, key=jax.random.key(0))


_jax_call = filter_jit(lambda module, *args, **kwargs: module(*args, **kwargs))


def _pair(jmodule, tmodule, seed):
    sd = _random_state(jmodule, seed)
    # the converter takes the leaves of submodules: a lone layer's go under "m."
    converted = from_jax_state_dict({f"m.{k}": v for k, v in sd.items()})
    tmodule.load_state_dict({k[2:]: v for k, v in converted.items()})
    return _load_jax(jmodule, sd), tmodule


# layers


@pytest.mark.parametrize(
    "spatial, padding, periodic",
    [
        (1, ((1, 1),), False),
        (1, ((2, 1),), True),
        (2, ((1, 1), (1, 1)), False),
        (2, ((0, 2), (1, 0)), False),
        (2, ((1, 1), (2, 2)), True),
        (3, ((1, 1),) * 3, False),
        (3, ((1, 0), (1, 1), (0, 1)), True),
    ],
)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_matches_jax(spatial, padding, periodic, stride):
    kernel = (3, 4, 3)[:spatial]
    kwargs = dict(kernel_size=kernel, stride=(stride,) * spatial, padding=padding, periodic=periodic)  # noqa: C408
    jconv, tconv = _pair(
        _skeleton(jlayers.Conv, 5, 6, **kwargs), tlayers.Conv(5, 6, **kwargs, device="cpu"), 1
    )

    x = _x((2, *(9, 8, 7)[:spatial], 5), seed=2)
    want = jconv(jnp.asarray(x))
    got = tconv(torch.from_numpy(x))

    assert tuple(got.shape) == want.shape
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("channels", [(4, 6), (6, 4)])
def test_identity_init_matches_jax(channels):
    jconv, tconv = _pair(
        _skeleton(jlayers.Conv, *channels, kernel_size=(3, 3)),
        tlayers.Conv(*channels, kernel_size=(3, 3), device="cpu"),
        3,
    )
    jconv.identity_init_()
    tconv.identity_init_()

    want = np.asarray(jconv.weight)
    got = tconv.weight.detach().numpy()
    assert np.array_equal(np.moveaxis(got, (0, 1), (-1, -2)), want)


def test_convnd_and_upsample():
    linear = tlayers.ConvNd(5, 7, spatial=0, device="cpu")
    assert isinstance(linear, tlayers.Linear) and tuple(linear.weight.shape) == (7, 5)

    conv = tlayers.ConvNd(5, 7, spatial=2, kernel_size=3, stride=2, padding=1, device="cpu")
    assert conv.stride == (2, 2) and conv.padding == ((1, 1), (1, 1))

    x = _x((2, 3, 5, 4), seed=4)
    want = jlayers.Upsample((2, 3))(jnp.asarray(x))
    got = tlayers.Upsample((2, 3))(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 6, 15, 4)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mod_features", [0, 8])
@pytest.mark.parametrize("spatial", [1, 2])
def test_ada_zero_matches_jax(mod_features, spatial):
    jada, tada = _pair(
        _skeleton(junet.AdaZero, mod_features, 12), tunet.AdaZero(mod_features, 12, device="cpu"), 5
    )
    mod = _x((3, mod_features), seed=6) if mod_features else None

    want = jada(None if mod is None else jnp.asarray(mod), spatial)
    got = tada(None if mod is None else torch.from_numpy(mod), spatial)

    for a, b in zip(got, want, strict=True):
        assert tuple(a.shape) == b.shape
        assert _rel_err(a, b) <= TOL


# blocks


@pytest.mark.parametrize("norm", ["layer", "rms", "group"])
def test_unet_block_matches_jax(norm):
    kwargs = dict(mod_features=8, norm=norm, groups=4, ffn_factor=2, kernel_size=(3, 3), padding=((1, 1), (1, 1)))  # noqa: C408
    jblock, tblock = _pair(
        _skeleton(junet.UNetBlock, 16, **kwargs), tunet.UNetBlock(16, **kwargs, device="cpu"), 7
    )
    x = _x((2, 6, 5, 16), seed=8) * 2 + 0.5
    mod = _x((2, 8), seed=9)

    want = _jax_call(jblock, jnp.asarray(x), jnp.asarray(mod))
    got = tblock(torch.from_numpy(x), torch.from_numpy(mod))

    assert _rel_err(got, want) <= TOL


def test_unet_block_dropout_by_moments():
    # the FFN's hidden activations reach conv2 dropped where the generator
    # says and scaled by 1 / (1 - r) where kept; without a generator, untouched
    rate = 0.3
    block = tunet.UNetBlock(16, mod_features=8, dropout=rate, kernel_size=(3, 3), padding=((1, 1), (1, 1)), device="cpu")
    seen = []
    block.conv2.register_forward_pre_hook(lambda m, args: seen.append(args[0]))

    x = torch.from_numpy(_x((4, 16, 16, 16), seed=10))
    mod = torch.from_numpy(_x((4, 8), seed=11))
    with torch.no_grad():
        block(x, mod)
        block(x, mod, generator=torch.Generator().manual_seed(0))
    clean, dropped = seen

    keep = dropped != 0
    assert torch.allclose(dropped[keep], clean[keep] / (1 - rate), rtol=1e-6)
    # the dropped share of 16,384 draws: binomial sd ~ 0.0036
    assert abs(1 - keep.float().mean().item() - rate) < 0.02


def test_unet_block_checkpointing_keeps_output_and_gradients():
    kwargs = dict(mod_features=8, dropout=0.2, norm="group", groups=4, kernel_size=(3, 3), padding=((1, 1), (1, 1)))  # noqa: C408
    block = tunet.UNetBlock(16, **kwargs, device="cpu")
    x = torch.from_numpy(_x((2, 8, 8, 16), seed=12)).requires_grad_()
    mod = torch.from_numpy(_x((2, 8), seed=13))

    results = []
    for checkpointing in (False, True):
        block.checkpointing = checkpointing
        y = block(x, mod, generator=torch.Generator().manual_seed(1))
        grads = torch.autograd.grad(y.square().sum(), [x, *block.parameters()])
        results.append((y.detach(), grads))

    (want, want_grads), (got, got_grads) = results
    assert torch.equal(got, want)
    for a, b in zip(got_grads, want_grads, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "kwargs, shape",
    [
        (dict(cond_channels=2, hid_channels=(8, 16, 16), hid_blocks=(1, 1, 2), norm="layer"), (2, 11, 13)),  # noqa: C408
        (dict(cond_channels=0, hid_channels=(8, 16), hid_blocks=(2, 1), norm="group", groups=4, spatial=1,  # noqa: C408
              periodic=True, identity_init=True), (2, 13)),
        (dict(cond_channels=1, hid_channels=(8, 8), hid_blocks=(1, 1), norm="rms", spatial=3), (1, 5, 6, 7)),  # noqa: C408
    ],
    ids=["2d_odd_cond", "1d_periodic_group", "3d_rms"],
)
def test_unet_matches_jax(kwargs, shape):
    jnet, tnet = _pair(
        _skeleton(junet.UNet, 3, 2, mod_features=8, **kwargs),
        tunet.UNet(3, 2, mod_features=8, **kwargs, device="cpu"),
        14,
    )
    x = _x((*shape, 3), seed=15)
    mod = _x((shape[0], 8), seed=16)
    cond = _x((*shape, kwargs["cond_channels"]), seed=17) if kwargs["cond_channels"] else None

    want = _jax_call(jnet, jnp.asarray(x), jnp.asarray(mod), cond=None if cond is None else jnp.asarray(cond))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), torch.from_numpy(mod), cond=None if cond is None else torch.from_numpy(cond))

    assert tuple(got.shape) == (*shape, 2)
    assert _rel_err(got, want) <= TOL


# the tiny denoiser


def _slice_pair(norm: str, seed: int):
    r"""The same random tiny UNet denoiser in JAX and in the port (on the CPU),
    with the JAX backbone."""

    jbackbone = filter_eval_shape(
        lambda: jembedding.Modulated(junet.UNet(3, 3, norm=norm, **TINY, key=jax.random.key(0)), 16, key=jax.random.key(1))
    )
    tbackbone = tembedding.Modulated(tunet.UNet(3, 3, norm=norm, **TINY, device="cpu"), 16, device="cpu")
    jbackbone, tbackbone = _pair(jbackbone, tbackbone, seed)

    return jbackbone, tdenoise.KarrasDenoiser(tbackbone, tnoise.VPSchedule())


_jax_denoise = filter_jit(lambda d, x, t: d(x, t).mean)


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_denoiser_and_ddim_match_jax(norm):
    jbackbone, td = _slice_pair(norm, seed=18)
    jd = jdenoise.KarrasDenoiser(jbackbone, jnoise.VPSchedule())
    x = _x((2, 16, 16, 3), seed=19)

    for t in (0.2, 0.7):
        want = _jax_denoise(jd, jnp.asarray(x), jnp.float32(t))
        with torch.no_grad():
            got = td(torch.from_numpy(x), torch.tensor(t))
        assert got.mean.dtype == torch.float32 and tuple(got.mean.shape) == (2, 16, 16, 3)
        assert _rel_err(got.mean, want) <= TOL

    want = JaxDDIM(jd, steps=4)(jnp.asarray(x))
    with torch.no_grad():
        got = TorchDDIM(td, steps=4)(torch.from_numpy(x))

    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 5 * TOL


@filter_jit
def _jax_loss_and_grads(jbackbone, x, t, key):
    params, static = partition(jbackbone)

    def loss_fn(p):
        return jdenoise.KarrasDenoiser(combine(p, static), jnoise.VPSchedule()).loss(x, t, key)

    return jax.value_and_grad(loss_fn)(params)


def _jax_value_and_grad(jbackbone, x, t, key):
    # jitted: one compile for the file's calls, where op by op compiles each
    loss, grads = _jax_loss_and_grads(jbackbone, x, t, key)
    return loss, combine(grads, partition(jbackbone)[1])


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_loss_gradients_match_jax(norm):
    # the loss and the gradient of every parameter, against
    # jax.value_and_grad of the JAX loss with the same weights and noise
    jbackbone, td = _slice_pair(norm, seed=20)
    x = _x((2, 16, 16, 3), seed=21)
    t = np.random.default_rng(22).uniform(0.05, 0.95, 2).astype(np.float32)
    key = jax.random.key(23)

    want, grads = _jax_value_and_grad(jbackbone, jnp.asarray(x), jnp.asarray(t), key)
    want_grads = from_jax_state_dict({k: np.array(v) for k, v in state_dict(grads).items()}, td.backbone)
    z = torch.from_numpy(np.array(jax.random.normal(key, x.shape, dtype=jnp.float32)))

    before = dict(_build.LAUNCHES)
    got = td._loss(torch.from_numpy(x), torch.from_numpy(t), z)
    got.backward()
    assert dict(_build.LAUNCHES) == before

    assert abs(got.item() - float(want)) <= TOL * abs(float(want))
    named = dict(td.backbone.named_parameters())
    assert set(named) == set(want_grads)
    for name, param in named.items():
        assert param.grad is not None, name
        assert _rel_err(param.grad, want_grads[name]) <= TOL_GRAD, name


def test_adamw_steps_match_optax():
    # three steps of optax.adamw(1e-4) against torch.optim.AdamW with
    # OPTAX_ADAMW, each on the same batch and injected noise; a step moves a
    # parameter by ~lr = 1e-4, and the gradients agree to ~1e-6 relative, so
    # the parameters agree far inside a tenth of a step
    jbackbone, td = _slice_pair("group", seed=24)
    x = jnp.asarray(_x((2, 16, 16, 3), seed=25))
    t = jnp.asarray(np.random.default_rng(26).uniform(0.05, 0.95, 2).astype(np.float32))

    params, static = partition(jbackbone)
    optimizer = optax.adamw(1e-4)
    state = optimizer.init(params)
    toptimizer = torch.optim.AdamW(td.parameters(), **ttrain.OPTAX_ADAMW)
    update, apply_updates = jax.jit(optimizer.update), jax.jit(optax.apply_updates)

    for i in range(3):
        key = jax.random.key(27 + i)
        _, grads = _jax_value_and_grad(combine(params, static), x, t, key)
        updates, state = update(partition(grads)[0], state, params)
        params = apply_updates(params, updates)

        z = torch.from_numpy(np.array(jax.random.normal(key, x.shape, dtype=jnp.float32)))
        td._loss(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(t)), z).backward()
        toptimizer.step()
        toptimizer.zero_grad(set_to_none=True)

    want = from_jax_state_dict({k: np.array(v) for k, v in state_dict(combine(params, static)).items()}, td.backbone)
    for name, param in td.backbone.named_parameters():
        assert np.abs(_f64(param) - _f64(want[name])).max() <= 1e-5, name


# weights


def _to_jax_layout(key: str, value: np.ndarray) -> np.ndarray:
    if key.endswith("weight") and value.ndim >= 3:  # (out, in, *k) -> (*k, in, out)
        return np.moveaxis(value, (0, 1), (-1, -2))
    if key.endswith("weight") and value.ndim == 2:
        return value.T
    return value


def test_converter_both_ways():
    jbackbone = filter_eval_shape(
        lambda: jembedding.Modulated(junet.UNet(3, 3, norm="group", **TINY, key=jax.random.key(0)), 16, key=jax.random.key(1))
    )
    tbackbone = tembedding.Modulated(tunet.UNet(3, 3, norm="group", **TINY, device="cpu"), 16, device="cpu")
    sd = _random_state(jbackbone, 28)

    converted = from_jax_state_dict(sd, tbackbone)
    assert set(converted) == set(tbackbone.state_dict())
    assert tuple(converted["backbone.descent.1.0.weight"].shape) == (32, 16, 3, 3)
    assert tuple(converted["backbone.ascent.1.0.weight"].shape) == (16, 48, 3, 3)
    assert tuple(converted["backbone.descent.0.1.ada_zero.lin2.weight"].shape) == (48, 16)
    tbackbone.load_state_dict(converted)

    # back into JAX, strictly: every key used, every array equal
    back = {k: _to_jax_layout(k, v.numpy()) for k, v in tbackbone.state_dict().items()}
    reloaded = _load_jax(jbackbone, back)
    for key, value in state_dict(reloaded).items():
        assert np.array_equal(np.asarray(value), sd[key]), key

    # AdaZero without modulation: its (3, C) param crosses as it is
    jnet = _skeleton(junet.UNet, 3, 3, hid_channels=(8,), hid_blocks=(1,))
    sd0 = _random_state(jnet, 29)
    assert "descent.0.1.ada_zero.param" in sd0
    out = from_jax_state_dict(sd0, tunet.UNet(3, 3, hid_channels=(8,), hid_blocks=(1,), device="cpu"))
    assert np.array_equal(out["descent.0.1.ada_zero.param"].numpy(), sd0["descent.0.1.ada_zero.param"])

    missing = dict(sd)
    del missing["backbone.ascent.1.2.bias"]
    with pytest.raises(KeyError):
        from_jax_state_dict(missing, tbackbone)
    wrong = dict(sd, **{"backbone.descent.0.0.weight": np.zeros((3, 3, 4, 16), np.float32)})
    with pytest.raises(ValueError):
        from_jax_state_dict(wrong, tbackbone)


def test_modules_default_to_the_card():
    if torch.cuda.is_available():
        net = tunet.UNet(3, 3, **TINY)
        assert next(net.parameters()).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tunet.UNet(3, 3, **TINY)
