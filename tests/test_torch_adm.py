r"""The PyTorch port's ADM family (`azula_tpu_torch.models.adm`) against the JAX
package's, on the CPU, in float32: a tiny backbone with every weight drawn
from a seeded numpy generator, loaded into JAX with `load_state_dict` and into
the port with `from_jax_state_dict`.

The JAX backbone zero-initializes every ResBlock `out_conv`, every attention
`proj` and the final `out_conv`; with those left at zero any comparison would
pass trivially, so every leaf is drawn.

Tolerances are relative to max |reference|: the two frameworks sum the
convolutions and matmuls in other orders (float32, measured ~1e-6), over a few
dozen layers, so 1e-4.
"""

import functools
import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu.models import adm as jadm
from azula_tpu.sample import DDIMSampler as JaxDDIM
from azula_tpu.utils.pytree import combine, filter_eval_shape, filter_jit, load_state_dict, partition, state_dict
from azula_tpu_torch.models import adm as tadm
from azula_tpu_torch.models.adm import backbone as adm_backbone
from azula_tpu_torch.models.adm.convert import from_jax_state_dict
from azula_tpu_torch.sample import DDIMSampler as TorchDDIM

TINY = dict(  # noqa: C408
    image_size=32,
    num_channels=32,
    num_res_blocks=1,
    channel_mult=(1, 2),
    attention_resolutions=(16, 8),
    num_head_channels=32,  # two heads of 32 at 64 channels: a head dim the kernel takes
)

# the flags of the imagenet_256x256 card
CARD = dict(resblock_updown=True, use_scale_shift_norm=True)  # noqa: C408

TOL = 1e-4


def _random_state(backbone, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in state_dict(backbone).items():
        shape = tuple(leaf.shape)
        if key.endswith(".scale"):  # GroupNorm gain
            value = 1 + 0.2 * rng.standard_normal(shape)
        elif len(shape) == 1:  # biases
            value = 0.2 * rng.standard_normal(shape)
        elif key == "label_emb":
            value = rng.standard_normal(shape)
        else:  # (in, out) linear or HWIO conv: 1 / sqrt(fan in)
            value = rng.standard_normal(shape) / math.sqrt(math.prod(shape[:-1]))
        out[key] = value.astype(np.float32)
    return out


def _pair(seed: int = 0, **config):
    r"""The same random ADM denoiser in JAX and in the port (on the CPU)."""

    config = {**TINY, **config}

    jd = filter_eval_shape(jadm.make_model, **config)
    sd = _random_state(jd.backbone, seed)
    jd = jd.tree_replace(
        backbone=load_state_dict(jd.backbone, {k: jnp.asarray(v) for k, v in sd.items()}),
        sigmas=jnp.asarray(jadm.discrete_sigmas(), dtype=jnp.float32),
    )

    td = tadm.make_model(**config, device="cpu")
    td.backbone.load_state_dict(from_jax_state_dict(sd, td.backbone))

    return jd, td


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got.double().numpy() - want).max() / np.abs(want).max())


_jax_backbone = filter_jit(lambda b, x, t, y: b(x, t, y=y))


@pytest.mark.parametrize(
    "config",
    [
        dict(resblock_updown=True, use_scale_shift_norm=True),
        dict(resblock_updown=False, use_scale_shift_norm=False),
        dict(resblock_updown=True, use_scale_shift_norm=False),
        dict(resblock_updown=False, use_scale_shift_norm=True),
        dict(use_new_attention_order=True, **CARD),
        dict(num_classes=10, **CARD),
    ],
    ids=["card", "plain", "updown", "scale_shift", "new_qkv_order", "class_cond"],
)
def test_backbone_matches_jax(config):
    jd, td = _pair(**config)

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.array([3, 617])
    y = np.array([1, 7]) if "num_classes" in config else None

    want = _jax_backbone(jd.backbone, jnp.asarray(x), jnp.asarray(t), None if y is None else jnp.asarray(y))
    with torch.no_grad():
        got = td.backbone(
            torch.from_numpy(x), torch.from_numpy(t), y=None if y is None else torch.from_numpy(y)
        )

    assert got.shape == (2, 32, 32, 6) and got.dtype == torch.float32
    assert np.abs(np.asarray(want)).max() > 0.1  # not the zero-initialized output
    assert _rel_err(got, want) <= TOL


def test_denoiser_matches_jax():
    jd, td = _pair(**CARD)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)

    denoise = filter_jit(lambda d, x, t: d(x, t))

    for t in (0.3, 0.9):
        want = denoise(jd, jnp.asarray(x), jnp.float32(t))
        with torch.no_grad():
            got = td(torch.from_numpy(x), torch.tensor(t, dtype=torch.float32))

        # mean = (x - sigma * eps) / alpha: the backbone's difference grows
        # by sigma / alpha (~40 at t = 0.9) against a mean clipped to [-1, 1]
        alpha, sigma = jd.schedule(t)
        assert _rel_err(got.mean, want.mean) <= TOL * max(1.0, float(sigma / alpha))
        assert _rel_err(got.var, want.var) <= TOL


def test_discrete_timesteps_equal_jax():
    # A one-ulp difference in alpha or sigma could move sigma / sqrt(alpha^2 +
    # sigma^2) across an entry of the table; the indices must be equal over
    # every time of the DDIM-64 trajectory (JAX evaluated op by op in float32,
    # the port in float64).
    jd, td = _pair(**CARD)
    js = jd.schedule
    times = JaxDDIM(jd, steps=64).timesteps

    def jax_index(t):
        alpha, sigma = js(t)
        return int(jnp.searchsorted(jd.sigmas, (sigma * jax.lax.rsqrt(alpha**2 + sigma**2)).ravel())[0])

    want = [jax_index(t) for t in times]
    got = [int(td.discrete_time(t)[0]) for t in TorchDDIM(td, steps=64).timesteps]

    assert len(got) == 65
    assert got == want
    assert want[0] > want[32] > want[-1]  # the indices do move


# Every time of JAX's DDIM-250 and DDIM-1000 grids at which the port's index
# (float64 ratio, float64 table) differs from JAX's (float32 ratio, float32
# table), as (time, JAX index, port index).
DISCRETE_TIME_TIES = {
    250: [(np.float32(0.888), 846, 847)],
    1000: [(np.float32(0.888), 846, 847)],
}


@pytest.mark.parametrize("steps", sorted(DISCRETE_TIME_TIES))
def test_discrete_time_ties_with_jax(steps):
    # At these times JAX's float32 noise ratio lands on a float32 table entry
    # (a tie, which the left search settles below), while the exact ratio lies
    # just above the entry. Each is a one-step difference at a ratio within two
    # float32 ulps of an entry, not a different schedule.
    jd, td = _pair(**CARD)
    times = np.asarray(JaxDDIM(jd, steps=steps).timesteps)

    alpha, sigma = jd.schedule(jnp.asarray(times))
    ratio32 = np.asarray(sigma * jax.lax.rsqrt(alpha**2 + sigma**2))
    want = np.asarray(jnp.searchsorted(jd.sigmas, ratio32))

    got = td.discrete_time(torch.from_numpy(times.copy())).numpy()
    alpha, sigma = td.schedule(torch.from_numpy(times.copy()).double())
    ratio64 = (sigma / torch.sqrt(alpha**2 + sigma**2)).numpy()

    differ = np.nonzero(got != want)[0]
    assert [(times[i], int(want[i]), int(got[i])) for i in differ] == DISCRETE_TIME_TIES[steps]

    table32, table64 = np.asarray(jd.sigmas), td.sigmas.numpy()
    for i in differ:
        assert got[i] == want[i] + 1
        entry = want[i]
        assert abs(float(ratio32[i]) - float(table32[entry])) <= 2 * np.spacing(ratio32[i])
        assert abs(ratio64[i] - table64[entry]) <= 2 * np.spacing(np.float32(table64[entry]))


def test_ddim_trajectory_matches_jax():
    jd, td = _pair(**CARD)
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)

    want = JaxDDIM(jd, steps=4)(jnp.asarray(x))
    with torch.no_grad():
        got = TorchDDIM(td, steps=4)(torch.from_numpy(x))

    # each step carries the backbone's ~1e-6 differences through
    # c_out = -sigma / alpha (100 at t = 1, 1.2 at t = 0.25) before the clip
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 5 * TOL


def test_from_jax_state_dict_is_strict():
    jd = filter_eval_shape(jadm.make_model, **TINY, **CARD)
    td = tadm.make_model(**TINY, **CARD, device="cpu")
    sd = _random_state(jd.backbone, 0)

    converted = from_jax_state_dict(sd, td.backbone)
    assert set(converted) == set(td.backbone.state_dict())
    assert tuple(converted["input_blocks.1.0.in_conv.weight"].shape) == (32, 32, 3, 3)
    assert tuple(converted["input_blocks.3.1.qkv.weight"].shape) == (192, 64)

    missing = dict(sd)
    del missing["out_norm.scale"]
    with pytest.raises(KeyError):
        from_jax_state_dict(missing, td.backbone)

    extra = dict(sd, **{"input_blocks.1.0.extra.weight": np.zeros((3, 3), np.float32)})
    with pytest.raises(KeyError):
        from_jax_state_dict(extra, td.backbone)

    with pytest.raises(KeyError):
        from_jax_state_dict({"input_blocks.1.0.in_norm.mean": np.zeros(4, np.float32)})

    wrong = dict(sd, **{"out_norm.scale": np.zeros(7, np.float32)})
    with pytest.raises(ValueError):
        from_jax_state_dict(wrong, td.backbone)


def test_make_model_defaults_to_the_card():
    if torch.cuda.is_available():
        denoiser = tadm.make_model(**TINY)
        assert next(denoiser.parameters()).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tadm.make_model(**TINY)


def _param_grads(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {name: p.grad.clone() for name, p in module.named_parameters()}


def test_checkpointing_gradients_match_jax():
    # both rematerialize each input, middle and output stage; every
    # parameter's gradient of the summed squared output, within 1e-4 of the
    # largest (a bias before a GroupNorm has an analytically zero gradient).
    # One level with attention at full resolution: each kind of stage, at a
    # third less of JAX's compile
    jd, td = _pair(checkpointing=True, channel_mult=(1,), attention_resolutions=(32,), **CARD)
    assert td.backbone.checkpointing and jd.backbone.checkpointing

    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)  # attention over 256 pixels
    t = np.array([617])

    params, static = partition(jd.backbone)

    def loss(p):
        return jnp.sum(combine(p, static)(jnp.asarray(x), jnp.asarray(t)) ** 2)

    grads = jax.jit(jax.grad(loss))(params)
    want = from_jax_state_dict({k: np.array(v) for k, v in state_dict(combine(grads, static)).items()})

    td.backbone(torch.from_numpy(x), torch.from_numpy(t)).square().sum().backward()
    got = _param_grads(td.backbone)

    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for key, g in got.items():
        assert float((g - want[key]).abs().max()) <= 1e-4 * scale, key


def _dropout_runs():
    r"""The output and parameter gradients of the same tiny ADM with dropout,
    without and with checkpointing, from the same generator."""

    _, td = _pair(dropout=0.3, **CARD)
    _, td_ckpt = _pair(dropout=0.3, checkpointing=True, **CARD)

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    t = torch.tensor([3, 617])

    outs, grads = [], []
    for backbone in (td.backbone, td_ckpt.backbone):
        y = backbone(x, t, generator=torch.Generator().manual_seed(5))
        y.square().sum().backward()
        outs.append(y.detach())
        grads.append(_param_grads(backbone))

    with torch.no_grad():
        plain = td.backbone(x, t)
    assert not torch.allclose(outs[0], plain, atol=1e-3)  # the dropout bit

    return outs, grads


def test_checkpointing_keeps_gradients_with_dropout():
    # the recomputed stages draw the dropout masks that the forward drew:
    # with and without checkpointing, the same generator gives the same
    # output and gradients
    outs, grads = _dropout_runs()

    assert torch.equal(outs[0], outs[1])
    for key, g in grads[0].items():
        assert torch.allclose(grads[1][key], g, rtol=1e-6, atol=1e-6 * float(g.abs().max())), key


def test_checkpointing_without_the_replay_breaks_gradients(monkeypatch):
    # the fault the replay prevents, planted: a recompute that draws its
    # dropout masks afresh from the generator the forward advanced. The
    # forward is the same, and the gradients leave the plain backward's by
    # far more than the bound above
    def unreplayed(f, reentrant=False):
        def wrapper(*args, generator=None):
            return torch.utils.checkpoint.checkpoint(functools.partial(f, generator=generator), *args, use_reentrant=False)

        return wrapper

    monkeypatch.setattr(adm_backbone, "checkpoint", unreplayed)
    outs, grads = _dropout_runs()

    assert torch.equal(outs[0], outs[1])
    worst = max(float((grads[1][key] - g).abs().max() / g.abs().max()) for key, g in grads[0].items() if g.abs().max() > 0)
    assert worst > 1e-2

def _unfolded(block, x, emb):
    r"""`ADMResBlock.forward` before its biases moved into the residual sum:
    each convolution through `Conv.forward` with its bias, then `skip + h`
    (scale-shift norm, no dropout). Returns the sum and the two biased
    convolutions that it rounded on the way (the skip's `None` where the
    skip is the input)."""

    gn = adm_backbone.group_norm_silu
    h = gn(x, block.in_norm.groups, eps=block.in_norm.eps, scale=block.in_norm.weight, bias=block.in_norm.bias)
    if block.updown == "up":
        h, x = adm_backbone._upsample2(h), adm_backbone._upsample2(x)
    elif block.updown == "down":
        h, x = adm_backbone._avgpool2(h), adm_backbone._avgpool2(x)
    h = block.in_conv(h)
    scale, shift = block.emb_lin(torch.nn.functional.silu(emb)).to(h.dtype).chunk(2, dim=-1)
    h = gn(
        h, block.out_norm.groups, eps=block.out_norm.eps, scale=block.out_norm.weight,
        bias=block.out_norm.bias, mod_scale=scale, mod_shift=shift,
    )
    h = block.out_conv(h)
    skip = x if block.skip is None else block.skip(x)
    return skip + h, h, None if block.skip is None else skip


RESBLOCKS = {
    "identity": dict(channels=64, out_channels=64),  # noqa: C408
    "skip_1x1": dict(channels=64, out_channels=96),  # noqa: C408
    "up": dict(channels=64, out_channels=64, up=True),  # noqa: C408
    "down": dict(channels=64, out_channels=64, down=True),  # noqa: C408
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(RESBLOCKS))
def test_resblock_folds_biases_into_the_residual(kind, dtype):
    # the fold against the old composition from the same weights (none zero):
    # float32 to its rounding; bf16 within half an ulp of each rounding of
    # either side, at its tensor's scale. The old composition rounds each
    # convolution with its bias and the sum; the fold each convolution
    # without it (where the library adds the bias before rounding, as on
    # the CPU) and the sum: one ulp of the output's scale and one of each
    # convolution's.
    dtype = getattr(torch, dtype)
    g = torch.Generator().manual_seed(sorted(RESBLOCKS).index(kind))
    block = adm_backbone.ADMResBlock(
        **RESBLOCKS[kind], emb_channels=128, use_scale_shift_norm=True, device="cpu", generator=g
    )
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
    assert (block.skip is not None) == (kind == "skip_1x1")
    block = block.to(dtype)

    x = torch.randn(2, 16, 16, 64, generator=g).to(dtype)
    emb = torch.randn(2, 128, generator=g).to(dtype)
    with torch.no_grad():
        got = block(x, emb)
        want, *rounded = _unfolded(block, x, emb)

    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    scale = want.abs().max().double()
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 1e-5 * scale
    else:
        def ulp(t):
            return torch.exp2(torch.floor(torch.log2(t.abs().max().double())) - 7)

        bound = ulp(want) + sum(ulp(t) for t in rounded if t is not None)
        assert (got.double() - want.double()).abs().max() <= bound
