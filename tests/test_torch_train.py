r"""The PyTorch port's training path against the JAX package's, on the CPU:
`_flash_blhd` and `_reference_core_flash` (the fused MSA's training route),
the denoisers' losses, the tiny ViT's gradients, AdamW with optax's
settings, `ema_update` and checkpoints.

JAX's `_flash_blhd` is a Pallas kernel; it runs here in interpret mode
(`pltpu.force_tpu_interpret_mode()`), as the kernel itself, and the port's
plain versions are held against it. The CUDA kernels are held against the
same plain versions on the card by `chip_smoke.py`. Inputs come from seeded
numpy generators. Tolerances are relative to max |reference|: float32 1e-5
(the same arithmetic summed in another order), bfloat16 1e-2 (a value near a
bf16 rounding boundary may round either way in the two frameworks).
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import optax
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from azula_tpu import denoise as jdenoise
from azula_tpu import noise as jnoise
from azula_tpu import train as jtrain
from azula_tpu.nn import embedding as jembedding
from azula_tpu.nn import vit as jvit
from azula_tpu.ops import attention as jattention
from azula_tpu.ops import fused_msa as jfused
from azula_tpu.utils.pytree import combine, load_state_dict, partition, state_dict
from azula_tpu_torch import denoise as tdenoise
from azula_tpu_torch import noise as tnoise
from azula_tpu_torch import train as ttrain
from azula_tpu_torch.nn import embedding as tembedding
from azula_tpu_torch.nn import vit as tvit
from azula_tpu_torch.nn.convert import from_jax_state_dict
from azula_tpu_torch.ops import _build
from azula_tpu_torch.ops import attention as tattention
from azula_tpu_torch.ops import fused_msa as tfused
from azula_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}

# the tiny ViT of tests/test_torch_dit.py: 8 x 8 x 3 images, 16 tokens, 2 blocks of 2 heads
TINY = dict(mod_features=16, hid_channels=64, hid_blocks=2, patch_size=2, attention_heads=2)  # noqa: C408


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _normal(rng, shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


# _flash_blhd


SHAPES = [(2, 128, 2, 64), (1, 256, 2, 128)]


def _blhd_inputs(B, L, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [_normal(rng, (B, L, H * D)) for _ in range(4)]  # q, k, v, cotangent


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_blhd_matches_jax_kernel(dtype, shape):
    B, L, H, D = shape
    jd, td = DTYPES[dtype]
    q, k, v, _ = _blhd_inputs(*shape)
    scale = 1 / math.sqrt(D)

    with pltpu.force_tpu_interpret_mode():
        want = jattention._flash_blhd(*(jnp.asarray(a).astype(jd) for a in (q, k, v)), H, scale)
    got = tattention._flash_blhd(*(torch.from_numpy(a).to(td) for a in (q, k, v)), H, scale)

    assert got.dtype == td and tuple(got.shape) == (B, L, H * D)
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_blhd_vjp_matches_jax_kernel(dtype, shape):
    B, L, H, D = shape
    jd, td = DTYPES[dtype]
    q, k, v, g = _blhd_inputs(*shape, seed=1)
    scale = 1 / math.sqrt(D)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda a, b, c: jattention._flash_blhd(a, b, c, H, scale), *(jnp.asarray(a).astype(jd) for a in (q, k, v))
        )
        want = vjp(jnp.asarray(g).astype(jd))

    inputs = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    out = tattention._flash_blhd(*inputs, H, scale)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(g).to(td))

    for name, a, b in zip("qkv", got, want, strict=True):
        assert a.dtype == td, name
        assert _rel_err(a, b) <= TOL[dtype], name


@pytest.mark.parametrize("heads", [1, 2])
def test_flash_blhd_backward_is_the_gradient(heads):
    # the hand-written backward of the JAX body against autograd through the
    # plain forward, float32
    rng = np.random.default_rng(2)
    q, k, v, g = (torch.from_numpy(_normal(rng, (2, 64, 128))) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    o = tattention._flash_blhd_fwd_plain(q, k, v, heads, 0.2)
    want = torch.autograd.grad(o, (q, k, v), g)
    got = tattention._flash_blhd_bwd_plain(q, k, v, o.detach(), g, heads, 0.2)

    for a, b in zip(got, want, strict=True):
        assert _rel_err(a, b) <= 1e-5


def test_flash_blhd_implementations_on_cpu():
    q, k, v, _ = (torch.from_numpy(a) for a in _blhd_inputs(1, 128, 2, 64))
    before = dict(_build.LAUNCHES)

    auto = tattention._flash_blhd(q, k, v, 2, 0.125)
    assert torch.equal(auto, tattention._flash_blhd(q, k, v, 2, 0.125, implementation="plain"))
    with pytest.raises(ValueError, match="CUDA"):
        tattention._flash_blhd(q, k, v, 2, 0.125, implementation="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tattention._flash_blhd_bwd_kernel(q, k, v, q, q, torch.zeros((1, 2, 128)), 2, 0.125)
    with pytest.raises(ValueError):
        tattention._flash_blhd(q, k, v, 2, 0.125, implementation="pallas")

    assert dict(_build.LAUNCHES) == before
    assert _build.LAUNCHES["flash_blhd_fwd"] == _build.LAUNCHES["flash_blhd_bwd"] == 0


# _reference_core_flash and the fused MSA's routes

B, L, H, D = 2, 128, 2, 64
C = H * D


def _msa_inputs(seed):
    rng = np.random.default_rng(seed)
    return _normal(rng, (B, L, 3 * C)), _normal(rng, (L, C // 2)), _normal(rng, (B, L, C))


@pytest.mark.parametrize("eps", [1e-5, None], ids=["eps", "no_eps"])
@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_core_flash_matches_jax(dtype, rope, eps):
    # value, and vjp with respect to qkv and the rope tables
    jd, td = DTYPES[dtype]
    qkv, theta, g = _msa_inputs(3)

    if rope:
        cos2, sin2 = jfused.rope_tables(jnp.asarray(theta), H)
        tables = [torch.from_numpy(np.array(a)).requires_grad_() for a in (cos2, sin2)]
    else:
        cos2 = sin2 = None
        tables = []

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(
            lambda a, *cs: jfused._reference_core_flash(a, *(cs or (None, None)), H, eps, 0.125),
            jnp.asarray(qkv).astype(jd),
            *([cos2, sin2] if rope else []),
        )
        want_grads = vjp(jnp.asarray(g).astype(jd))

    tqkv = torch.from_numpy(qkv).to(td).requires_grad_()
    got = tfused._reference_core_flash(tqkv, *(tables or (None, None)), H, eps, 0.125)
    got_grads = torch.autograd.grad(got, [tqkv, *tables], torch.from_numpy(g).to(td))

    assert got.dtype == td and tuple(got.shape) == (B, L, C)
    assert _rel_err(got, want) <= TOL[dtype]
    assert len(got_grads) == len(want_grads)
    for a, b in zip(got_grads, want_grads, strict=True):
        assert _rel_err(a, b) <= TOL[dtype]


@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
def test_fused_msa_gradient_on_cpu_matches_jax(rope):
    # off the card both packages differentiate `_reference` (the plain version)
    qkv, theta, g = _msa_inputs(4)

    def jax_loss(a, th):
        y = jfused.fused_msa_attention(a, H, th if rope else None, eps=1e-5)
        return jnp.sum(y * jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(theta))

    tqkv = torch.from_numpy(qkv).requires_grad_()
    ttheta = torch.from_numpy(theta).requires_grad_()
    y = tfused.fused_msa_attention(tqkv, H, ttheta if rope else None, eps=1e-5)
    (y * torch.from_numpy(g)).sum().backward()

    assert _rel_err(tqkv.grad, want[0]) <= TOL["float32"]
    if rope:
        assert _rel_err(ttheta.grad, want[1]) <= TOL["float32"]
    else:
        assert ttheta.grad is None


@pytest.mark.parametrize(
    "grad_qkv, grad_theta, mode, route",
    [
        (True, False, "grad", "flash"),
        (False, True, "grad", "flash"),
        (False, False, "grad", "serving"),
        (True, True, "no_grad", "serving"),
        (True, True, "inference", "serving"),
    ],
)
def test_fused_msa_kernel_route(monkeypatch, grad_qkv, grad_theta, mode, route):
    # the card's route, picked as the JAX `_fused` custom_vjp picks it: the
    # flash composition when autograd records the call, else the serving kernel
    calls = []
    monkeypatch.setattr(tfused, "_reference_core_flash", lambda *a, **kw: calls.append(("flash", kw)))
    monkeypatch.setattr(tfused, "_fused_msa_kernel", lambda *a: calls.append(("serving", {})))

    qkv, theta, _ = _msa_inputs(5)
    qkv = torch.from_numpy(qkv).requires_grad_(grad_qkv)
    theta = torch.from_numpy(theta).requires_grad_(grad_theta)

    context = {"grad": torch.enable_grad, "no_grad": torch.no_grad, "inference": torch.inference_mode}[mode]
    with context():
        tfused.fused_msa_attention(qkv, H, theta, implementation="kernel")

    assert [name for name, _ in calls] == [route]
    if route == "flash":
        assert calls[0][1] == {"implementation": "kernel"}


# losses


def _slice_pair(rope: bool, seed: int = 0, simple: bool = False):
    r"""The same random tiny ViT denoiser in JAX and in the port (on the CPU),
    with the JAX backbone's static half for differentiating its parameters."""

    k1, k2 = jax.random.split(jax.random.key(0))
    jbackbone = jembedding.Modulated(jvit.ViT(3, 3, rope=rope, **TINY, key=k1), 16, key=k2)

    rng = np.random.default_rng(seed)
    sd = {}
    for key, leaf in state_dict(jbackbone).items():
        scale = 0.2 if key.endswith("bias") else 1 / math.sqrt(leaf.shape[0])
        sd[key] = (scale * rng.standard_normal(leaf.shape)).astype(np.float32)
    jbackbone = load_state_dict(jbackbone, {k: jnp.asarray(v) for k, v in sd.items()})

    tbackbone = tembedding.Modulated(tvit.ViT(3, 3, rope=rope, **TINY, device="cpu"), 16, device="cpu")
    tbackbone.load_state_dict(from_jax_state_dict(sd, tbackbone))

    jcls, tcls = (jdenoise.SimpleDenoiser, tdenoise.SimpleDenoiser) if simple else (
        jdenoise.KarrasDenoiser, tdenoise.KarrasDenoiser)

    return jbackbone, jcls, tcls(tbackbone, tnoise.VPSchedule())


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = _normal(rng, (4, 8, 8, 3))
    t = rng.uniform(0.05, 0.95, size=4).astype(np.float32)
    return x, t


def _jax_loss_and_noise(jcls, jbackbone, x, t, seed, **kwargs):
    key = jax.random.key(seed)
    denoiser = jcls(jbackbone, jnoise.VPSchedule())
    loss = denoiser.loss(jnp.asarray(x), jnp.asarray(t), key, **kwargs)
    z = jax.random.normal(key, x.shape, dtype=jnp.float32)  # the noise the loss drew
    return loss, torch.from_numpy(np.array(z))


@pytest.mark.parametrize(
    "simple, kwargs",
    [(False, {}), (True, {}), (True, {"max_weight": 2.0})],
    ids=["karras", "simple", "simple_clipped"],
)
def test_loss_matches_jax(simple, kwargs):
    jbackbone, jcls, td = _slice_pair(rope=False, seed=1, simple=simple)
    x, t = _batch(2)

    want, z = _jax_loss_and_noise(jcls, jbackbone, x, t, 3, **kwargs)
    with torch.no_grad():
        got = td._loss(torch.from_numpy(x), torch.from_numpy(t), z, **kwargs)

    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("simple", [False, True], ids=["karras", "simple"])
def test_loss_draws_its_noise_from_the_generator(simple):
    _, _, td = _slice_pair(rope=False, simple=simple)
    x, t = (torch.from_numpy(a) for a in _batch(4))

    with torch.no_grad():
        got = td.loss(x, t, generator=torch.Generator().manual_seed(7))
        z = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
        want = td._loss(x, t, z)

    assert torch.equal(got, want)


@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
def test_vit_loss_gradients_match_jax(rope):
    # the loss and the gradient of every parameter, against
    # jax.value_and_grad of the JAX loss with the same weights and noise
    jbackbone, jcls, td = _slice_pair(rope, seed=5)
    x, t = _batch(6)
    key = jax.random.key(8)
    params, static = partition(jbackbone)

    def loss_fn(p):
        return jcls(combine(p, static), jnoise.VPSchedule()).loss(jnp.asarray(x), jnp.asarray(t), key)

    want, grads = jax.value_and_grad(loss_fn)(params)
    want_grads = from_jax_state_dict(
        {k: np.array(v) for k, v in state_dict(combine(grads, static)).items()}, td.backbone
    )
    z = torch.from_numpy(np.array(jax.random.normal(key, x.shape, dtype=jnp.float32)))

    got = td._loss(torch.from_numpy(x), torch.from_numpy(t), z)
    got.backward()

    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    named = dict(td.backbone.named_parameters())
    assert set(named) == set(want_grads)
    for name, param in named.items():
        assert param.grad is not None, name
        # relative to the largest gradient of the tensor; float32 sums in
        # other orders through two blocks and their backward
        assert _rel_err(param.grad, want_grads[name]) <= 1e-4, name


# optimizer, EMA, train step, checkpoints


def test_adamw_settings_match_optax():
    # three steps on the same gradients: torch.optim.AdamW with OPTAX_ADAMW
    # against optax.adamw(1e-4), float32
    assert ttrain.OPTAX_ADAMW == {"lr": 1e-4, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}

    rng = np.random.default_rng(9)
    shapes = [(8, 4), (4,), (3, 2, 2)]
    params = [_normal(rng, s) for s in shapes]
    grads = [[_normal(rng, s) * 10 ** (-i) for i, s in enumerate(shapes)] for _ in range(3)]

    optimizer = optax.adamw(1e-4)
    jparams = [jnp.asarray(p) for p in params]
    state = optimizer.init(jparams)
    for gs in grads:
        updates, state = optimizer.update([jnp.asarray(g) for g in gs], state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    tparams = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    toptimizer = torch.optim.AdamW(tparams, **ttrain.OPTAX_ADAMW)
    for gs in grads:
        for p, g in zip(tparams, gs, strict=True):
            p.grad = torch.from_numpy(g)
        toptimizer.step()

    for p0, a, b in zip(params, tparams, jparams, strict=True):
        moved = np.abs(_f64(b) - p0).max()
        assert moved > 1e-4  # three steps of ~lr each
        # a few float32 ulps of the parameters
        assert np.abs(_f64(a) - _f64(b)).max() <= 1e-6


@pytest.mark.parametrize("rate", [0.999, 0.5])
def test_ema_update_matches_jax(rate):
    _, _, ema = _slice_pair(rope=False, seed=10)
    _, _, model = _slice_pair(rope=False, seed=11)

    # copies: JAX may alias a numpy buffer and read it after the in-place update
    want = jtrain.ema_update(
        {k: jnp.array(v.numpy(), copy=True) for k, v in ema.state_dict().items()},
        {k: jnp.array(v.numpy(), copy=True) for k, v in model.state_dict().items()},
        rate=rate,
    )
    want = jax.block_until_ready(want)
    ttrain.ema_update(ema, model, rate=rate)

    for name, value in ema.state_dict().items():
        assert np.abs(_f64(value) - _f64(want[name])).max() <= 1e-6 * max(1.0, np.abs(_f64(want[name])).max())
    assert not any(p.grad is not None for p in ema.parameters())


def test_train_step():
    _, _, td = _slice_pair(rope=True, seed=12)
    x, t = (torch.from_numpy(a) for a in _batch(13))
    before = {k: v.clone() for k, v in td.state_dict().items()}

    # the step's loss is the loss of the weights before the step, with the
    # generator's noise
    with torch.no_grad():
        want = td.loss(x, t, generator=torch.Generator().manual_seed(1))

    state = ttrain.TrainState(td, torch.optim.AdamW(td.parameters(), **ttrain.OPTAX_ADAMW))
    got = state.step(x, t, generator=torch.Generator().manual_seed(1))

    assert not got.requires_grad and torch.allclose(got, want, rtol=1e-6, atol=0)
    assert state.steps == 1
    assert all(p.grad is None for p in td.parameters())
    assert all(not torch.equal(before[k], v) for k, v in td.state_dict().items())

    step = ttrain.make_train_step(td, state.optimizer)
    losses = [step(x, t, generator=torch.Generator().manual_seed(i)).item() for i in range(3)]
    assert all(math.isfinite(v) for v in losses)


@pytest.mark.parametrize("with_optimizer", [False, True], ids=["module", "module_and_optimizer"])
def test_checkpoint_round_trip(tmp_path, with_optimizer):
    _, _, td = _slice_pair(rope=False, seed=14)
    optimizer = torch.optim.AdamW(td.parameters(), **ttrain.OPTAX_ADAMW)
    x, t = (torch.from_numpy(a) for a in _batch(15))
    ttrain.TrainState(td, optimizer).step(x, t, generator=torch.Generator().manual_seed(0))

    path = tmp_path / "ckpt" / "state.pt"
    save_checkpoint(path, td, optimizer if with_optimizer else None)

    _, _, fresh = _slice_pair(rope=False, seed=16)
    fresh_optimizer = torch.optim.AdamW(fresh.parameters(), **ttrain.OPTAX_ADAMW)
    if with_optimizer:
        assert load_checkpoint(path, fresh, fresh_optimizer) is fresh
        want, got = optimizer.state_dict(), fresh_optimizer.state_dict()
        assert want["param_groups"] == got["param_groups"]
        for i, entry in want["state"].items():
            for name, value in entry.items():
                assert torch.equal(torch.as_tensor(value), torch.as_tensor(got["state"][i][name])), (i, name)
    else:
        load_checkpoint(path, fresh)
        with pytest.raises(KeyError, match="optimizer"):
            load_checkpoint(path, fresh, fresh_optimizer)

    for (name, a), (_, b) in zip(td.state_dict().items(), fresh.state_dict().items(), strict=True):
        assert torch.equal(a, b), name


def test_checkpoint_strict(tmp_path):
    _, _, td = _slice_pair(rope=False)
    path = tmp_path / "state.pt"
    save_checkpoint(path, td.backbone.backbone)  # the ViT alone: Modulated's keys are missing

    _, _, other = _slice_pair(rope=False, seed=1)
    with pytest.raises(RuntimeError):
        load_checkpoint(path, other.backbone)

    load_checkpoint(path, other.backbone.backbone, strict=True)
    assert all(
        torch.equal(a, b)
        for a, b in zip(td.backbone.backbone.state_dict().values(), other.backbone.backbone.state_dict().values(), strict=True)
    )
