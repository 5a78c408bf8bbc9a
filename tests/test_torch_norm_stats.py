r"""The PyTorch port's group statistics and GroupNorm training
(`azula_tpu_torch.ops.norm`) against the JAX package's, on the CPU.

Each `group_stats` implementation is held against JAX's same one, the
statistics kernel's plain version (`_stats_kernel_plain`) against JAX's TPU
kernel `_stats_pallas` run in interpret mode
(`pltpu.force_tpu_interpret_mode()`), and the gradients of `group_stats`,
`group_norm` and `group_norm_silu` against `jax.vjp`. The CUDA kernel is held
against the same plain version on the card by `chip_smoke.py`. Inputs come
from seeded numpy generators; the large-mean inputs are JAX's own
production case, 100 + 3 N (|mean| / std ~ 33).

Tolerances: mean within 1e-3 absolute (float32 sums of values of order 100
over up to 10^5 elements) and var within 1e-4 relative for the exact
implementations; `raw` and `guarded` are held to the JAX package's own
budget for them, 2e-3 relative at this ratio (`tests/test_ops_tpu.py`), as
their raw fold carries ~(mean / std)^2 eps of error. Gradients: 1e-5
relative to max |reference|, float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from jax.experimental.pallas import tpu as pltpu

from azula_tpu.ops import norm as jnorm
from azula_tpu_torch.ops import _build
from azula_tpu_torch.ops import norm as tnorm

EXACT = ("twopass", "pilot", "lazy")
RAW = ("raw", "guarded")


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _large_mean(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = 100.0 + 3.0 * rng.standard_normal(shape)
    if dtype == "bfloat16":  # rounded as JAX's bf16 input would be
        return np.array(jnp.asarray(x, dtype=jnp.bfloat16).astype(jnp.float32))
    return x.astype(np.float32)


def _check(got, want, var_tol):
    (gm, gv), (wm, wv) = got, want
    assert tuple(gm.shape) == tuple(wm.shape) and tuple(gv.shape) == tuple(wv.shape)
    assert gm.dtype == gv.dtype == torch.float32
    assert np.abs(_f64(gm) - _f64(wm)).max() < 1e-3
    assert (np.abs(_f64(gv) - _f64(wv)) / np.abs(_f64(wv))).max() < var_tol


# implementations


@pytest.mark.parametrize("implementation", EXACT + RAW)
@pytest.mark.parametrize("shape, groups", [((2, 1024, 64), 16), ((3, 300, 48), 4), ((2, 4096, 192), 24)])
def test_group_stats_matches_jax(implementation, shape, groups):
    x = _large_mean(shape, seed=1)

    want = jnorm.group_stats(jnp.asarray(x), groups, implementation)
    got = tnorm.group_stats(torch.from_numpy(x), groups, implementation)

    _check(got, want, 1e-4 if implementation in EXACT else 2e-3)
    if implementation in RAW:  # held to the exact statistics too
        _check(got, jnorm._stats_twopass(jnp.asarray(x), groups), 2e-3)


def test_lazy_takes_the_rescue_above_its_size():
    # 2^24 bytes and more: the raw fold, with the exact rescue where a group
    # falls under the cancellation floor (|mean| / std ~ 33 here) and the raw
    # variance kept where none does (mean 0)
    shape, groups = (1, 1 << 17, 32), 8
    for x in (_large_mean(shape, seed=2), np.random.default_rng(3).standard_normal(shape).astype(np.float32)):
        assert x.nbytes >= tnorm._LAZY_MIN_BYTES
        want = jnorm._stats_lazy(jnp.asarray(x), groups)
        got = tnorm._stats_lazy(torch.from_numpy(x), groups)
        _check(got, want, 1e-4)
        _check(got, jnorm._stats_twopass(jnp.asarray(x), groups), 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [128, 77, 1000, 4096])
def test_kernel_plain_version_exact_at_large_mean(dtype, rows):
    # the kernel's arithmetic: whole, ragged and single tiles
    x = _large_mean((2, 4096, 64), seed=4, dtype=dtype)
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)  # exact: x holds bf16 values

    want = jnorm._stats_twopass(jnp.asarray(x), 16)
    _check(tnorm._stats_kernel_plain(xt, 16, rows), want, 1e-5)


def test_kernel_plain_version_far_beyond():
    # |mean| / std = 1e4: every moment is taken about the pilot row
    x = (1e4 + np.random.default_rng(5).standard_normal((2, 2048, 32))).astype(np.float32)
    mean, var = tnorm._stats_kernel_plain(torch.from_numpy(x), 8, 300)
    want_mean, want_var = jnorm._stats_twopass(jnp.asarray(x), 8)

    assert np.abs(_f64(mean) - _f64(want_mean)).max() < 2e-3
    assert (np.abs(_f64(var) - _f64(want_var)) / _f64(want_var)).max() < 1e-4


@pytest.mark.parametrize(
    "shape, groups, rows",
    [((2, 8192, 128), 32, 4096), ((2, 8192, 128), 32, 1000), ((1, 4096 * 4, 256), 32, 3000)],
)
def test_kernel_plain_version_matches_pallas_kernel(shape, groups, rows):
    # JAX's TPU kernel at nblk > 1 (tiles of _stats_block rows), in interpret
    # mode; float32 rounding: both center each tile exactly
    x = _large_mean(shape, seed=6)
    S_BLK = jnorm._stats_block(shape[1], shape[2])
    assert shape[1] // S_BLK > 1

    with pltpu.force_tpu_interpret_mode():
        want = jnorm._stats_pallas(jnp.asarray(x), groups)
        want = jax.block_until_ready(want)

    _check(tnorm._stats_kernel_plain(torch.from_numpy(x), groups, rows), want, 1e-5)


def test_block_and_eligibility_match_jax():
    grid = [(B, HW, C) for B in (1, 8) for HW in (64, 1000, 1024, 4096, 4100, 9216, 16384, 65536, 66049)
            for C in (64, 128, 192, 256, 512, 1024)]
    for B, HW, C in grid:
        assert tnorm._stats_block(HW, C) == jnorm._stats_block(HW, C), (HW, C)
        assert tnorm.stats_kernel_eligible((B, HW, C)) == jnorm.stats_kernel_eligible((B, HW, C)), (B, HW, C)


@pytest.mark.parametrize(
    "B, HW, C, itemsize", [(256, 1024, 64, 2), (256, 256, 128, 2), (256, 64, 256, 2), (4, 1024, 16, 4), (4, 256, 32, 4)]
)
def test_kernel_tiles_span_the_rows(B, HW, C, itemsize):
    # unet32's GroupNorm shapes (bf16) and the tiny UNet's (float32), 16
    # groups: the blocks of a cluster tile the rows, each block holding some
    plan = tnorm._gn_plan(B, HW, C, 16, itemsize, stats=True)
    assert 0 < plan.rows <= HW
    assert plan.rows * plan.cluster >= HW > plan.rows * (plan.cluster - 1)


# routes


def test_group_stats_routes():
    x = torch.from_numpy(_large_mean((2, 64, 64), seed=7))
    before = dict(_build.LAUNCHES)

    assert all(torch.equal(a, b) for a, b in zip(tnorm.group_stats(x, 16), tnorm._stats_lazy(x, 16)))
    rows = tnorm._gn_plan(2, 64, 64, 16, 4, stats=True).rows
    plain = tnorm._stats_kernel_plain(x, 16, rows)
    assert all(torch.equal(a, b) for a, b in zip(tnorm.group_stats(x, 16, "plain"), plain))

    with pytest.raises(ValueError, match="CUDA"):
        tnorm.group_stats(x, 16, "kernel")
    with pytest.raises(ValueError):
        tnorm.group_stats(x, 16, "pallas")
    with pytest.raises(ValueError):
        tnorm.group_stats(x, 15)
    assert dict(_build.LAUNCHES) == before


def test_stats_kernel_is_forward_only():
    assert tnorm._stats_kernel.__wrapped__.__name__ == "_stats_kernel"
    with pytest.raises(ValueError, match="CUDA"):
        tnorm._stats_kernel(torch.ones(2, 64, 64, requires_grad=True), 16)


# gradients


def test_group_stats_vjp_matches_jax():
    x = _large_mean((2, 512, 64), seed=8)
    rng = np.random.default_rng(9)
    gm, gv = (rng.standard_normal((2, 16)).astype(np.float32) for _ in range(2))

    _, vjp = jax.vjp(lambda x: jnorm.group_stats(x, 16), jnp.asarray(x))
    (want,) = vjp((jnp.asarray(gm), jnp.asarray(gv)))

    xt = torch.from_numpy(x).requires_grad_()
    mean, var = tnorm.group_stats(xt, 16)
    torch.autograd.backward((mean, var), (torch.from_numpy(gm), torch.from_numpy(gv)))

    assert _rel_err(xt.grad, want) <= 1e-5

    # one output only: the other's cotangent is zero
    xt.grad = None
    tnorm.group_stats(xt, 16)[1].sum().backward()
    (want,) = vjp((jnp.zeros((2, 16)), jnp.ones((2, 16))))
    assert _rel_err(xt.grad, want) <= 1e-5


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("affine, mod", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 300, 48)])
def test_group_norm_vjp_matches_jax(shape, affine, mod, silu):
    rng = np.random.default_rng(10)
    B, C = shape[0], shape[-1]
    groups = 16
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    params = {
        "scale": (1 + 0.5 * rng.standard_normal(C)).astype(np.float32) if affine else None,
        "bias": (0.5 * rng.standard_normal(C)).astype(np.float32) if affine else None,
        "mod_scale": (0.3 * rng.standard_normal((B, C))).astype(np.float32) if mod else None,
        "mod_shift": (0.3 * rng.standard_normal((B, C))).astype(np.float32) if mod else None,
    }
    names = ["x"] + [k for k, v in params.items() if v is not None]
    arrays = [x] + [v for v in params.values() if v is not None]

    jfn = jnorm.group_norm_silu if silu else jnorm.group_norm
    tfn = tnorm.group_norm_silu if silu else tnorm.group_norm

    def jcall(*args):
        kw = dict(zip(names[1:], args[1:], strict=True))
        return jfn(args[0], groups, **kw)

    want, vjp = jax.vjp(jcall, *(jnp.asarray(a) for a in arrays))
    want_grads = vjp(jnp.asarray(g))

    tensors = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    got = tfn(tensors[0], groups, **dict(zip(names[1:], tensors[1:], strict=True)))
    got.backward(torch.from_numpy(g))

    assert _rel_err(got, want) <= 1e-5
    for name, t, w in zip(names, tensors, want_grads, strict=True):
        assert _rel_err(t.grad, w) <= 1e-5, name


def test_group_norm_backward_takes_the_saved_statistics(monkeypatch):
    # under grad the forward takes group_stats' route ('auto': lazy on the
    # CPU) once, for the backward; without grad, never
    seen = []
    lazy = tnorm._STATS["lazy"]
    monkeypatch.setitem(tnorm._STATS, "lazy", lambda x, groups: seen.append(x.shape) or lazy(x, groups))

    x = torch.from_numpy(_large_mean((2, 64, 64), seed=11))
    with torch.no_grad():
        tnorm.group_norm(x, 16)
    assert seen == []

    xg = x.clone().requires_grad_()
    y = tnorm.group_norm_silu(xg, 16)
    assert seen == [(2, 64, 64)]
    y.sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())

    # the kernel wrapper called directly stays forward-only
    with pytest.raises(ValueError, match="CUDA"):
        tnorm._group_norm_kernel(xg, torch.ones(2, 64), torch.zeros(2, 64), 16, 1e-5, False)
