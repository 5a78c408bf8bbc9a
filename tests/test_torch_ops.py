r"""The PyTorch port's operators (`azula_tpu_torch.ops`) against the JAX package's,
on the CPU: the same numpy inputs through both, with stated tolerances.

On the CPU the port runs its plain versions; the CUDA kernels are held against
these same plain versions on the card by `chip_smoke.py`.
"""

import functools
import itertools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu.ops import attention as jattention
from azula_tpu.ops import norm as jnorm
from azula_tpu_torch.ops import _build
from azula_tpu_torch.ops import attention as tattention
from azula_tpu_torch.ops import fused_msa as tfused
from azula_tpu_torch.ops import norm as tnorm

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# Relative to max |reference|. float32: both sides compute the same float32
# formulas, summed in other orders (a few ulp; measured <= 6e-7). bfloat16:
# the outputs are rounded to 8 bits of mantissa (2^-8 ~ 4e-3), and the two
# frameworks may round a value that lies near a rounding boundary either way
# (measured <= 2.3e-3, one such step).
TOL = {"float32": 5e-6, "bfloat16": 1e-2}


def _to_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _to_jax(a: np.ndarray, dtype) -> jax.Array:
    return jnp.asarray(a).astype(dtype)


def _as_f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _as_f64(got), _as_f64(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.partial(jax.jit, static_argnames=("groups", "silu"))
def _jax_gn(x, scale, bias, mod_scale, mod_shift, groups, silu):
    fn = jnorm.group_norm_silu if silu else jnorm.group_norm
    return fn(x, groups, scale=scale, bias=bias, mod_scale=mod_scale, mod_shift=mod_shift)


def _gn_inputs(shape, affine, mod, seed=0, offset=0.5):
    rng = np.random.default_rng(seed)
    B, HW, C = shape
    x = (rng.standard_normal(shape) * 2.0 + offset).astype(np.float32)
    scale = (1 + 0.5 * rng.standard_normal(C)).astype(np.float32) if affine else None
    bias = (0.5 * rng.standard_normal(C)).astype(np.float32) if affine else None
    s = (0.3 * rng.standard_normal((B, C))).astype(np.float32) if mod else None
    t = (0.3 * rng.standard_normal((B, C))).astype(np.float32) if mod else None
    return x, scale, bias, s, t


def _run_gn(x, scale, bias, s, t, dtype, groups, silu, implementation=None):
    jd, td = DTYPES[dtype]

    def opt(a, conv, d):
        return None if a is None else conv(a, d)

    want = _jax_gn(
        _to_jax(x, jd),
        opt(scale, _to_jax, jnp.float32),
        opt(bias, _to_jax, jnp.float32),
        opt(s, _to_jax, jnp.float32),
        opt(t, _to_jax, jnp.float32),
        groups=groups,
        silu=silu,
    )

    fn = tnorm.group_norm_silu if silu else tnorm.group_norm
    got = fn(
        _to_torch(x, td),
        groups,
        scale=opt(scale, _to_torch, torch.float32),
        bias=opt(bias, _to_torch, torch.float32),
        mod_scale=opt(s, _to_torch, torch.float32),
        mod_shift=opt(t, _to_torch, torch.float32),
        implementation=implementation,
    )

    assert got.dtype == td
    assert tuple(got.shape) == tuple(want.shape)

    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 256, 128), (1, 1024, 256)])
@pytest.mark.parametrize(
    "affine,mod,silu", list(itertools.product([False, True], repeat=3))
)
def test_group_norm_matches_jax(shape, dtype, affine, mod, silu):
    x, scale, bias, s, t = _gn_inputs(shape, affine, mod)

    got, want = _run_gn(x, scale, bias, s, t, dtype, groups=32, silu=silu)

    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_exact_at_large_mean(silu):
    # |mean| / std = 1e4: the raw E[x^2] - E[x]^2 fold would cancel to noise
    # (ulp(1e8) = 8 against a variance of 1). The shifted moments keep the
    # variance exact; what remains is the float32 rounding of x itself
    # (ulp(1e4) ~ 1e-3), felt by both sides in x * A + B. Hence an absolute
    # tolerance of a few such ulps on outputs of order 1.
    x, scale, bias, s, t = _gn_inputs((2, 256, 64), affine=True, mod=True, seed=1, offset=1e4)
    x = (x - 1e4) * 0.5 + 1e4  # std 1 around 1e4

    got, want = _run_gn(x, scale, bias, s, t, "float32", groups=32, silu=silu)

    assert np.abs(_as_f64(got) - _as_f64(want)).max() <= 5e-3
    assert np.abs(_as_f64(want)).max() > 0.5  # the output is normalized, not flushed


def test_group_norm_layouts():
    # (B, H, W, C) goes through as (B, HW, C); groups never exceed channels
    x, scale, bias, _, _ = _gn_inputs((2, 64, 64), affine=True, mod=False)
    x4 = x.reshape(2, 8, 8, 64)

    want = jnorm.group_norm(jnp.asarray(x4), 32, scale=jnp.asarray(scale), bias=jnp.asarray(bias))
    got = tnorm.group_norm(torch.from_numpy(x4), 32, scale=torch.from_numpy(scale), bias=torch.from_numpy(bias))

    assert got.shape == (2, 8, 8, 64)
    assert _rel_err(got, want) <= TOL["float32"]


def test_group_norm_implementations():
    x, *_ = _gn_inputs((2, 64, 64), affine=False, mod=False)
    xt = torch.from_numpy(x)

    plain = tnorm.group_norm(xt, 32, implementation="plain")
    assert torch.equal(tnorm.group_norm(xt, 32), plain)

    with pytest.raises(ValueError):
        tnorm.group_norm(xt, 32, implementation="kernel")
    with pytest.raises(ValueError):
        tnorm.group_norm(xt, 32, implementation="pallas")
    with pytest.raises(ValueError):
        tnorm.group_norm(xt, 30)


def _attention_inputs(B, H, L, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("L", [64, 100, 256])
def test_attention_matches_jax(L, D, dtype):
    # JAX on the CPU always takes `_xla_attention`, which the plain version
    # mirrors step for step (float32 logits, bf16 weights before the value
    # product, division after).
    jd, td = DTYPES[dtype]
    q, k, v = _attention_inputs(2, 2, L, D)

    want = jattention.dot_product_attention(*(_to_jax(a, jd) for a in (q, k, v)))
    got = tattention.dot_product_attention(*(_to_torch(a, td) for a in (q, k, v)))

    assert got.dtype == td and tuple(got.shape) == (2, 2, L, D)
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_attention_masks_match_jax(kind, dtype):
    jd, td = DTYPES[dtype]
    q, k, v = _attention_inputs(2, 2, 64, 32, seed=1)
    rng = np.random.default_rng(2)

    if kind == "bool":
        mask = rng.random((2, 1, 64, 64)) < 0.7
        mask[..., 0] = True  # no row fully masked
        jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    else:
        mask = (rng.standard_normal((64, 64)) * 2).astype(np.float32)
        jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)

    want = jattention.dot_product_attention(*(_to_jax(a, jd) for a in (q, k, v)), mask=jmask)
    got = tattention.dot_product_attention(*(_to_torch(a, td) for a in (q, k, v)), mask=tmask)

    assert _rel_err(got, want) <= TOL[dtype]


def test_attention_scale_and_implementations():
    q, k, v = (torch.from_numpy(a) for a in _attention_inputs(1, 2, 64, 32))

    want = jattention.dot_product_attention(*(jnp.asarray(a.numpy()) for a in (q, k, v)), scale=0.3)
    got = tattention.dot_product_attention(q, k, v, scale=0.3, implementation="plain")
    assert _rel_err(got, want) <= TOL["float32"]

    with pytest.raises(ValueError):
        tattention.dot_product_attention(q, k, v, implementation="kernel")
    with pytest.raises(ValueError):
        tattention.dot_product_attention(q, k, v, implementation="xla")
    # as JAX requires a `key`
    with pytest.raises(ValueError, match="generator"):
        tattention.dot_product_attention(q, k, v, dropout_rate=0.1)


def test_no_kernel_launch_on_cpu():
    before = dict(_build.LAUNCHES)

    x, *_ = _gn_inputs((2, 64, 64), affine=False, mod=False)
    tnorm.group_norm_silu(torch.from_numpy(x), 32)
    tnorm.group_norm(torch.from_numpy(x), 32)
    q, k, v = (torch.from_numpy(a) for a in _attention_inputs(1, 2, 64, 32))
    tattention.dot_product_attention(q, k, v)

    assert dict(_build.LAUNCHES) == before
    assert all(_build.LAUNCHES[name] == 0 for name in ("group_norm", "group_norm_silu", "attention_fwd"))


def test_forward_only_backward_raises():
    launch = _build.forward_only("toy", "ROADMAP X")(lambda x, s: x * s)

    x = torch.ones(3, requires_grad=True)
    y = launch(x, 2.0)
    assert torch.equal(y.detach(), torch.full((3,), 2.0)) and y.requires_grad
    with pytest.raises(NotImplementedError, match=r"the toy kernel has no backward yet \(ROADMAP X\)"):
        y.sum().backward()
    assert x.grad is None

    with torch.inference_mode():
        assert not launch(torch.ones(3), 2.0).requires_grad


@pytest.mark.parametrize(
    "wrapper, args",
    [
        (
            tnorm._group_norm_kernel,
            lambda: (torch.ones(2, 64, 64), torch.ones(2, 64), torch.zeros(2, 64), 32, 1e-5, True),
        ),
        (tattention._attention_kernel, lambda: (*(torch.ones(1, 2, 64, 32) for _ in range(3)), 0.1)),
        (tattention._attention_max_free_kernel, lambda: (*(torch.ones(1, 2, 640, 64) for _ in range(3)), 0.1)),
        (tfused._fused_msa_kernel, lambda: (torch.ones(1, 128, 384), None, None, 2, 1e-5, 0.1)),
    ],
)
def test_kernel_wrappers_are_forward_only(wrapper, args):
    # the guard wraps the whole wrapper: its checks still run, here the device's
    assert wrapper.__wrapped__.__name__ == wrapper.__name__
    x, *rest = args()
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(x.requires_grad_(), *rest)
