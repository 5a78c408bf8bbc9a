r"""The PyTorch port's guidance methods (`azula_tpu_torch.guidance`: MMPS,
TMPD, DiffPIR, JFPS, DPS, PGDM, RePaint, TDS) against the JAX package's, on
the CPU, in float32, on the tiny `KarrasDenoiser(Modulated(UNet))` of
`test_torch_unet.py` (weights from `nn/convert.py`) with a left-half
inpainting operator, as `bench.py`'s mmps32 builds it.

The denoiser wrappers are compared by their posterior mean at two times,
the sampler subclasses by one step with JAX's own normal draws injected
through the port's `Sampler._normal`, TDS by a 4-step trajectory with JAX's
draws and ancestor indices injected (`_normal`, `_resample`). Every
comparison is within 1e-4 of max |reference|: the vector-Jacobian products
sum the backward in other orders (float32), and the solvers add a few
float32 recurrences. TMPD divides by a variance that crosses zero on a
random network, so it is held to JAX on the analytical Gaussian denoiser
and to the float64 result on the UNet.
"""

import copy
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu import denoise as jdenoise
from azula_tpu import guidance as jguidance
from azula_tpu import noise as jnoise
from azula_tpu import sample as jsample
from azula_tpu.linalg import covariance as jcov
from azula_tpu_torch import denoise as tdenoise
from azula_tpu_torch import guidance as tguidance
from azula_tpu_torch import noise as tnoise
from azula_tpu_torch import sample as tsample
from azula_tpu_torch.linalg import covariance as tcov

from test_torch_samplers import _Draws, _rel_err
from test_torch_unet import _slice_pair

TOL = 1e-4
B, SIDE = 2, 16
SHAPE = (B, SIDE, SIDE, 3)


def _x(shape=SHAPE, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jA(x):
    return x[..., : SIDE // 2, :].reshape(*x.shape[:-3], -1)


def tA(x):
    return x[..., : SIDE // 2, :].reshape(*x.shape[:-3], -1)


def jA_inv(y):
    left = y.reshape(*y.shape[:-1], SIDE, SIDE // 2, 3)
    return jnp.concatenate([left, jnp.zeros_like(left)], axis=-2)


def tA_inv(y):
    left = y.reshape(*y.shape[:-1], SIDE, SIDE // 2, 3)
    return torch.cat([left, torch.zeros_like(left)], dim=-2)


@pytest.fixture(scope="module")
def problem():
    r"""The tiny denoiser in both packages and an observation of the left
    half of a seeded image with noise 0.05."""

    jbackbone, td = _slice_pair("group", seed=51)
    jd = jdenoise.KarrasDenoiser(jbackbone, jnoise.VPSchedule())

    x_true = _x(seed=52)
    y = jA(x_true) + 0.05 * _x((B, SIDE * SIDE // 2 * 3), seed=53)

    return jd, td, np.asarray(y, np.float32), x_true


WRAPPERS = {
    "mmps_gmres1": lambda g, c, d, y, A: g.MMPSDenoiser(d, y, A, c.IsotropicCovariance(0.05**2), iterations=1),
    "mmps_gmres3": lambda g, c, d, y, A: g.MMPSDenoiser(d, y, A, c.IsotropicCovariance(0.05**2), iterations=3),
    "mmps_cg2": lambda g, c, d, y, A: g.MMPSDenoiser(d, y, A, c.IsotropicCovariance(0.05**2), solver="cg", iterations=2),
    "diffpir_gmres2": lambda g, c, d, y, A: g.DiffPIRDenoiser(d, y, A, 0.05**2, lmbda=1.0, iterations=2),
    "diffpir_cg3": lambda g, c, d, y, A: g.DiffPIRDenoiser(d, y, A, 0.05**2, solver="cg", iterations=3),
    "jfps_cg2": lambda g, c, d, y, A: g.JFPSDenoiser(
        d, y, A, c.IsotropicCovariance(0.05**2), c.IsotropicCovariance(1.0), iterations=2
    ),
    "jfps_gmres2": lambda g, c, d, y, A: g.JFPSDenoiser(
        d, y, A, c.IsotropicCovariance(0.05**2), c.IsotropicCovariance(0.7), solver="gmres", iterations=2
    ),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_denoiser_wrappers_match_jax(name, problem):
    jd, td, y, _ = problem
    jguided = WRAPPERS[name](jguidance, jcov, jd, jnp.asarray(y), jA)
    tguided = WRAPPERS[name](tguidance, tcov, td, torch.from_numpy(y), tA)
    assert tguided.schedule is td.schedule

    x = _x(seed=54)
    for t in (0.3, 0.8):
        want = jguided(jnp.asarray(x), jnp.float32(t)).mean
        with torch.no_grad():
            got = tguided(torch.from_numpy(x), torch.tensor(t)).mean

        assert got.dtype == torch.float32 and got.shape == SHAPE
        assert not got.requires_grad and got.grad_fn is None
        assert _rel_err(got, want) <= TOL


def _tmpd(g, d, y, A):
    return g.TMPDenoiser(d, y, A, 0.05**2)


def test_tmpd_matches_jax(problem):
    # TMPD's variance A cov_x A^T 1 is a variance where the denoiser's
    # Jacobian is PSD, as the analytical Gaussian denoiser's is
    _, _, y, _ = problem
    rng = np.random.default_rng(60)
    mean = rng.standard_normal(SHAPE[1:]).astype(np.float32)
    var = rng.uniform(0.5, 2.0, SHAPE[1:]).astype(np.float32)

    jd = jdenoise.GaussianDenoiser(jnp.asarray(mean), jcov.DiagonalCovariance(jnp.asarray(var)), jnoise.VPSchedule())
    td = tdenoise.GaussianDenoiser(
        torch.from_numpy(mean), tcov.DiagonalCovariance(torch.from_numpy(var)), tnoise.VPSchedule()
    )
    jguided, tguided = _tmpd(jguidance, jd, jnp.asarray(y), jA), _tmpd(tguidance, td, torch.from_numpy(y), tA)

    x = _x(seed=61)
    for t in (0.3, 0.8):
        want = jguided(jnp.asarray(x), jnp.float32(t)).mean
        with torch.no_grad():
            got = tguided(torch.from_numpy(x), torch.tensor(t)).mean

        assert _rel_err(got, want) <= TOL


def test_tmpd_on_a_random_network_against_float64(problem):
    # On the random tiny UNet the Jacobian is not PSD: var_y + A cov_x A^T 1
    # crosses zero (from -190 to 223, 0.01 at its smallest, at t = 0.8), and
    # the division amplifies float32 rounding. JAX lies 1.1e-4 and 2.3e-3
    # from the float64 result at t = 0.3 and 0.8, the port 1.4e-4 and
    # 3.1e-3: both are held to the port's float64 result at 1e-2.
    jd, td, y, _ = problem
    td64 = copy.deepcopy(td).double()
    jguided = _tmpd(jguidance, jd, jnp.asarray(y), jA)
    tguided = _tmpd(tguidance, td, torch.from_numpy(y), tA)
    tguided64 = _tmpd(tguidance, td64, torch.from_numpy(y).double(), tA)

    x = _x(seed=54)
    for t in (0.3, 0.8):
        want = jguided(jnp.asarray(x), jnp.float32(t)).mean
        with torch.no_grad():
            got = tguided(torch.from_numpy(x), torch.tensor(t)).mean
            exact = tguided64(torch.from_numpy(x).double(), torch.tensor(t, dtype=torch.float64)).mean.numpy()

        assert _rel_err(got, exact) <= 1e-2
        assert _rel_err(np.asarray(want), exact) <= 1e-2


def test_mmps_ddim_trajectory_matches_jax(problem):
    # mmps32's sampler: DDIM under MMPS with gmres-1, 4 steps
    jd, td, y, _ = problem
    x = _x(seed=55)

    jguided = WRAPPERS["mmps_gmres1"](jguidance, jcov, jd, jnp.asarray(y), jA)
    tguided = WRAPPERS["mmps_gmres1"](tguidance, tcov, td, torch.from_numpy(y), tA)

    want = jsample.DDIMSampler(jguided, steps=4)(jnp.asarray(x))
    with torch.no_grad():
        got = tsample.DDIMSampler(tguided, steps=4)(torch.from_numpy(x))

    assert _rel_err(got, want) <= TOL


def _repaint_draws(key, iterations: int):
    draws = []
    for i in range(iterations):
        k0, k1, k2 = jax.random.split(jax.random.fold_in(key, i), 3)
        draws += [jax.random.normal(k0, SHAPE), jax.random.normal(k1, SHAPE), jax.random.normal(k2, SHAPE)]
    return draws


MASK = np.broadcast_to(np.arange(SIDE)[None, :, None] < SIDE // 2, (SIDE, SIDE, 3))

STEPPERS = {
    "dps": (
        lambda m, d, y, A, Ai, obs, mask: m.DPSSampler(d, y, A, zeta=0.3, steps=8),
        lambda key: [jax.random.normal(key, SHAPE)],
    ),
    "pgdm": (
        lambda m, d, y, A, Ai, obs, mask: m.PGDMSampler(d, y, A, Ai, eta=0.5, steps=8),
        lambda key: [jax.random.normal(key, SHAPE)],
    ),
    "repaint": (
        lambda m, d, y, A, Ai, obs, mask: m.RePaintSampler(d, obs, mask, iterations=2, eta=0.5, steps=8),
        lambda key: _repaint_draws(key, 2),
    ),
}


@pytest.mark.parametrize("name", list(STEPPERS))
def test_guided_steps_match_jax(name, problem):
    make, draws = STEPPERS[name]
    jd, td, y, x_true = problem
    observed = np.where(MASK, x_true, 0.0).astype(np.float32)

    jsam = make(jguidance, jd, jnp.asarray(y), jA, jA_inv, jnp.asarray(observed), jnp.asarray(MASK))
    tsam = make(
        tguidance, td, torch.from_numpy(y), tA, tA_inv, torch.from_numpy(observed), torch.from_numpy(MASK.copy())
    )
    assert tsam.requires_generator

    x = _x(seed=56)
    for i, (t, s) in enumerate([(1.0, 0.875), (0.5, 0.375), (0.125, 0.0)]):
        key = jax.random.fold_in(jax.random.key(9), i)
        want = jsam.step(jnp.asarray(x), jnp.float32(t), jnp.float32(s), key=key)

        tsam._normal = _Draws(draws(key))
        with torch.no_grad():
            got = tsam.step(torch.from_numpy(x), torch.tensor(t), torch.tensor(s), generator=torch.Generator())

        assert not tsam._normal.draws
        assert not got.requires_grad
        assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("threshold", [1.0, 0.5, 0.0])
def test_tds_trajectory_matches_jax(threshold, problem):
    jd, td, y, _ = problem
    K, steps = 4, 4
    y0 = y[0]

    def twist(A, y, sum_):
        def fn(x_hat, ratio):
            return -sum_((y - A(x_hat)) ** 2) / (2 * (0.05**2 + ratio**2))

        return fn

    jtwist = twist(jA, jnp.asarray(y0), lambda e: jnp.sum(e, axis=-1))
    ttwist = twist(tA, torch.from_numpy(y0), lambda e: torch.sum(e, dim=-1))

    jsam = jguidance.TDSSampler(jd, jtwist, resample_threshold=threshold, return_weights=True, steps=steps)
    tsam = tguidance.TDSSampler(td, ttwist, resample_threshold=threshold, return_weights=True, steps=steps)

    x = _x((K, SIDE, SIDE, 3), seed=57)
    key = jax.random.key(11)
    want_x, want_w = jsam(jnp.asarray(x), key=key)

    # JAX's draws, step by step: the ancestors from its categorical on the
    # port's weights, the proposal's normal
    keys = [jax.random.split(jax.random.fold_in(key, i)) for i in range(steps)]
    resamples = iter(k[0] for k in keys)
    tsam._resample = lambda log_w, generator: torch.from_numpy(
        np.asarray(jax.random.categorical(next(resamples), jnp.asarray(log_w.numpy()), shape=(K,))).astype(np.int64)
    )
    tsam._normal = _Draws([jax.random.normal(k[1], x.shape) for k in keys])

    with torch.no_grad():
        got_x, got_w = tsam(torch.from_numpy(x), generator=torch.Generator())

    assert not tsam._normal.draws
    assert got_w.shape == (K,) and got_w.dtype == torch.float32
    assert _rel_err(got_x, want_x) <= TOL
    assert _rel_err(got_w, want_w) <= TOL


def test_tds_runs_on_its_generator(problem):
    _, td, y, _ = problem

    def twist(x_hat, ratio):
        return -torch.sum((torch.from_numpy(y[0]) - tA(x_hat)) ** 2, dim=-1) / (2 * (0.05**2 + ratio**2))

    sampler = tguidance.TDSSampler(td, twist, resample_threshold=1.0, steps=3)
    x = torch.from_numpy(_x((4, SIDE, SIDE, 3), seed=58))

    with torch.no_grad():
        a = sampler(x, generator=torch.Generator().manual_seed(0))
        b = sampler(x, generator=torch.Generator().manual_seed(0))

    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


GRAD_USERS = {
    "mmps": lambda d, y: tguidance.MMPSDenoiser(d, y, tA, tcov.IsotropicCovariance(0.05**2)),
    "tmpd": lambda d, y: tguidance.TMPDenoiser(d, y, tA, 0.05**2),
    "diffpir": lambda d, y: tguidance.DiffPIRDenoiser(d, y, tA, 0.05**2),
    "jfps": lambda d, y: tguidance.JFPSDenoiser(d, y, tA, tcov.IsotropicCovariance(0.05**2), tcov.IsotropicCovariance(1.0)),
    "dps": lambda d, y: tguidance.DPSSampler(d, y, tA, steps=2),
    "pgdm": lambda d, y: tguidance.PGDMSampler(d, y, tA, tA_inv, steps=2),
    "tds": lambda d, y: tguidance.TDSSampler(d, lambda x_hat, r: -torch.sum((y[0] - tA(x_hat)) ** 2, dim=-1), steps=2),
}


@pytest.mark.parametrize("name", list(GRAD_USERS))
def test_vjps_refuse_inference_mode(name, problem):
    # autograd cannot record under inference_mode: a clear error, not zeros
    _, td, y, _ = problem
    method = GRAD_USERS[name](td, torch.from_numpy(y))
    x = torch.from_numpy(_x(seed=59))

    with torch.inference_mode(), pytest.raises(RuntimeError, match="inference_mode"):
        if isinstance(method, tsample.Sampler):
            method(x, generator=torch.Generator())
        else:
            method(x, torch.tensor(0.5))

    with torch.no_grad():
        if isinstance(method, tsample.Sampler):
            out = method(x, generator=torch.Generator())
        else:
            out = method(x, torch.tensor(0.5)).mean

    assert bool(torch.isfinite(out).all()) and out.grad_fn is None
