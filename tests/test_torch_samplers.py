r"""The PyTorch port's schedules and samplers (`azula_tpu_torch.noise`,
`azula_tpu_torch.sample`) against the JAX package's, on the CPU.

The four schedules ported here, float32 against JAX's: the signal scale
within 2 ulp, the noise scale within 2 ulp but for the cosine schedule,
whose :math:`\sqrt{1 - \alpha_t^2 + \sigma_\min^2}` inherits the ulp of
:math:`\alpha_t` as an absolute error of :math:`\sigma_t^2` (5e-7, as
`test_torch_sample.py::test_vp_schedule_float32` bounds the VP schedule's).
The multistep samplers' float64 coefficient tables equal JAX's bit for bit.
Trajectories run the tiny `KarrasDenoiser(Modulated(UNet))` of
`test_torch_unet.py` (weights from `nn/convert.py`) for 8 steps, JAX as one
jitted scan, the port as its Python loop: within 1e-4 of max |reference|.
Two trajectories whose last step amplifies float32 rounding are held to the
port's float64 trajectory instead (`test_trajectory_against_float64`).
Stochastic steps take JAX's own normal draws, injected through the port's
`Sampler._normal`.
"""

import copy
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu import denoise as jdenoise
from azula_tpu import noise as jnoise
from azula_tpu import sample as jsample
from azula_tpu.linalg import covariance as jcov
from azula_tpu_torch import denoise as tdenoise
from azula_tpu_torch import noise as tnoise
from azula_tpu_torch import sample as tsample
from azula_tpu_torch.linalg import covariance as tcov

from test_torch_unet import _slice_pair

TOL = 1e-4
STEPS = 8

SCHEDULES = {
    "ve": lambda m: m.VESchedule(),
    "ve_narrow": lambda m: m.VESchedule(1e-2, 1e1),
    "cosine": lambda m: m.CosineSchedule(),
    "cosine_1e-2": lambda m: m.CosineSchedule(1e-2, 1e-2),
    "rectified": lambda m: m.RectifiedSchedule(),
    "elucidated": lambda m: m.ElucidatedSchedule(),
    "elucidated_rho5": lambda m: m.ElucidatedSchedule(0.01, 10.0, 5.0),
}


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))


def _rel_err(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# schedules


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    t = np.linspace(0, 1, 1001, dtype=np.float32)

    ja, js = SCHEDULES[name](jnoise)(jnp.asarray(t))
    ta, ts = SCHEDULES[name](tnoise)(torch.from_numpy(t))

    assert ta.dtype == ts.dtype == torch.float32
    assert _ulps(ta.numpy(), ja).max() <= 2

    js = np.asarray(js)
    if name.startswith("cosine"):
        np.testing.assert_allclose(ts.numpy() ** 2, js**2, rtol=0, atol=5e-7)
    else:
        assert _ulps(ts.numpy(), js).max() <= 2


@pytest.mark.parametrize("name", ["ve", "cosine", "rectified", "elucidated"])
def test_schedules_float64_on_the_host(name):
    # the multistep samplers' tables run the schedule on a float64 CPU
    # tensor where JAX runs it on a NumPy array
    t = np.linspace(0, 1, 65, dtype=np.float64)

    ja, js = SCHEDULES[name](jnoise)(t)
    ta, ts = SCHEDULES[name](tnoise)(torch.from_numpy(t))

    assert ta.dtype == ts.dtype == torch.float64
    np.testing.assert_allclose(np.broadcast_to(ta.numpy(), t.shape), np.broadcast_to(ja, t.shape), rtol=4e-16)
    np.testing.assert_allclose(ts.numpy(), js, rtol=4e-16)


# coefficient tables


@pytest.mark.parametrize("kind", ["poly", "exp", "exp_neg", "rosenbrock"])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_ab_coefficients_equal_jax(kind, order):
    times = np.linspace(1.0, 0.0, 17, dtype=np.float64)
    alpha, sigma = jnoise.VPSchedule(1e-2, 1e-2)(times)
    u = sigma / alpha if kind == "poly" else np.log(sigma) - np.log(alpha)

    want = jsample._ab_coefficients(u, order, kind)
    got = tsample._ab_coefficients(u, order, kind)

    assert got.dtype == np.float64 and got.shape == (16, order)
    np.testing.assert_array_equal(got, want)


MULTISTEP = ["zABSampler", "vABSampler", "zEABSampler", "xEABSampler", "REABSampler"]


def _gaussian_pair(schedule: str):
    r"""The analytical Gaussian denoiser of N(mu, diag(var)) in both packages."""

    rng = np.random.default_rng(5)
    mu = rng.standard_normal((4, 3)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, (4, 3)).astype(np.float32)

    jd = jdenoise.GaussianDenoiser(jnp.asarray(mu), jcov.DiagonalCovariance(jnp.asarray(var)), SCHEDULES[schedule](jnoise))
    td = tdenoise.GaussianDenoiser(
        torch.from_numpy(mu), tcov.DiagonalCovariance(torch.from_numpy(var)), SCHEDULES[schedule](tnoise)
    )
    return jd, td


@pytest.mark.parametrize("name", MULTISTEP)
def test_multistep_tables_match_jax(name):
    # the whole scaled table a trajectory uses: the schedule in float64 on
    # the host, the coefficients, the integral's scale
    jd, td = _gaussian_pair("cosine")
    jsam = getattr(jsample, name)(jd, order=3, steps=STEPS)
    tsam = getattr(tsample, name)(td, order=3, steps=STEPS)

    alpha, sigma = jd.schedule(jsam.timesteps_np)
    alpha = np.broadcast_to(np.asarray(alpha, np.float64), jsam.timesteps_np.shape)
    sigma = np.broadcast_to(np.asarray(sigma, np.float64), jsam.timesteps_np.shape)
    want = jsample._ab_coefficients(jsam._u(alpha, sigma), 3, jsam._kind)
    want = want * jsam._integral_scale(alpha, sigma)[:, None]

    np.testing.assert_allclose(tsam._table(), want, rtol=1e-13, atol=1e-15)


# trajectories


DETERMINISTIC = {
    "euler": lambda m, d: m.EulerSampler(d, steps=STEPS),
    # to t = 0.01: at t = 0 its correction divides by sigma_min = 1e-3 (see
    # test_trajectory_against_float64)
    "heun": lambda m, d: m.HeunSampler(d, stop=0.01, steps=STEPS),
    "ddim": lambda m, d: m.DDIMSampler(d, steps=STEPS),
    "pc_no_corrector": lambda m, d: m.PCSampler(d, corrections=0, steps=STEPS),
    "ito_eta0": lambda m, d: m.ItoSampler(d, eta=0.0, temperature=2.0, steps=STEPS),
    "zab3": lambda m, d: m.zABSampler(d, order=3, steps=STEPS),
    "vab2": lambda m, d: m.vABSampler(d, order=2, steps=STEPS),
    "zeab2": lambda m, d: m.zEABSampler(d, order=2, steps=STEPS),
    "xeab3": lambda m, d: m.xEABSampler(d, order=3, steps=STEPS),
    "reab2": lambda m, d: m.REABSampler(d, order=2, steps=STEPS),
}


@pytest.fixture(scope="module")
def unet_pair():
    jbackbone, td = _slice_pair("group", seed=41)
    return jdenoise.KarrasDenoiser(jbackbone, jnoise.VPSchedule()), td


def _x(shape=(2, 16, 16, 3), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", list(DETERMINISTIC))
def test_deterministic_trajectory_matches_jax(name, unet_pair):
    jd, td = unet_pair
    x = _x(seed=42)

    want = DETERMINISTIC[name](jsample, jd)(jnp.asarray(x))
    with torch.no_grad():
        got = DETERMINISTIC[name](tsample, td)(torch.from_numpy(x))

    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("schedule", ["ve_narrow", "cosine", "rectified", "elucidated_rho5"])
@pytest.mark.parametrize("name", ["euler", "zeab2"])
def test_schedule_trajectory_matches_jax(name, schedule):
    # the new schedules through the analytical denoiser, whose posterior mean
    # needs no backbone
    jd, td = _gaussian_pair(schedule)
    x = _x((5, 4, 3), seed=43)

    want = DETERMINISTIC[name](jsample, jd)(jnp.asarray(x))
    got = DETERMINISTIC[name](tsample, td)(torch.from_numpy(x))

    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("case", ["heun_unet_to_0", "xeab3_cosine"])
def test_trajectory_against_float64(case, unet_pair):
    # Two trajectories whose last step amplifies float32 rounding: Heun's
    # correction at t = 0 divides by sigma_min = 1e-3, and xEAB-3 on the
    # cosine schedule ends on its steepest coefficients. JAX's fused float32
    # lies 1.75e-4 and 1.48e-4 from the float64 trajectory there, the port
    # 1.6e-5 and 2.4e-5: each is held to the float64 trajectory of the port.
    if case == "heun_unet_to_0":
        jd, td = unet_pair
        td64 = copy.deepcopy(td).double()
        x = _x(seed=42)

        def make(m, d):
            return m.HeunSampler(d, steps=STEPS)
    else:
        jd, td = _gaussian_pair("cosine")
        td64 = tdenoise.GaussianDenoiser(td.mean.double(), tcov.DiagonalCovariance(td.cov.D.double()), td.schedule)
        x = _x((5, 4, 3), seed=43)

        def make(m, d):
            return DETERMINISTIC["xeab3"](m, d)

    want = make(jsample, jd)(jnp.asarray(x))
    with torch.no_grad():
        got = make(tsample, td)(torch.from_numpy(x))
        exact = make(tsample, td64)(torch.from_numpy(x).double()).numpy()

    assert _rel_err(got, exact) <= TOL
    assert _rel_err(np.asarray(want), exact) <= 1e-3
    assert _rel_err(got, want) <= 1e-3


class _Draws:
    r"""JAX's normal draws, handed to the port's `_normal` in order."""

    def __init__(self, draws) -> None:
        self.draws = [np.asarray(d) for d in draws]

    def __call__(self, generator, shape, like):
        draw = self.draws.pop(0)
        assert tuple(shape) == draw.shape
        return torch.from_numpy(draw.copy()).to(like.dtype)


STOCHASTIC = {
    "ddpm": (lambda m, d: m.DDPMSampler(d, steps=STEPS), lambda k, shape: [jax.random.normal(k, shape)]),
    "ddim_eta": (lambda m, d: m.DDIMSampler(d, eta=0.7, steps=STEPS), lambda k, shape: [jax.random.normal(k, shape)]),
    "ito": (lambda m, d: m.ItoSampler(d, eta=0.8, temperature=1.5, steps=STEPS), lambda k, shape: [jax.random.normal(k, shape)]),
    "pc": (
        lambda m, d: m.PCSampler(d, corrections=2, delta=0.05, steps=STEPS),
        lambda k, shape: [jax.random.normal(jax.random.fold_in(k, j), shape) for j in range(2)],
    ),
}


@pytest.mark.parametrize("name", list(STOCHASTIC))
def test_stochastic_step_matches_jax(name, unet_pair):
    make, draws = STOCHASTIC[name]
    jd, td = unet_pair
    jsam, tsam = make(jsample, jd), make(tsample, td)
    assert tsam.requires_generator

    x = _x(seed=44)
    for i, (t, s) in enumerate([(1.0, 0.875), (0.5, 0.375), (0.125, 0.0)]):
        key = jax.random.fold_in(jax.random.key(7), i)
        want = jsam.step(jnp.asarray(x), jnp.float32(t), jnp.float32(s), key=key)

        tsam._normal = _Draws(draws(key, x.shape))
        with torch.no_grad():
            got = tsam.step(torch.from_numpy(x), torch.tensor(t), torch.tensor(s), generator=torch.Generator())

        assert not tsam._normal.draws
        assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("name", list(STOCHASTIC))
def test_stochastic_samplers_need_a_generator(name):
    _, td = _gaussian_pair("cosine")
    tsam = STOCHASTIC[name][0](tsample, td)
    x = torch.from_numpy(_x((5, 4, 3)))

    with pytest.raises(ValueError, match="generator"):
        tsam(x)

    y = tsam(x, generator=torch.Generator().manual_seed(0))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def test_stochastic_trajectory_draws_from_the_generator():
    # the same seed gives the same trajectory, another seed another
    _, td = _gaussian_pair("cosine")
    sampler = tsample.DDPMSampler(td, steps=STEPS)
    x = torch.from_numpy(_x((5, 4, 3)))

    a = sampler(x, generator=torch.Generator().manual_seed(1))
    b = sampler(x, generator=torch.Generator().manual_seed(1))
    c = sampler(x, generator=torch.Generator().manual_seed(2))

    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("name", ["euler", "zeab2"])
def test_progress_prints_its_line(name, capsys):
    _, td = _gaussian_pair("cosine")
    sampler = DETERMINISTIC[name](tsample, td)
    sampler.progress = True
    x = torch.from_numpy(_x((5, 4, 3)))

    y = sampler(x)
    err = capsys.readouterr().err

    assert y.shape == x.shape
    assert err.count("\rsampling ") == STEPS
    assert f"sampling {STEPS}/{STEPS} (" in err and err.endswith("\n")
    assert "steps/s, ETA" in err
