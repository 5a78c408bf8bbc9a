r"""The PyTorch port's schedule and DDIM sampler (`azula_tpu_torch.noise`,
`azula_tpu_torch.sample`) against the JAX package's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu import denoise as jdenoise
from azula_tpu import noise as jnoise
from azula_tpu import sample as jsample
from azula_tpu_torch import denoise as tdenoise
from azula_tpu_torch import noise as tnoise
from azula_tpu_torch import sample as tsample


class _JaxGaussian(jdenoise.Denoiser):
    r"""Exact posterior of X ~ N(0, I): mean alpha x / (alpha^2 + sigma^2)."""

    def __init__(self, schedule) -> None:
        self.schedule = schedule

    def __call__(self, x_t, t, **kwargs):
        alpha_t, sigma_t = jdenoise.broadcast_scales(*self.schedule(t), x_t)
        d = alpha_t**2 + sigma_t**2
        return jdenoise.GaussianPosterior(mean=alpha_t * x_t / d, var=sigma_t**2 / d)


class _TorchGaussian(tdenoise.Denoiser):
    def __init__(self, schedule) -> None:
        super().__init__()
        self.schedule = schedule

    def forward(self, x_t, t, **kwargs):
        alpha_t, sigma_t = tdenoise.broadcast_scales(*self.schedule(t), x_t)
        d = alpha_t**2 + sigma_t**2
        return tdenoise.GaussianPosterior(mean=alpha_t * x_t / d, var=sigma_t**2 / d)


def _schedules():
    return jnoise.VPSchedule(1e-2, 1e-2), tnoise.VPSchedule(1e-2, 1e-2)


def test_vp_schedule_float32():
    # Same float32 formula on both sides, but XLA's exp and PyTorch's differ
    # by one ulp on ~10% of inputs. sigma = sqrt(1 - alpha^2 + sigma_min^2)
    # then inherits that ulp as an absolute error of sigma^2 (~1.2e-7 per ulp
    # of alpha near 1), which is a large relative error where sigma is small.
    js, ts = _schedules()
    t = np.linspace(0, 1, 1001, dtype=np.float32)

    ja, jsig = js(jnp.asarray(t))
    ta, tsig = ts(torch.from_numpy(t))

    assert ta.dtype == torch.float32
    np.testing.assert_array_max_ulp(ta.numpy(), np.asarray(ja), maxulp=1)
    np.testing.assert_allclose(tsig.numpy() ** 2, np.asarray(jsig) ** 2, rtol=0, atol=5e-7)


def test_vp_schedule_float64(x64):
    js, ts = _schedules()
    t = np.linspace(0, 1, 1001, dtype=np.float64)

    ja, jsig = js(jnp.asarray(t))
    ta, tsig = ts(torch.from_numpy(t))

    assert np.asarray(ja).dtype == np.float64 and ta.dtype == torch.float64
    np.testing.assert_array_max_ulp(ta.numpy(), np.asarray(ja), maxulp=1)
    np.testing.assert_allclose(tsig.numpy() ** 2, np.asarray(jsig) ** 2, rtol=0, atol=1e-15)


def _jax_times(sampler, dtype):
    # the times as the JAX trajectory sees them: inside `jit`, in x's dtype
    return np.asarray(jax.jit(lambda x: sampler.timesteps.astype(x.dtype))(jnp.zeros((), dtype)))


@pytest.mark.parametrize("steps", [4, 10, 64, 256])
@pytest.mark.parametrize("start,stop", [(1.0, 0.0), (0.9, 0.05)])
def test_timesteps_equal_jax(steps, start, stop):
    # Bit for bit. (At 1000 steps XLA's generated code contracts the linspace
    # arithmetic into FMAs and moves ~40% of the times by an ulp; ROADMAP C.)
    js, ts = _schedules()
    jsam = jsample.DDIMSampler(_JaxGaussian(js), start=start, stop=stop, steps=steps)
    tsam = tsample.DDIMSampler(_TorchGaussian(ts), start=start, stop=stop, steps=steps)

    want = _jax_times(jsam, jnp.float32)

    np.testing.assert_array_equal(tsam.timesteps.numpy(), want)
    np.testing.assert_array_equal(
        tsample._linspace(start, stop, steps + 1, torch.float32).numpy(), want
    )


def test_timesteps_equal_jax_float64(x64):
    jsam = jsample.DDIMSampler(_JaxGaussian(_schedules()[0]), steps=64)

    want = _jax_times(jsam, jnp.float64)
    got = tsample._linspace(1.0, 0.0, 65, torch.float64).numpy()

    assert want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def _x(shape=(4, 8, 8, 3), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_ddim_step_matches_jax():
    js, ts = _schedules()
    jsam = jsample.DDIMSampler(_JaxGaussian(js), steps=4)
    tsam = tsample.DDIMSampler(_TorchGaussian(ts), steps=4)
    x = _x()

    for t, s in [(1.0, 0.75), (0.5, 0.25), (0.25, 0.0)]:
        want = jsam.step(jnp.asarray(x), jnp.float32(t), jnp.float32(s))
        got = tsam.step(torch.from_numpy(x), torch.tensor(t), torch.tensor(s))

        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_ddim_trajectory_matches_jax():
    # JAX runs one jitted scan, the port a Python loop over the same steps
    js, ts = _schedules()
    x = _x(seed=1)

    want = jsample.DDIMSampler(_JaxGaussian(js), steps=16)(jnp.asarray(x))
    got = tsample.DDIMSampler(_TorchGaussian(ts), steps=16)(torch.from_numpy(x))

    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ddim_eta_needs_generator():
    tsam = tsample.DDIMSampler(_TorchGaussian(_schedules()[1]), eta=1.0, steps=4)
    x = torch.from_numpy(_x())

    assert tsam.requires_generator
    with pytest.raises(ValueError):
        tsam(x)

    y = tsam(x, generator=torch.Generator().manual_seed(0))
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_init_shape_and_moments():
    # Torch and JAX generators never agree, so only the law is compared:
    # x_T ~ N(alpha_T mean, alpha_T^2 var + sigma_T^2).
    js, ts = _schedules()
    tsam = tsample.DDIMSampler(_TorchGaussian(ts), steps=64)
    jsam = jsample.DDIMSampler(_JaxGaussian(js), steps=64)

    g = torch.Generator().manual_seed(0)
    x = tsam.init((64, 32, 32, 3), mean=0.5, var=2.0, generator=g)

    assert x.shape == (64, 32, 32, 3) and x.dtype == torch.float32 and x.device.type == "cpu"

    ref = jsam.init(jax.random.key(0), (64, 32, 32, 3), mean=0.5, var=2.0)
    alpha, sigma = js(1.0)
    mean, std = alpha * 0.5, np.sqrt(alpha**2 * 2.0 + sigma**2)

    n = x.numel()  # 196608 draws: the standard errors are std / 443 and std / 313
    for sample in (x.numpy(), np.asarray(ref)):
        assert abs(sample.mean() - mean) < 5 * std / np.sqrt(n)
        assert abs(sample.std() - std) < 5 * std / np.sqrt(2 * n)


def _recorded_times(sampler, x) -> np.ndarray:
    r"""The time grid that `sampler(x)` walks, as its steps receive it."""

    seen = []

    def step(x_t, t, s, **kwargs):
        seen.append(s) if seen else seen.extend((t, s))
        return x_t

    sampler.step = step
    sampler(x)
    return torch.stack(seen).float().numpy()


@pytest.mark.parametrize("steps", [50, 100, 250])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_time_grid_equals_jax(dtype, steps):
    # JAX builds the grid in float32 and casts it to x's dtype; a linspace in
    # bf16 or float16 rounds its own points and, at 250 steps in bf16, gives
    # steps of length zero
    jd, td = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float16": (jnp.float16, torch.float16)}[dtype]
    js, ts = _schedules()
    jsam = jsample.DDIMSampler(_JaxGaussian(js), steps=steps)
    tsam = tsample.DDIMSampler(_TorchGaussian(ts), steps=steps)

    want = np.asarray(_jax_times(jsam, jd), dtype=np.float32)
    got = _recorded_times(tsam, torch.zeros((1,), dtype=td))

    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) < 0)


def test_ddim_trajectory_matches_jax_bf16():
    # The float32 trajectory test's bound scaled to bf16, relative to the
    # sample's size: both sides round every step to bf16 (2^-8), XLA after
    # fusing the update and torch after each operation, and each lies ~1.5%
    # (mean) and ~4% (max) from the float32 trajectory after 50 steps. They
    # agree to 0.8% on the mean and 3.7% at most; the grid of a bf16
    # linspace moved them 1.2% apart on the mean.
    js, ts = _schedules()
    x = _x(seed=2)

    want = jsample.DDIMSampler(_JaxGaussian(js), steps=50)(jnp.asarray(x).astype(jnp.bfloat16))
    got = tsample.DDIMSampler(_TorchGaussian(ts), steps=50)(torch.from_numpy(x).to(torch.bfloat16))

    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 5e-2 * np.abs(want).max()
    assert err.mean() <= 1e-2 * np.abs(want).mean()
