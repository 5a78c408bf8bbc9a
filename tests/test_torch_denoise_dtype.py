r"""The dtypes of the port's denoisers against the JAX package's, on the CPU:
a bf16 :math:`x_t` with a float32 time of shape () or (B,), as a tensor or
as a NumPy scalar or array, or a Python float, through `SimpleDenoiser` and
`KarrasDenoiser` (the tiny ViT of `test_torch_dit.py`), `AblatedDenoiser`
(the tiny ADM of `test_torch_adm.py`) and `FluxDenoiser` (the small
transformer of `test_torch_flux.py`), with the same drawn weights on both
sides.

JAX computes the schedule in the time's own dtype and promotes the
coefficients against :math:`x_t`: a float32 time gives float32
coefficients, so `KarrasDenoiser`, `AblatedDenoiser` and `FluxDenoiser`
return a float32 mean, while a Python float is weakly typed: its schedule
runs in float32 and its coefficients take :math:`x_t`'s bf16 where they meet
:math:`x_t`. The port does the same (`denoise.time_scales`: an array keeps
its dtype, a Python scalar's 0-d scales promote as torch's 0-d tensors do).

Errors are relative to max |JAX|, and each check has two limits. Both sides
compute in float32 up to the roundings to bf16 (the backbone's output cast to
:math:`x_t`'s dtype, as JAX's `.astype`, and a bf16 result), so an element
agrees within `TOL_F32` = 1e-4 unless one of those roundings fell the other
way on the two sides. That happens only where the two float32 values
straddle a bf16 rounding boundary, with a chance of about their difference
over the bf16 step: at most `FLIP_SHARE` = 1% of the elements may exceed
`TOL_F32`. A flipped element is off by one bf16 step of the rounded value,
2^-7 of it at most, so every element stays within `TOL_BF16` = 1e-2, times
c_out's largest |sigma / alpha| for ADM's mean. A systematic error moves far
more elements past `TOL_F32`: the old cast of a float32 time to bf16 before
the schedule, 6.6e-3 apart from JAX, moves a quarter or more of them, and
`test_bf16_time_fails_the_checks` holds the checks to that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_adm import CARD
from test_torch_adm import _pair as _adm_pair
from test_torch_dit import _slice_pair
from test_torch_flux import _conditioning, _denoiser_pair

from azula_tpu import denoise as jdenoise
from azula_tpu import noise as jnoise
from azula_tpu_torch import denoise as tdenoise
from azula_tpu_torch.denoise import time_scales
from azula_tpu_torch.models import adm as tadm
from azula_tpu_torch.models import flux as tflux
from azula_tpu_torch.noise import VPSchedule

TOL_F32 = 1e-4
TOL_BF16 = 1e-2
FLIP_SHARE = 0.01

# the times: float32 of shape () and (B,), each as a tensor and as NumPy's
# own scalar or array (given as it is to both sides), and a Python float
TIMES = {
    "scalar_f32": np.float32(0.3),
    "vector_f32": np.array([0.3, 0.77], dtype=np.float32),
    "numpy_scalar_f32": np.float32(0.3),
    "numpy_vector_f32": np.array([0.3, 0.77], dtype=np.float32),
    "python_float": 0.3,
}

DENOISERS = ["simple", "karras", "ablated", "flux"]


def _errors(got: torch.Tensor, want) -> tuple[float, float]:
    r"""The largest error relative to max |JAX|, and the share of elements
    whose error exceeds `TOL_F32`."""

    want = np.asarray(jnp.asarray(want, dtype=jnp.float32), dtype=np.float64)
    err = np.abs(got.detach().double().numpy() - want) / np.abs(want).max()
    return float(err.max()), float((err > TOL_F32).mean())


def _close(got: torch.Tensor, want, tol: float) -> bool:
    worst, share = _errors(got, want)
    return worst <= tol and share <= FLIP_SHARE


def _times(name: str):
    r"""The time of `name` for JAX and for the port."""

    t = TIMES[name]
    if isinstance(t, float) or name.startswith("numpy"):
        return t, t
    return jnp.asarray(t), torch.from_numpy(np.array(t))


def _expected_dtype(name: str, always_x: bool = False) -> tuple:
    r"""JAX's dtype and the port's for a bf16 x_t: x_t's for a Python float
    (or where the denoiser casts its output to x_t's dtype), else float32."""

    if always_x or name == "python_float":
        return jnp.bfloat16, torch.bfloat16
    return jnp.float32, torch.float32


def _x(shape, seed: int):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _max_ratio(t) -> float:
    r"""The largest sigma / alpha of the VP schedule over the times `t`."""

    alpha, sigma = jnoise.VPSchedule()(jnp.asarray(t, dtype=jnp.float32))
    return float(jnp.max(sigma / alpha))


def _outputs(denoiser: str, name: str) -> list[tuple]:
    r"""Each output of `denoiser` at the time `name` with a bf16 x_t, as
    (JAX's, the port's, the limit of every element, the expected dtypes)."""

    tj, tt = _times(name)

    if denoiser in ("simple", "karras"):
        karras = denoiser == "karras"
        jd, td = _slice_pair(karras, seed=6 if karras else 4)
        if not karras:
            jd = jdenoise.SimpleDenoiser(jd.backbone, jd.schedule)
            td = tdenoise.SimpleDenoiser(td.backbone, td.schedule)
        xj, xt = _x((2, 8, 8, 3), seed=7 if karras else 5)
        want = jd(xj, tj).mean
        with torch.no_grad():
            got = td(xt, tt).mean
        # SimpleDenoiser casts its output to x_t's dtype on both sides;
        # Karras's c_skip x_t + c_out b has the bf16 b and c_out < 1
        return [(want, got, TOL_BF16, _expected_dtype(name, always_x=not karras))]

    if denoiser == "ablated":
        jd, td = _adm_pair(**CARD)
        xj, xt = _x((2, 32, 32, 3), seed=8)
        want = jd(xj, tj)
        with torch.no_grad():
            got = td(xt, tt)
        # the backbone's bf16 output is multiplied by c_out = -sigma / alpha
        return [
            (want.mean, got.mean, TOL_BF16 * max(1.0, _max_ratio(TIMES[name])), _expected_dtype(name)),
            (want.var, got.var, TOL_BF16, _expected_dtype(name)),
        ]

    jd, td = _denoiser_pair(2)
    z, clip, t5 = _conditioning(9)
    zj, zt = jnp.asarray(z).astype(jnp.bfloat16), torch.from_numpy(z).to(torch.bfloat16)
    want = jd(zj, tj, prompt_clip=jnp.asarray(clip), prompt_t5=jnp.asarray(t5)).mean
    with torch.no_grad():
        got = td(zt, tt, prompt_clip=torch.from_numpy(clip), prompt_t5=torch.from_numpy(t5)).mean
    # c_out = -sigma / (alpha + sigma) lies in [-1, 0]
    return [(want, got, TOL_BF16, _expected_dtype(name))]


def _check(denoiser: str, name: str) -> None:
    for want, got, tol, dtypes in _outputs(denoiser, name):
        assert (want.dtype, got.dtype) == dtypes
        worst, share = _errors(got, want)
        assert worst <= tol and share <= FLIP_SHARE, (worst, share)


@pytest.mark.parametrize("name", list(TIMES))
def test_simple_denoiser_keeps_jax_dtypes(name):
    _check("simple", name)


@pytest.mark.parametrize("name", list(TIMES))
def test_karras_denoiser_keeps_jax_dtypes(name):
    _check("karras", name)


@pytest.mark.parametrize("name", list(TIMES))
def test_ablated_denoiser_keeps_jax_dtypes(name):
    _check("ablated", name)


@pytest.mark.parametrize("name", list(TIMES))
def test_flux_denoiser_keeps_jax_dtypes(name):
    _check("flux", name)


@pytest.mark.parametrize("name", ["scalar_f32", "vector_f32"])
@pytest.mark.parametrize("denoiser", DENOISERS)
def test_bf16_time_fails_the_checks(denoiser, name, monkeypatch):
    r"""A planted fault the dtype asserts cannot see: the time rounded to
    x_t's bf16 before the schedule and its coefficients back in float32.
    The value checks must refuse it."""

    def rounded(schedule, t, x):
        t = torch.as_tensor(t)
        return time_scales(schedule, t.to(x.dtype).to(t.dtype), x)

    for module in (tdenoise, tadm, tflux):
        monkeypatch.setattr(module, "time_scales", rounded)

    outputs = _outputs(denoiser, name)
    assert all((want.dtype, got.dtype) == dtypes for want, got, _, dtypes in outputs)
    assert not all(_close(got, want, tol) for want, got, tol, _ in outputs)


@pytest.mark.parametrize(
    "t, dtype",
    [
        (0.5, torch.float32),
        (torch.tensor(0.5), torch.float32),
        (torch.tensor([0.5, 0.25], dtype=torch.float64), torch.float64),
        (np.float32(0.5), torch.float32),
        (np.float64(0.5), torch.float64),
        (np.array([0.5, 0.25], dtype=np.float32), torch.float32),
    ],
    ids=["python", "0d_f32", "1d_f64", "numpy_0d_f32", "numpy_0d_f64", "numpy_1d_f32"],
)
def test_time_scales_follow_weak_typing(t, dtype):
    x = torch.zeros((2, 3), dtype=torch.bfloat16)
    t_out, alpha, sigma = time_scales(VPSchedule(), t, x)

    # only a Python scalar is weak: NumPy's float64 scalar is a float too
    weak = type(t) is float
    assert t_out.device == x.device and t_out.dtype == dtype
    # a Python scalar's scales stay 0-d, an array's are padded to x's rank
    assert alpha.ndim == sigma.ndim == (0 if weak else x.ndim)
    assert (alpha * x).dtype == (torch.bfloat16 if weak else torch.promote_types(dtype, x.dtype))


@pytest.mark.parametrize("t", [np.array([0.2, 0.5, 0.9], dtype=np.float32), [0.2, 0.5, 0.9]], ids=["numpy", "list"])
def test_time_scales_pad_a_batch_of_times(t):
    r"""A (B,) time scales the batch axis, also where B equals the channels."""

    x = torch.zeros((3, 4, 4, 3), dtype=torch.bfloat16)
    _, alpha, sigma = time_scales(VPSchedule(), t, x)
    want_alpha, want_sigma = VPSchedule()(torch.tensor([0.2, 0.5, 0.9]))

    assert alpha.shape == sigma.shape == (3, 1, 1, 1)
    assert torch.equal(alpha.flatten(), want_alpha) and torch.equal(sigma.flatten(), want_sigma)
