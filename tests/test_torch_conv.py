r"""The PyTorch port's direct 3x3 convolution (`azula_tpu_torch.ops.conv`)
against the JAX package's, on the CPU.

JAX's `_pallas_conv3x3` is a Pallas kernel; it runs here in interpret mode
(`pltpu.force_tpu_interpret_mode()`), and the port's plain version
`_conv3x3_plain` is held against it. The CUDA kernel is held against the same
plain version on the card by `chip_smoke.py`. Inputs come from seeded numpy
generators. Tolerances, relative to max |reference|: 1e-5 in float32 (nine
float32 products of C terms summed in another order); 1e-2 in bf16 (the
output rounded to 8 bits of mantissa, 2^-8 ~ 4e-3, either way near a
boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from jax.experimental.pallas import tpu as pltpu

from azula_tpu.ops import conv as jconv
from azula_tpu_torch.ops import _build
from azula_tpu_torch.ops import conv as tconv

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(B, H, W, C, K, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, K)) / np.sqrt(9 * C)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 16, 16, 128, 128), (2, 8, 8, 256, 256)])
def test_plain_version_matches_pallas_kernel(shape, dtype):
    jd, td = DTYPES[dtype]
    x, w = _inputs(*shape)

    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jconv._pallas_conv3x3(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd)))

    got = tconv._conv3x3_plain(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))

    assert got.dtype == td and tuple(got.shape) == want.shape
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("shape", [(2, 6, 5, 3, 7), (1, 9, 12, 20, 33)])
def test_plain_version_matches_xla_at_ragged_shapes(shape):
    # odd sizes the kernel masks: the plain version stays the convolution
    x, w = _inputs(*shape, seed=1)

    want = jconv._xla_conv(jnp.asarray(x), jnp.asarray(w))
    got = tconv._conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w))

    assert _rel_err(got, want) <= TOL["float32"]


@pytest.mark.parametrize("shape", [(1, 16, 16, 128, 128), (2, 6, 5, 3, 7)])
def test_conv3x3_vjp_matches_jax(shape):
    x, w = _inputs(*shape, seed=2)
    g = np.random.default_rng(3).standard_normal((*shape[:3], shape[4])).astype(np.float32)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jconv.conv3x3, jnp.asarray(x), jnp.asarray(w))
        want_gx, want_gw = jax.block_until_ready(vjp(jnp.asarray(g)))

    xt, wt = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, w))
    before = dict(_build.LAUNCHES)
    got = tconv.conv3x3(xt, wt)
    got.backward(torch.from_numpy(g))
    assert dict(_build.LAUNCHES) == before

    assert _rel_err(got, want) <= TOL["float32"]
    assert _rel_err(xt.grad, want_gx) <= TOL["float32"]
    assert _rel_err(wt.grad, want_gw) <= TOL["float32"]


def test_kernel_wrapper_checks_and_is_forward_only():
    assert tconv._conv3x3_kernel.__wrapped__.__name__ == "_conv3x3_kernel"
    x, w = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tconv._conv3x3_kernel(x.requires_grad_(), w)


def test_can_use_conv3x3_matches_jax(monkeypatch):
    # the shape conditions, with both backend checks answered yes in this test
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    cases = [
        (x_shape, w_shape, stride, padding, periodic)
        for x_shape in [(2, 16, 16, 128), (2, 8, 8, 256), (1, 64, 64, 128), (2, 15, 16, 128), (2, 6, 6, 128),
                        (2, 16, 16, 64), (2, 16, 16, 384), (1, 32, 32), (4, 32, 48, 256)]
        for w_shape in [(3, 3, 128, 128), (3, 3, 256, 256), (1, 1, 128, 128), (3, 3, 128, 64), (3, 3, 384, 128)]
        for stride in [(1, 1), (2, 2)]
        for padding in [((1, 1), (1, 1)), ((0, 0), (0, 0))]
        for periodic in [False, True]
    ]
    for case in cases:
        assert tconv.can_use_conv3x3(*case) == jconv.can_use_conv3x3(*case), case

    # JAX's VMEM bound on a row band refuses wide rows; the card's tile is
    # the same at every shape
    wide = ((1, 8, 4096, 1024), (3, 3, 1024, 1024), (1, 1), ((1, 1), (1, 1)), False)
    assert not jconv.can_use_conv3x3(*wide)
    assert tconv.can_use_conv3x3(*wide)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not tconv.can_use_conv3x3((2, 16, 16, 128), (3, 3, 128, 128), (1, 1), ((1, 1), (1, 1)), False)


# the form of csrc/conv3x3.cu that its C entry chooses (the tensor cores for
# bf16 whose channels TMA reads at 16-byte strides)


@pytest.mark.parametrize(
    "x_shape, K",
    [((256, 16, 16, 128), 128), ((256, 8, 8, 256), 256), ((256, 16, 16, 384), 128), ((3, 13, 11, 40), 72)],
    ids=["unet32_16x16", "unet32_8x8", "unet32_384", "ragged"],
)
def test_conv3x3_form_tensor_cores(x_shape, K):
    assert tconv._conv3x3_form(x_shape, K, torch.bfloat16) == "tensor_cores"
    assert tconv._conv3x3_form(x_shape, K, torch.float32) == "cuda_cores"


@pytest.mark.parametrize("x_shape, K", [((3, 13, 11, 40), 70), ((2, 6, 5, 4), 64), ((1, 8, 8, 12), 16)])
def test_conv3x3_form_cuda_cores(x_shape, K):
    assert tconv._conv3x3_form(x_shape, K, torch.bfloat16) == "cuda_cores"


def test_admitted_shapes_take_the_tensor_cores(monkeypatch):
    # every shape that JAX's dispatch admits has C and K multiples of 128
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for C in (128, 256, 384):
        for K in (128, 256):
            x_shape, w_shape = (4, 8, 8, C), (3, 3, C, K)
            assert tconv.can_use_conv3x3(x_shape, w_shape, (1, 1), ((1, 1), (1, 1)), False)
            assert tconv._conv3x3_form(x_shape, K, torch.bfloat16) == "tensor_cores"
