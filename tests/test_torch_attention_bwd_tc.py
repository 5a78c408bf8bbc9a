r"""The arithmetic of the attention backward (`csrc/attention_bwd.cu`: in bf16
the one-pass tensor-core kernel, in float32 the CUDA-core pair), as its plain
version `_attention_bwd_plain` repeats it, against the JAX package's
`_pallas_attention_bwd` on the CPU in interpret mode, from the JAX forward's
own o and log-sum-exp: every head dim the kernel takes (32 to 256), L = 256
and a length ragged against the kernel's 64-query and 128-key tiles (200,
one block for JAX's `_bwd_block`), a bias in each of the four modes with and
without dropout, dropout with injected seed words at each head dim, bf16 and
float32; and the scratch that the wrapper allocates for the kernel.

Inputs come from seeded numpy generators. Tolerances are relative to
max |reference|:

- bfloat16, 2e-2 (the bound of the other backward tests): the rounding
  points are the same, but JAX sums the scores and products in another
  order, so a ds, a dropped weight or an output near a bf16 rounding
  boundary may round either way, one bf16 ulp (2^-7 of the element);
- bfloat16 against the plain version's float32 sums (`rounded=False`),
  5e-3: what is left is JAX's final rounding of dq, dk, dv to bf16 (half an
  ulp, at most 2^-8 = 3.9e-3 of max |d.|) and ds or p~ rounded either way
  inside the sums, the tolerance the card's tighter gate uses;
- float32, 1e-5: the same arithmetic in another order (rounding to float32
  is the identity).
"""

import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from jax.experimental.pallas import tpu as pltpu

from azula_tpu.ops import attention as jattention
from azula_tpu_torch.ops import attention as tattention

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_UNROUNDED = {"float32": 1e-5, "bfloat16": 5e-3}

HEAD_DIMS = (32, 64, 128, 192, 256)
RATE = 0.1


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _torch(a, td) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a, dtype=jnp.float32))).to(td)


def _case(B, H, L, D, dtype, seed, mode=None, rate=0.0):
    r"""q, k, v, g of shape (B, H, L, D), a boolean mask of `mode` (keeping
    ~70% and the first key of every row) as a bias, and seed words under
    dropout; JAX's forward o and LSE; then JAX's backward and the plain
    version's, rounded and not."""

    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4)]
    q, k, v, g = (jnp.asarray(a).astype(jd) for a in arrays)
    tq, tk, tv, tg = (torch.from_numpy(a).to(td) for a in arrays)
    scale = 1 / math.sqrt(D)

    jbias = tbias = None
    if mode is not None:
        extents = {"full": (B, H), "batch": (B, 1), "head": (1, H), "one": (1, 1)}[mode]
        mask = rng.random((*extents, L, L)) < 0.7
        mask[..., 0] = True
        jbias, jmode = jattention._mask_to_bias(jnp.asarray(mask), q)
        tbias, tmode = tattention._mask_to_bias(torch.from_numpy(mask), tq)
        assert jmode == tmode == mode
    mode = mode or "one"
    words = np.array([-(seed + 5), 2**31 - 17 * seed], dtype=np.int32)
    jseed, tseed = (jnp.asarray(words), torch.from_numpy(words)) if rate > 0 else (None, None)

    with pltpu.force_tpu_interpret_mode():
        if rate > 0:
            o, lse = jattention._flash_dropout_impl(q, k, v, jseed, rate, scale, jbias, mode)
        else:
            o, lse = jattention._pallas_attention(q, k, v, scale, jbias, mode, with_lse=True)
        want = jattention._pallas_attention_bwd(q, k, v, o, lse, g, scale, jbias, mode, rate, jseed)

    args = (tq, tk, tv, _torch(o, td), _torch(lse[..., 0], torch.float32).reshape(B, H, L), tg, scale)
    masked = (tbias, mode, tseed, rate)
    got = tattention._attention_bwd_plain(*args, *masked)
    unrounded = tattention._attention_bwd_plain(*args, *masked, rounded=False)

    return want, got, unrounded, td


def _assert_grads(dtype, want, got, unrounded, td):
    for name, w, a, u in zip(("dq", "dk", "dv"), want, got, unrounded, strict=True):
        assert a.dtype == td and u.dtype == torch.float32
        assert torch.equal(u.to(td), a), name
        assert _rel_err(a, w) <= TOL[dtype], name
        assert _rel_err(u, w) <= TOL_UNROUNDED[dtype], name


@pytest.mark.parametrize("L", [256, 200], ids=["L256", "ragged_L200"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_at_each_head_dim(dtype, D, L):
    # without a bias or dropout JAX takes `_pallas_attention_batched_bwd`
    # (L <= 512), row 8's kernel
    _assert_grads(dtype, *_case(1, 2, L, D, dtype, seed=D + L))


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_backward_matches_jax_at_each_head_dim(dtype, D):
    _assert_grads(dtype, *_case(2, 1, 200, D, dtype, seed=3 * D, rate=RATE))


@pytest.mark.parametrize("rate", [0.0, RATE], ids=["bias", "bias_dropout"])
@pytest.mark.parametrize("mode", ["full", "batch", "head", "one"])
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_biased_backward_matches_jax_in_each_mode(dtype, D, mode, rate):
    # B = H = 2, so that the four modes differ; ragged L
    _assert_grads(dtype, *_case(2, 2, 136, D, dtype, seed=D + len(mode), mode=mode, rate=rate))


@pytest.mark.parametrize("L", [1, 63, 64, 65, 200, 1024])
def test_scratch_of_the_kernel(L):
    # the per-tile LSE and delta rows, padded to the kernel's 64-query tiles,
    # and the float32 dq accumulator of the bf16 kernel
    rows, acc = tattention._bwd_scratch(2, 3, L, 64, torch.bfloat16)
    assert rows == 2 * 3 * math.ceil(L / 64) * 2 * 64 and rows >= 2 * 3 * L
    assert acc == 2 * 3 * L * 64
    assert tattention._bwd_scratch(2, 3, L, 64, torch.float32) == (rows, 0)
