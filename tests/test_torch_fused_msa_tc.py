r"""The arithmetic of the bf16 tensor-core form of the fused MSA kernel
(`csrc/fused_msa.cu`), as its plain version `_fused_msa_tiled_plain` repeats
it, against the JAX package on the CPU: against `_reference` (the function
the kernel computes), and against `_pallas_attention_blocked` in interpret
mode at the kernel's key tiling (its running max over 128 keys, 64 at
D = 192 and 256), fed JAX's own normalized and rotated q and k. Head dims 64
to 256, with and without the rotation and the RMS-norm, ragged lengths.

Inputs come from seeded numpy generators. Tolerances are relative to
max |reference|:

- against `_reference`: bfloat16 2e-2 (the weights round to bf16 against
  the running max of a key tile, where `_reference` rounds them against the
  row's final max, and `_reference` rounds o to bf16); float32 1e-5 (the
  same function, the online softmax summing in another order);
- against `_pallas_attention_blocked` at the kernel's tiling, bfloat16 5e-3:
  the rounding points are the same and the plain version returns o
  unrounded, so what differs is JAX's final rounding of o to bf16 (half an
  ulp, at most 2^-8 = 3.9e-3 of max |o|) plus float32 sums in another order;
  q and k, prepared on each side in float32 and rounded to bf16, may differ
  by an ulp where a value lies on a rounding boundary.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from jax.experimental.pallas import tpu as pltpu

from azula_tpu.ops import attention as jattention
from azula_tpu.ops import fused_msa as jfused
from azula_tpu_torch.ops import attention as tattention
from azula_tpu_torch.ops import fused_msa as tfused

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL_REFERENCE = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_TILED = 5e-3

B, H = 2, 2
HEAD_DIMS = (64, 128, 192, 256)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(L, D, dtype, rope, seed):
    r"""qkv (B, L, 3 H D) and the rope tables (or None), on both sides."""

    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, L, 3 * H * D)).astype(np.float32)
    jqkv, tqkv = jnp.asarray(qkv).astype(jd), torch.from_numpy(qkv).to(td)
    if not rope:
        return jqkv, tqkv, (None, None), (None, None)
    theta = rng.standard_normal((L, H * D // 2)).astype(np.float32)
    return jqkv, tqkv, jfused.rope_tables(jnp.asarray(theta), H), tfused.rope_tables(torch.from_numpy(theta), H)


def _jax_prepare(qkv, cos2, sin2, eps):
    r"""q, k, v of JAX's `_reference` before its attention, as (B, H, L, D):
    its own normalization and rotation, written out as `_reference` does
    them."""

    _, L, C3 = qkv.shape
    D = C3 // 3 // H
    x = qkv.reshape(B, L, 3, H, D)
    q, k, v = x[:, :, 0].astype(jnp.float32), x[:, :, 1].astype(jnp.float32), x[:, :, 2]

    if eps is not None:
        q = q * jax.lax.rsqrt(jnp.mean(jnp.square(q), axis=-1, keepdims=True) + eps)
        k = k * jax.lax.rsqrt(jnp.mean(jnp.square(k), axis=-1, keepdims=True) + eps)

    if cos2 is not None:
        c = cos2.reshape(L, H, D)
        s = sin2.reshape(L, H, D)

        def swap(z):
            return z.reshape(*z.shape[:-1], D // 2, 2)[..., ::-1].reshape(z.shape)

        q = q * c + swap(q) * s
        k = k * c + swap(k) * s

    return (z.astype(qkv.dtype).transpose(0, 2, 1, 3) for z in (q, k, v))


@pytest.mark.parametrize("eps", [1e-5, None], ids=["eps", "no_eps"])
@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_plain_matches_reference(dtype, rope, eps):
    L, D = 256, 64
    jqkv, tqkv, (jc, js), (tc, ts) = _inputs(L, D, dtype, rope, seed=11)
    scale = 1 / math.sqrt(D)

    want = jfused._reference(jqkv, jc, js, H, eps, scale)
    got = tfused._fused_msa_tiled_plain(tqkv, tc, ts, H, eps, scale)

    assert got.dtype == torch.float32 and tuple(got.shape) == (B, L, H * D)
    assert _rel_err(got, want) <= TOL_REFERENCE[dtype]


@pytest.mark.parametrize("L", [256, 200], ids=["L256", "ragged_L200"])
@pytest.mark.parametrize("D", [128, 192, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_plain_matches_reference_at_head_dims(dtype, D, L):
    jqkv, tqkv, (jc, js), (tc, ts) = _inputs(L, D, dtype, True, seed=D + L)
    scale = 1 / math.sqrt(D)

    want = jfused._reference(jqkv, jc, js, H, 1e-5, scale)
    got = tfused._fused_msa_tiled_plain(tqkv, tc, ts, H, 1e-5, scale)

    assert _rel_err(got, want) <= TOL_REFERENCE[dtype]


@pytest.mark.parametrize("eps", [1e-5, None], ids=["eps", "no_eps"])
@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_tiled_plain_matches_blocked_kernel_at_the_key_tiling(D, rope, eps):
    L = 200  # ragged: the last key tile is partial at every tiling
    jqkv, tqkv, (jc, js), (tc, ts) = _inputs(L, D, "bfloat16", rope, seed=3 * D + rope)
    scale = 1 / math.sqrt(D)

    q, k, v = _jax_prepare(jqkv, jc, js, eps)
    bk = tattention._key_tile(D)
    with pltpu.force_tpu_interpret_mode():
        want, _ = jattention._pallas_attention_blocked(q, k, v, scale, block=bk, block_q=128, block_k=bk)
    want = want.transpose(0, 2, 1, 3).reshape(B, L, H * D)

    got = tfused._fused_msa_tiled_plain(tqkv, tc, ts, H, eps, scale)

    assert _rel_err(got, want) <= TOL_TILED


def test_tiled_plain_rounds_like_the_plain_version_in_float32():
    # in float32 the weights' rounding is the identity: both versions compute
    # the same function
    _, tqkv, _, (tc, ts) = _inputs(200, 64, "float32", True, seed=5)
    got = tfused._fused_msa_tiled_plain(tqkv, tc, ts, H, 1e-5, 0.125)
    want = tfused._fused_msa_plain(tqkv, tc, ts, H, 1e-5, 0.125)

    assert _rel_err(got, want) <= 1e-5
