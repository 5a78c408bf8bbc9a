r"""The arithmetic of the bf16 tensor-core attention forward
(`csrc/attention_fwd.cu`), as its plain version `_attention_tiled_plain`
repeats it, against the JAX package's Pallas kernels on the CPU, in
interpret mode: `_pallas_attention_blocked` at the kernel's own key tiling
(its running max over 128 keys, 64 at D = 192 and 256), in the exact, LSE,
max-free, bias and dropout forms; `_pallas_attention` (with and without the
LSE, and `max_free`) and `_pallas_attention_batched`, which round the
weights against the row's final max. Head dims 32 to 256, ragged lengths,
each bias mode, dropout with injected seed words.

Inputs come from seeded numpy generators. Tolerances are relative to
max |reference|:

- bfloat16 at the kernel's tiling, 5e-3: the rounding points are the same,
  and the plain version returns o unrounded, so what differs is JAX's final
  rounding of o to bf16 (half an ulp, at most 2^-8 = 3.9e-3 of max |o|)
  plus float32 sums in another order;
- bfloat16 against the kernels that round against the final max, 2e-2 (a
  weight rounds to bf16 at another point; the bound of the other tests);
- float32, 1e-5 (the same arithmetic in another order; rounding to float32
  is the identity);
- the log-sum-exp, float32 arithmetic in both dtypes, 1e-5.
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
TOL_TILED = {"float32": 1e-5, "bfloat16": 5e-3}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_LSE = 1e-5

B, H = 2, 2
HEAD_DIMS = (32, 64, 128, 192, 256)
MODES = {"full": (B, H), "batch": (B, 1), "head": (1, H), "one": (1, 1)}


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(L, D, dtype, seed, q_scale=1.0):
    r"""q, k, v of shape (B, H, L, D), as JAX and torch arrays of `dtype`."""

    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(3)]
    arrays[0] *= q_scale
    return [jnp.asarray(a).astype(jd) for a in arrays], [torch.from_numpy(a).to(td) for a in arrays]


def _bias(mode, L, jq, tq, seed):
    r"""The bias of a random boolean mask of `mode` (keeping ~70% and the
    first key of every row) on both sides."""

    mask = np.random.default_rng(seed).random((*MODES[mode], L, L)) < 0.7
    mask[..., 0] = True
    jbias, jmode = jattention._mask_to_bias(jnp.asarray(mask), jq)
    tbias, tmode = tattention._mask_to_bias(torch.from_numpy(mask), tq)
    assert jmode == tmode == mode
    return jbias, tbias


def _seed_words(seed):
    words = np.array([-(seed + 5), 2**31 - 17 * seed], dtype=np.int32)
    return jnp.asarray(words), torch.from_numpy(words)


def _lse(lse_lanes, L) -> np.ndarray:
    r"""The TPU kernels' lane-replicated (B H, L, 128) log-sum-exp as (B, H, L)."""

    return _f64(lse_lanes[..., 0]).reshape(B, H, L)


def _blocked(q, k, v, scale, D, L, **kwargs):
    r"""`_pallas_attention_blocked` at the tensor-core kernel's key tiling."""

    bk = tattention._key_tile(D)
    with pltpu.force_tpu_interpret_mode():
        return jattention._pallas_attention_blocked(q, k, v, scale, block=bk, block_q=min(L, 128), block_k=bk, **kwargs)


def test_key_tile():
    assert [tattention._key_tile(D) for D in HEAD_DIMS] == [128, 128, 128, 64, 64]


# at the kernel's tiling: `_pallas_attention_blocked` with its key blocks


@pytest.mark.parametrize("L", [256, 200], ids=["L256", "ragged_L200"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_matches_blocked_kernel_at_the_key_tiling(dtype, D, L):
    (q, k, v), (tq, tk, tv) = _inputs(L, D, dtype, seed=D + L)
    scale = 1 / math.sqrt(D)

    want_o, want_lse = _blocked(q, k, v, scale, D, L, with_lse=True)
    got_o, got_lse = tattention._attention_tiled_plain(tq, tk, tv, scale)

    assert got_o.dtype == torch.float32 and tuple(got_o.shape) == (B, H, L, D)
    assert _rel_err(got_o, want_o) <= TOL_TILED[dtype]
    assert _rel_err(got_lse, _lse(want_lse, L)) <= TOL_LSE


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_free_matches_blocked_kernel(dtype, D):
    # logits of std ~30 at D = 128: some above 80, where the clamp applies
    (q, k, v), (tq, tk, tv) = _inputs(256, D, dtype, seed=D, q_scale=30.0 if D == 128 else 1.0)
    scale = 1 / math.sqrt(D)

    want_o, _ = _blocked(q, k, v, scale, D, 256, with_lse=False, max_free=True)
    got_o, got_lse = tattention._attention_tiled_plain(tq, tk, tv, scale, max_free=True)

    assert got_lse is None
    assert _rel_err(got_o, want_o) <= TOL_TILED[dtype]
    # no max: the same function as the plain max-free version
    assert _rel_err(got_o, tattention._attention_max_free_plain(tq, tk, tv, scale)) <= TOL_TILED[dtype]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_matches_blocked_kernel(dtype, D, mode):
    (q, k, v), (tq, tk, tv) = _inputs(256, D, dtype, seed=3 * D)
    jbias, tbias = _bias(mode, 256, q, tq, seed=D + 1)
    scale = 1 / math.sqrt(D)

    want_o, want_lse = _blocked(q, k, v, scale, D, 256, bias=jbias, bias_mode=mode, with_lse=True)
    got_o, got_lse = tattention._attention_tiled_plain(tq, tk, tv, scale, tbias, mode)

    assert _rel_err(got_o, want_o) <= TOL_TILED[dtype]
    assert _rel_err(got_lse, _lse(want_lse, 256)) <= TOL_LSE


@pytest.mark.parametrize("mode", [None, "batch", "full"], ids=["no_bias", "batch_bias", "full_bias"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_blocked_kernel(dtype, D, mode):
    # the blocked kernel's dropout takes L a multiple of its block
    (q, k, v), (tq, tk, tv) = _inputs(256, D, dtype, seed=5 * D)
    jbias, tbias = (None, None) if mode is None else _bias(mode, 256, q, tq, seed=D + 2)
    jseed, tseed = _seed_words(D)
    scale = 1 / math.sqrt(D)
    mode = mode or "one"

    want_o, want_lse = _blocked(
        q, k, v, scale, D, 256, bias=jbias, bias_mode=mode, dropout_rate=0.1, seed=jseed, with_lse=True
    )
    got_o, got_lse = tattention._attention_tiled_plain(tq, tk, tv, scale, tbias, mode, tseed, 0.1)
    _, undropped_lse = tattention._attention_tiled_plain(tq, tk, tv, scale, tbias, mode)

    assert _rel_err(got_o, want_o) <= TOL_TILED[dtype]
    assert _rel_err(got_lse, _lse(want_lse, 256)) <= TOL_LSE
    assert torch.equal(got_lse, undropped_lse)


# against the kernels that round against the row's final max


@pytest.mark.parametrize("with_lse", [True, False], ids=["lse", "no_lse"])
@pytest.mark.parametrize("L", [640, 600], ids=["L640", "ragged_L600"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_attention(dtype, D, L, with_lse):
    (q, k, v), (tq, tk, tv) = _inputs(L, D, dtype, seed=7 * D + L)
    scale = 1 / math.sqrt(D)

    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jattention._pallas_attention(q, k, v, scale, with_lse=with_lse)
    got_o, got_lse = tattention._attention_tiled_plain(tq, tk, tv, scale)

    assert _rel_err(got_o, want_o) <= TOL[dtype]
    if with_lse:
        assert _rel_err(got_lse, _lse(want_lse, L)) <= TOL_LSE
    else:
        assert want_lse is None


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_free_matches_pallas_attention(dtype, D):
    # no max, so no rounding point differs: the kernel's tolerance holds
    (q, k, v), (tq, tk, tv) = _inputs(640, D, dtype, seed=11 * D)
    scale = 1 / math.sqrt(D)

    with pltpu.force_tpu_interpret_mode():
        want_o, _ = jattention._pallas_attention(q, k, v, scale, with_lse=False, max_free=True)
    got_o, _ = tattention._attention_tiled_plain(tq, tk, tv, scale, max_free=True)

    assert _rel_err(got_o, want_o) <= TOL_TILED[dtype]


@pytest.mark.parametrize("mode", ["one", "full", None], ids=["one_bias", "full_bias", "no_bias"])
@pytest.mark.parametrize("D", [32, 64, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_attention_batched(dtype, D, mode):
    (q, k, v), (tq, tk, tv) = _inputs(256, D, dtype, seed=13 * D)
    jbias, tbias = (None, None) if mode is None else _bias(mode, 256, q, tq, seed=D + 3)
    mode = mode or "one"
    scale = 1 / math.sqrt(D)

    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jattention._pallas_attention_batched(q, k, v, scale, jbias, mode, with_lse=True)
    got_o, got_lse = tattention._attention_tiled_plain(tq, tk, tv, scale, tbias, mode)

    assert _rel_err(got_o, want_o) <= TOL[dtype]
    assert _rel_err(got_lse, _lse(want_lse, 256)) <= TOL_LSE


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_the_final_max_plain_versions(dtype, D):
    # the plain versions of the earlier kernels, which round against the
    # final max, within the bound that the card holds the kernel to
    (_, _, _), (tq, tk, tv) = _inputs(300, D, dtype, seed=17 * D)
    scale = 1 / math.sqrt(D)
    words = _seed_words(D)[1]
    mask = torch.rand((B, 1, 300, 300), generator=torch.Generator().manual_seed(D)) < 0.7
    mask[..., 0] = True
    tbias, mode = tattention._mask_to_bias(mask, tq)

    got_o, got_lse = tattention._attention_tiled_plain(tq, tk, tv, scale, tbias, mode, words, 0.1)
    want_o, want_lse = tattention._attention_lse_plain(tq, tk, tv, scale, tbias, mode, words, 0.1)

    assert _rel_err(got_o, want_o) <= TOL[dtype]
    assert _rel_err(got_lse, want_lse) <= TOL_LSE
    assert _rel_err(tattention._attention_tiled_plain(tq, tk, tv, scale)[0], tattention._attention_plain(tq, tk, tv, scale=scale)) <= TOL[dtype]
