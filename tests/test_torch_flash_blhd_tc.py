r"""The arithmetic of the bf16 tensor-core `_flash_blhd` pair
(`csrc/flash_blhd_fwd.cu` and `csrc/flash_blhd_bwd.cu`, the attention
forward and one-pass backward reading heads in place from (B, L, H D)), as
their rounding-point versions `_flash_blhd_tiled_plain` and
`_flash_blhd_bwd_tiled_plain` repeat it, against the JAX package on the CPU
in interpret mode: the forward against `_pallas_attention_blocked` on the
split heads at the kernel's key tiling (its running max over 128 keys, 64 at
D = 192 and 256), the backward against `jax.vjp` of JAX's `_flash_blhd`
(the kernel's whole function on the projection layout), at every head dim
the pair takes and at L = 256 and a ragged 200. Also the forward's
log-sum-exp against the row max and sum of `_flash_blhd_fwd_plain`'s steps,
and the scratch that the backward's wrapper allocates.

Inputs come from seeded numpy generators. Tolerances are relative to
max |reference|:

- o against the blocked kernel, 5e-3: the same rounding points, and the
  rounding-point version returns o unrounded, so what differs is JAX's final
  rounding of o to bf16 (half an ulp, at most 2^-8 = 3.9e-3 of max |o|)
  plus float32 sums in another order;
- dq, dk, dv against JAX's vjp, 5e-3: the version's float32 sums against
  JAX's, rounded once to bf16 (half an ulp), where p comes from the
  log-sum-exp rather than from JAX's normalized exp-weights (float32's last
  bits), so a ds or p near a bf16 boundary may round either way;
- the log-sum-exp, float32 arithmetic on both sides, 1e-5.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from azula_tpu.ops import attention as jattention
from azula_tpu_torch.ops import attention as tattention

TOL_TILED = 5e-3
TOL_LSE = 1e-5

B, H = 2, 2
HEAD_DIMS = (64, 128, 192, 256)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(L, D, seed, dtype=torch.bfloat16):
    r"""q, k, v and a cotangent g of shape (B, L, H D), as bf16 JAX arrays
    and torch tensors of `dtype`."""

    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, L, H * D)).astype(np.float32) for _ in range(4)]
    return [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays], [torch.from_numpy(a).to(dtype) for a in arrays]


def _heads(x) -> jax.Array:
    r"""(B, L, H D) -> (B, H, L, D), as `_split_heads` does."""

    return jnp.swapaxes(x.reshape(*x.shape[:2], H, -1), 1, 2)


@pytest.mark.parametrize("L", [256, 200], ids=["L256", "ragged_L200"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_forward_matches_blocked_kernel_at_the_key_tiling(D, L):
    (q, k, v, _), (tq, tk, tv, _) = _inputs(L, D, seed=D + L)
    scale = 1 / math.sqrt(D)

    bk = tattention._key_tile(D)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jattention._pallas_attention_blocked(
            *(_heads(t) for t in (q, k, v)), scale, block=bk, block_q=min(L, 128), block_k=bk, with_lse=True
        )
    got_o, got_lse = tattention._flash_blhd_tiled_plain(tq, tk, tv, H, scale)

    assert got_o.dtype == torch.float32 and tuple(got_o.shape) == (B, L, H * D)
    assert got_lse.dtype == torch.float32 and tuple(got_lse.shape) == (B, H, L)
    want_o = jnp.swapaxes(want_o, 1, 2).reshape(B, L, H * D)
    assert _rel_err(got_o, want_o) <= TOL_TILED
    assert _rel_err(got_lse, _f64(want_lse[..., 0]).reshape(B, H, L)) <= TOL_LSE


@pytest.mark.parametrize("L", [256, 200], ids=["L256", "ragged_L200"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_backward_matches_jax_vjp(D, L):
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(L, D, seed=3 * D + L)
    scale = 1 / math.sqrt(D)

    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, b, c: jattention._flash_blhd(a, b, c, H, scale), q, k, v)
        want = vjp(g)

    # the backward takes the forward's o, as autograd hands it, and the
    # kernel's log-sum-exp
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).to(torch.bfloat16)
    _, lse = tattention._flash_blhd_tiled_plain(tq, tk, tv, H, scale)
    got = tattention._flash_blhd_bwd_tiled_plain(tq, tk, tv, to, tg, lse, H, scale)

    for name, a, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert a.dtype == torch.float32 and tuple(a.shape) == (B, L, H * D), name
        assert _rel_err(a, w) <= TOL_TILED, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_lse_is_the_plain_forwards_max_and_sum(D, dtype):
    _, (q, k, v, _) = _inputs(200, D, seed=D, dtype=dtype)
    scale = 1 / math.sqrt(D)

    # `_flash_blhd_fwd_plain`'s steps: the logits, their row max m and the
    # sum l of exp(logits - m)
    qh, kh = (tattention._split_heads(t, H).float() for t in (q, k))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    l = torch.exp(logits - m).sum(dim=-1, keepdim=True)

    _, lse = tattention._flash_blhd_tiled_plain(q, k, v, H, scale)
    assert _rel_err(lse, (m + torch.log(l)).squeeze(-1)) <= TOL_LSE


@pytest.mark.parametrize("L", [1, 64, 200, 256, 512])
def test_scratch_of_the_backward(L):
    # the per-tile LSE and delta rows, padded to the kernel's 64-query tiles,
    # and the float32 dq accumulator in dq's (B, L, H D) layout
    heads, D = 6, 64
    rows, acc = tattention._bwd_scratch(B, heads, L, D, torch.bfloat16)
    assert rows == B * heads * math.ceil(L / 64) * 2 * 64 and rows >= B * heads * L
    assert acc == torch.empty((B, L, heads * D)).numel()
    assert tattention._bwd_scratch(B, heads, L, D, torch.float32) == (rows, 0)
