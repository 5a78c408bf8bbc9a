r"""The PyTorch port's attention masks and dropout against the JAX package's,
on the CPU: the dropout hash (`dropout_keep_mask`, bit for bit), the bias of
a boolean mask in its four broadcast modes, the plain versions of the biased
and dropout kernel forms against JAX's Pallas kernels in interpret mode
(`_pallas_attention`, `_pallas_attention_batched`, `_pallas_attention_blocked`
with a seed, `_pallas_attention_bwd` with a bias and a seed), the masked and
dropout custom vjps, fully masked rows on both routes, the Bernoulli dropout
of `nn.layers.Dropout` and of the attention's fallback by moments, and
`DiTBlock` under checkpointing with dropout.

Inputs come from seeded numpy generators; seeds for the kernels are injected
as two int32 words on both sides, since torch generators and threefry keys
never agree. Tolerances are relative to max |reference|: float32 1e-5 (the
same arithmetic in another order), bfloat16 2e-2 (a weight near a bf16
rounding boundary may round either way in the two frameworks); the
log-sum-exp, float32 arithmetic in both dtypes, 1e-5.
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
from azula_tpu_torch.nn import dit as tdit
from azula_tpu_torch.nn import layers as tlayers
from azula_tpu_torch.ops import _build
from azula_tpu_torch.ops import attention as tattention

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_LSE = 1e-5

B, H, D = 2, 2, 64
SCALE = 1 / math.sqrt(D)

# seed words with negative and extreme values
SEEDS = [(0, 0), (-1, 7), (2**31 - 1, -(2**31)), (123456789, -987654321)]

# mask shapes of each broadcast mode over (B, H) = (2, 2)
MODES = {"full": (B, H), "batch": (B, 1), "head": (1, H), "one": (1, 1)}


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _torch(a, td=None) -> torch.Tensor:
    r"""A JAX array as a torch tensor (float32 through numpy, then `td`)."""

    t = torch.from_numpy(np.array(jnp.asarray(a, dtype=jnp.float32)))
    return t if td is None else t.to(td)


def _inputs(L, dtype, seed):
    r"""q, k, v and a cotangent g of shape (B, H, L, D), as JAX and torch
    arrays of `dtype`."""

    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4)]
    return [jnp.asarray(a).astype(jd) for a in arrays], [torch.from_numpy(a).to(td) for a in arrays]


def _mask(shape, L, seed):
    r"""A boolean mask of (*shape, L, L) that keeps ~70% and at least the
    first key of every row."""

    mask = np.random.default_rng(seed).random((*shape, L, L)) < 0.7
    mask[..., 0] = True
    return mask


def _biases(mask, jq, tq):
    r"""The bias and mode of `mask` on both sides."""

    jbias, jmode = jattention._mask_to_bias(jnp.asarray(mask), jq)
    tbias, tmode = tattention._mask_to_bias(torch.from_numpy(mask), tq)
    assert jmode == tmode
    return jbias, tbias, tmode


def _lse(lse_lanes, L) -> torch.Tensor:
    r"""The TPU kernels' lane-replicated (B H, L, 128) log-sum-exp as (B, H, L)."""

    return _torch(lse_lanes[..., 0]).reshape(B, H, L)


# the hash


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_dropout_threshold_equals_jax(rate):
    assert tattention._dropout_threshold(rate) == jattention._dropout_threshold(rate)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("seed", SEEDS, ids=lambda s: f"{s[0]}_{s[1]}")
def test_dropout_keep_mask_equals_jax(seed, rate):
    # bit for bit: the logical shifts, the wrapping products and the signed
    # compare (whose threshold is 0 at rate 0.5)
    words = np.array(seed, dtype=np.int32)

    want = np.asarray(jattention.dropout_keep_mask(2, 3, 96, jnp.asarray(words), rate))
    got = tattention.dropout_keep_mask(2, 3, 96, torch.from_numpy(words), rate)

    assert got.dtype == torch.bool and tuple(got.shape) == (2, 3, 96, 96)
    np.testing.assert_array_equal(got.numpy(), want)
    # about 1 - rate of the weights kept (~55k draws: 6 sigma < 0.013)
    assert abs(got.float().mean().item() - (1 - rate)) < 0.013


def test_dropout_seed_draws_from_the_generator():
    generator = torch.Generator().manual_seed(3)
    first = tattention._dropout_seed(generator, torch.device("cpu"))
    second = tattention._dropout_seed(generator, torch.device("cpu"))

    assert first.dtype == torch.int32 and tuple(first.shape) == (2,)
    assert not torch.equal(first, second)
    assert torch.equal(first, tattention._dropout_seed(torch.Generator().manual_seed(3), torch.device("cpu")))


# the bias of a boolean mask


@pytest.mark.parametrize(
    "shape, mode",
    [((B, H), "full"), ((B, 1), "batch"), ((1, H), "head"), ((H,), "head"), ((1,), "one"), ((), "one")],
)
def test_mask_to_bias_equals_jax(shape, mode):
    (jq, *_), (tq, *_) = _inputs(128, "bfloat16", seed=0)
    mask = _mask(shape, 128, seed=1)

    jbias, tbias, got_mode = _biases(mask, jq, tq)

    assert got_mode == mode
    assert tbias.dtype == torch.bfloat16 and tuple(tbias.shape) == tuple(jbias.shape)
    np.testing.assert_array_equal(_f64(tbias), _f64(jbias))


# the biased forward of `_pallas_attention` and `_pallas_attention_batched`


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_biased_forward_matches_jax_kernel(dtype, mode):
    (q, k, v, _), (tq, tk, tv, _) = _inputs(128, dtype, seed=2)
    jbias, tbias, _ = _biases(_mask(MODES[mode], 128, seed=3), q, tq)

    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jattention._pallas_attention(q, k, v, SCALE, jbias, mode, with_lse=True)
    got_o, got_lse = tattention._attention_lse_plain(tq, tk, tv, SCALE, tbias, mode)

    assert _rel_err(got_o, want_o) <= TOL[dtype]
    assert _rel_err(got_lse, _lse(want_lse, 128)) <= TOL_LSE


@pytest.mark.parametrize("mode", ["one", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_biased_batched_forward_matches_jax_kernel(dtype, mode):
    # JAX's dispatch sends "one" and "full" biases at L <= 512 here
    (q, k, v, _), (tq, tk, tv, _) = _inputs(256, dtype, seed=4)
    jbias, tbias, _ = _biases(_mask(MODES[mode], 256, seed=5), q, tq)

    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jattention._pallas_attention_batched(q, k, v, SCALE, jbias, mode, with_lse=True)
    got_o, got_lse = tattention._attention_lse_plain(tq, tk, tv, SCALE, tbias, mode)

    assert _rel_err(got_o, want_o) <= TOL[dtype]
    assert _rel_err(got_lse, _lse(want_lse, 256)) <= TOL_LSE


# dropout: the blocked forward and the backward


def _dropout_case(dtype, L, mode, seed):
    r"""Inputs, biases ("batch" or none) and seed words of a dropout case."""

    (q, k, v, g), (tq, tk, tv, tg) = _inputs(L, dtype, seed=seed)
    if mode is None:
        jbias = tbias = None
        mode = "one"
    else:
        jbias, tbias, mode = _biases(_mask(MODES[mode], L, seed=seed + 1), q, tq)
    words = np.array([-(seed + 5), 2**31 - 17 * seed], dtype=np.int32)
    return (q, k, v, g, jbias, jnp.asarray(words)), (tq, tk, tv, tg, tbias, torch.from_numpy(words)), mode


@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("mode", [None, "batch"], ids=["no_bias", "batch_bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_forward_matches_jax_kernel(dtype, mode, L):
    # `_flash_dropout_impl`: the blocked kernel with the backward's tiling;
    # the LSE is the undropped softmax's
    (q, k, v, _, jbias, seed), (tq, tk, tv, _, tbias, tseed), mode = _dropout_case(dtype, L, mode, seed=6)

    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jattention._flash_dropout_impl(q, k, v, seed, 0.1, SCALE, jbias, mode)
    got_o, got_lse = tattention._attention_lse_plain(tq, tk, tv, SCALE, tbias, mode, tseed, 0.1)
    _, undropped_lse = tattention._attention_lse_plain(tq, tk, tv, SCALE, tbias, mode)

    assert _rel_err(got_o, want_o) <= TOL[dtype]
    assert _rel_err(got_lse, _lse(want_lse, L)) <= TOL_LSE
    assert torch.equal(got_lse, undropped_lse)


@pytest.mark.parametrize(
    "mode, rate", [("batch", 0.0), (None, 0.1), ("batch", 0.1)], ids=["bias", "dropout", "bias_dropout"]
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_backward_matches_jax_kernel(dtype, mode, rate):
    # `_pallas_attention_bwd` with a bias, dropout or both, from the JAX
    # forward's own o and LSE; it takes L <= 512 under either
    (q, k, v, g, jbias, seed), (tq, tk, tv, tg, tbias, tseed), mode = _dropout_case(dtype, 128, mode, seed=8)
    td = DTYPES[dtype][1]

    with pltpu.force_tpu_interpret_mode():
        if rate > 0:
            o, lse = jattention._flash_dropout_impl(q, k, v, seed, rate, SCALE, jbias, mode)
        else:
            o, lse = jattention._pallas_attention(q, k, v, SCALE, jbias, mode, with_lse=True)
        want = jattention._pallas_attention_bwd(q, k, v, o, lse, g, SCALE, jbias, mode, rate, seed)
    got = tattention._attention_bwd_plain(tq, tk, tv, _torch(o, td), _lse(lse, 128), tg, SCALE, tbias, mode, tseed, rate)

    for name, a, b in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert a.dtype == td
        assert _rel_err(a, b) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_dropout_vjp_matches_jax(dtype):
    # JAX's `_flash_dropout_biased` custom vjp under jax.vjp against the
    # port's autograd function on the plain versions
    (q, k, v, g, jbias, seed), (tq, tk, tv, tg, tbias, tseed), mode = _dropout_case(dtype, 128, "batch", seed=10)

    def fn(a, b, c):
        return jattention._flash_dropout_biased(a, b, c, jbias, seed, 0.2, SCALE, mode)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(fn, q, k, v)
        want_grads = vjp(g)

    inputs = [t.requires_grad_() for t in (tq, tk, tv)]
    got = tattention._flash(*inputs, SCALE, "plain", tbias, mode, tseed, 0.2)
    got_grads = torch.autograd.grad(got, inputs, tg)

    assert _rel_err(got, want) <= TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got_grads, want_grads, strict=True):
        assert _rel_err(a, b) <= TOL[dtype], name


def test_dot_product_attention_dropout_on_cpu_matches_jax_kernel(monkeypatch):
    # on the CPU, dropout at the kernels' shapes runs their plain versions:
    # with JAX's seed words injected, the function of `_flash_dropout`
    (q, k, v, g, _, seed), (tq, tk, tv, tg, _, tseed), _ = _dropout_case("float32", 128, None, seed=12)
    monkeypatch.setattr(tattention, "_dropout_seed", lambda generator, device: tseed)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a, b, c: jattention._flash_dropout(a, b, c, seed, 0.1, SCALE), q, k, v)
        want_grads = vjp(g)

    inputs = [t.requires_grad_() for t in (tq, tk, tv)]
    before = dict(_build.LAUNCHES)
    got = tattention.dot_product_attention(*inputs, dropout_rate=0.1, generator=torch.Generator())
    got_grads = torch.autograd.grad(got, inputs, tg)

    assert dict(_build.LAUNCHES) == before
    assert _rel_err(got, want) <= TOL["float32"]
    for a, b in zip(got_grads, want_grads, strict=True):
        assert _rel_err(a, b) <= TOL["float32"]


# fully masked rows


def test_fully_masked_row_on_each_route():
    # The -1e30 bias gives a row masked everywhere the mean of v, in JAX's
    # kernel as in the port's kernel form; the -inf of JAX's XLA path gives
    # NaN, as the port's plain route does.
    (q, k, v, _), (tq, tk, tv, _) = _inputs(128, "float32", seed=14)
    mask = _mask((1, 1), 128, seed=15)
    mask[..., 5, :] = False
    jbias, tbias, mode = _biases(mask, q, tq)

    with pltpu.force_tpu_interpret_mode():
        want_kernel, _ = jattention._pallas_attention(q, k, v, SCALE, jbias, mode, with_lse=True)
    got_kernel, _ = tattention._attention_lse_plain(tq, tk, tv, SCALE, tbias, mode)

    np.testing.assert_allclose(_f64(got_kernel[:, :, 5]), _f64(tv.mean(dim=-2)), rtol=1e-5, atol=1e-6)
    assert _rel_err(got_kernel, want_kernel) <= TOL["float32"]

    want_xla = np.asarray(jattention._xla_attention(q, k, v, jnp.asarray(mask), SCALE))
    got_xla = tattention.dot_product_attention(tq, tk, tv, mask=torch.from_numpy(mask), scale=SCALE).numpy()

    assert np.isnan(got_xla[:, :, 5]).all() and np.isnan(want_xla[:, :, 5]).all()
    rows = np.arange(128) != 5
    assert _rel_err(got_xla[:, :, rows], want_xla[:, :, rows]) <= TOL["float32"]


# Bernoulli dropout, by moments


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_layer_moments(dtype):
    # as JAX's `Dropout`: kept with probability 1 - r, scaled by 1 / (1 - r),
    # in x's dtype; the identity without a generator
    jd, td = DTYPES[dtype]
    rate = 0.3
    x = np.random.default_rng(16).uniform(1, 2, size=(64, 1024)).astype(np.float32)
    layer = tlayers.Dropout(rate)

    y = layer(torch.from_numpy(x).to(td), torch.Generator().manual_seed(0))
    kept = y != 0
    scaled = np.asarray((jnp.asarray(x).astype(jd) / (1 - rate)).astype(jnp.float32))

    assert y.dtype == td
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.01  # 65,536 draws: 7 sigma
    # bf16: both divide by 1 - r rounded to bf16, torch by multiplying with
    # its reciprocal, which may round a value one bf16 ulp away
    got, want = y.float().numpy()[kept.numpy()], scaled[kept.numpy()]
    rtol = 0.0 if dtype == "float32" else 2**-7
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    assert np.mean(got != want) < 1e-3
    assert torch.equal(layer(torch.from_numpy(x)), torch.from_numpy(x))


def test_attention_dropout_fallback_moments():
    # JAX's fallback off the TPU: with v = I, the output is the dropped
    # weights themselves, softmax / (1 - r) where kept, 0 elsewhere
    rate, L = 0.25, 64
    rng = np.random.default_rng(17)
    q, k = (torch.from_numpy(rng.standard_normal((4, 2, L, L)).astype(np.float32)) for _ in range(2))
    v = torch.eye(L).expand(4, 2, L, L)

    got = tattention.dot_product_attention(
        q, k, v, dropout_rate=rate, generator=torch.Generator().manual_seed(1), implementation="plain"
    )
    weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / 8, dim=-1)
    kept = got != 0

    assert abs(kept.float().mean().item() - (1 - rate)) < 0.015  # 32,768 draws: 6 sigma
    np.testing.assert_allclose(got[kept].numpy(), (weights / (1 - rate))[kept].numpy(), rtol=1e-5)

    # JAX's own fallback on the CPU keeps the same share
    jgot = jattention.dot_product_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), dropout_rate=rate, key=jax.random.key(2)
    )
    assert abs(float(jnp.mean(jgot != 0)) - (1 - rate)) < 0.015


# checkpointing with dropout


@pytest.mark.parametrize("L", [16, 128], ids=["bernoulli", "hash"])
def test_checkpointing_keeps_the_dropout(L):
    # the gradients under checkpointing equal those without it for the same
    # generator state: the recompute drops what the forward dropped (at
    # L = 16 the attention's Bernoulli fallback, at 128 the kernels' hash
    # in their plain versions; the FFN's Bernoulli dropout in both)
    generator = torch.Generator().manual_seed(0)
    blocks = [
        tdit.DiTBlock(128, dropout=0.1, checkpointing=checkpointing, attention_heads=2, device="cpu")
        for checkpointing in (False, True)
    ]
    blocks[1].load_state_dict(blocks[0].state_dict())
    x = torch.randn((2, L, 128), generator=generator)
    w = torch.randn((2, L, 128), generator=generator)

    grads = []
    for block in blocks:
        xi = x.clone().requires_grad_()
        (block(xi, generator=torch.Generator().manual_seed(5)) * w).sum().backward()
        grads.append([xi.grad, *(p.grad for p in block.parameters())])

    for a, b in zip(*grads, strict=True):
        assert torch.equal(a, b)

    # and the dropout does act: another generator state, another gradient
    xi = x.clone().requires_grad_()
    (blocks[1](xi, generator=torch.Generator().manual_seed(6)) * w).sum().backward()
    assert not torch.equal(xi.grad, grads[1][0])
