r"""The PyTorch port's attention training route against the JAX package's, on
the CPU: the LSE forward of `_pallas_attention`, the backward kernels
`_pallas_attention_bwd` and `_pallas_attention_batched_bwd`, the `_flash`
custom vjp, `dot_product_attention`'s gradient, the card's routing, and a
small ViT denoiser at 64 x 64 (L = 1024, past the fused gate) trained through
the unfused attention.

JAX's kernels are Pallas kernels; they run here in interpret mode
(`pltpu.force_tpu_interpret_mode()`), and the port's plain versions are held
against them. The CUDA kernels are held against the same plain versions on
the card by `chip_smoke.py`. Inputs come from seeded numpy generators.
Tolerances are relative to max |reference|: float32 1e-5 (the same
arithmetic summed in another order) and 2e-5 for gradients composed through
a model; bfloat16 2e-2 (a value near a bf16 rounding boundary may round
either way in the two frameworks, and ds and p are rounded to bf16 before
the products). The log-sum-exp is float32 arithmetic on the same inputs in
both dtypes and is held to 1e-5.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from jax.experimental.pallas import tpu as pltpu

from azula_tpu import denoise as jdenoise
from azula_tpu import noise as jnoise
from azula_tpu.nn import embedding as jembedding
from azula_tpu.nn import vit as jvit
from azula_tpu.ops import attention as jattention
from azula_tpu.utils.pytree import combine, load_state_dict, partition, state_dict
from azula_tpu_torch import denoise as tdenoise
from azula_tpu_torch import noise as tnoise
from azula_tpu_torch.nn import attention as tnn_attention
from azula_tpu_torch.nn import embedding as tembedding
from azula_tpu_torch.nn import vit as tvit
from azula_tpu_torch.nn.convert import from_jax_state_dict
from azula_tpu_torch.ops import _build
from azula_tpu_torch.ops import attention as tattention

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_LSE = 1e-5
TOL_COMPOSED = 2e-5

# one (batch, head) pair per head at dit64's head dim
B, H, D = 1, 2, 64
SCALE = 1 / math.sqrt(D)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(L, dtype, seed):
    r"""q, k, v and a cotangent g of shape (B, H, L, D), as JAX and torch
    arrays of `dtype`."""

    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4)]
    return [jnp.asarray(a).astype(jd) for a in arrays], [torch.from_numpy(a).to(td) for a in arrays]


def _torch(a, td=None) -> torch.Tensor:
    r"""A JAX array as a torch tensor (float32 through numpy, then `td`)."""

    t = torch.from_numpy(np.array(jnp.asarray(a, dtype=jnp.float32)))
    return t if td is None else t.to(td)


def _lse(lse_lanes) -> torch.Tensor:
    r"""The TPU kernels' lane-replicated (B H, L, 128) log-sum-exp as (B, H, L)."""

    return _torch(lse_lanes[..., 0]).reshape(B, H, -1)


# the LSE forward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_forward_matches_jax_kernel(dtype):
    (q, k, v, _), (tq, tk, tv, _) = _inputs(1024, dtype, seed=0)

    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jattention._pallas_attention(q, k, v, SCALE, with_lse=True)
    got_o, got_lse = tattention._attention_lse_plain(tq, tk, tv, SCALE)

    assert got_o.dtype == DTYPES[dtype][1] and tuple(got_o.shape) == (B, H, 1024, D)
    assert got_lse.dtype == torch.float32 and tuple(got_lse.shape) == (B, H, 1024)
    assert _rel_err(got_o, want_o) <= TOL[dtype]
    assert _rel_err(got_lse, _lse(want_lse)) <= TOL_LSE


# the backward


def _assert_grads(got, want, tol):
    assert len(got) == len(want) == 3
    for name, a, b in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert _rel_err(a, b) <= tol, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_kernel(dtype):
    # `_pallas_attention_bwd` (dq_kernel, dkv_kernel) at L = 1024 from the
    # JAX forward's own o and LSE
    td = DTYPES[dtype][1]
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(1024, dtype, seed=1)

    with pltpu.force_tpu_interpret_mode():
        o, lse = jattention._pallas_attention(q, k, v, SCALE, with_lse=True)
        want = jattention._pallas_attention_bwd(q, k, v, o, lse, g, SCALE)
    got = tattention._attention_bwd_plain(tq, tk, tv, _torch(o, td), _lse(lse), tg, SCALE)

    assert all(t.dtype == td for t in got)
    _assert_grads(got, want, TOL[dtype])


@pytest.mark.parametrize("with_lse", [True, False], ids=["lse", "lse_none"])
@pytest.mark.parametrize("L", [256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_batched_kernel(dtype, L, with_lse):
    # `_pallas_attention_batched_bwd`: from the forward's LSE, or with
    # lse=None, where the TPU kernel recomputes the softmax and the port
    # rebuilds it from its own LSE forward
    td = DTYPES[dtype][1]
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(L, dtype, seed=2)

    with pltpu.force_tpu_interpret_mode():
        o, lse = jattention._pallas_dispatch(q, k, v, SCALE, with_lse=with_lse)
        want = jattention._pallas_attention_batched_bwd(q, k, v, o, lse, g, SCALE)

    tlse = _lse(lse) if with_lse else tattention._attention_lse_plain(tq, tk, tv, SCALE)[1]
    got = tattention._attention_bwd_plain(tq, tk, tv, _torch(o, td), tlse, tg, SCALE)

    _assert_grads(got, want, TOL[dtype])


@pytest.mark.parametrize("L", [100, 300])
def test_backward_is_the_gradient(L):
    # the plain backward against autograd through the plain forward, float32
    _, (q, k, v, g) = _inputs(L, "float32", seed=3)
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    o, lse = tattention._attention_lse_plain(q, k, v, 0.3)
    want = torch.autograd.grad(o, (q, k, v), g)
    got = tattention._attention_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), g, 0.3)

    _assert_grads(got, want, TOL["float32"])


# the `_flash` custom vjp and `dot_product_attention`


@pytest.mark.parametrize("L", [256, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_vjp_matches_jax(dtype, L):
    # JAX's `_flash` under jax.vjp (the batched kernels at L = 256, the LSE
    # forward and `_pallas_attention_bwd` at 1024) against the plain route
    td = DTYPES[dtype][1]
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(L, dtype, seed=4)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a, b, c: jattention._flash(a, b, c, SCALE, False), q, k, v)
        want_grads = vjp(g)

    inputs = [t.requires_grad_() for t in (tq, tk, tv)]
    got = tattention._flash(*inputs, SCALE)
    got_grads = torch.autograd.grad(got, inputs, tg)

    assert got.dtype == td and all(t.dtype == td for t in got_grads)
    assert _rel_err(got, want) <= TOL[dtype]
    _assert_grads(got_grads, want_grads, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_product_attention_gradient_on_cpu_matches_jax(dtype):
    # off the card both packages differentiate the XLA-style plain version
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(512, dtype, seed=5)

    def loss(a, b, c):
        y = jattention.dot_product_attention(a, b, c)
        return jnp.sum(y.astype(jnp.float32) * g.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    inputs = [t.requires_grad_() for t in (tq, tk, tv)]
    before = dict(_build.LAUNCHES)
    (tattention.dot_product_attention(*inputs).float() * tg.float()).sum().backward()

    assert dict(_build.LAUNCHES) == before
    _assert_grads([t.grad for t in inputs], want, TOL[dtype])


def test_flash_implementations_on_cpu(monkeypatch):
    _, (q, k, v, g) = _inputs(128, "float32", seed=6)
    before = dict(_build.LAUNCHES)

    assert torch.equal(tattention._flash(q, k, v, 0.125), tattention._flash(q, k, v, 0.125, implementation="plain"))
    with pytest.raises(ValueError, match="CUDA"):
        tattention._flash(q, k, v, 0.125, implementation="kernel")
    with pytest.raises(ValueError):
        tattention._flash(q, k, v, 0.125, implementation="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tattention._attention_lse_kernel(q, k, v, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        tattention._attention_bwd_kernel(q, k, v, q, q[..., 0], g, 0.125)

    # on the CPU, `dot_product_attention` under grad stays the plain version
    # under autograd
    monkeypatch.setattr(tattention, "_flash", lambda *a, **kw: pytest.fail("the CPU took the kernels' route"))
    q.requires_grad_()
    tattention.dot_product_attention(q, k, v).sum().backward()
    assert q.grad is not None

    assert dict(_build.LAUNCHES) == before
    assert _build.LAUNCHES["attention_fwd_lse"] == _build.LAUNCHES["attention_bwd"] == 0


@pytest.mark.parametrize(
    "requires, mode, max_free, route",
    [
        ("q", "grad", False, "flash"),
        ("v", "grad", False, "flash"),
        ("", "grad", False, "attention_fwd"),
        ("qkv", "no_grad", False, "attention_fwd"),
        ("qkv", "inference", False, "attention_fwd"),
        # JAX's `_flash_fwd` ignores max_free: training takes the exact route
        ("qkv", "grad", True, "flash"),
        ("qkv", "no_grad", True, "attention_fwd_max_free"),
    ],
)
def test_kernel_route(monkeypatch, requires, mode, max_free, route):
    # the card's route, as JAX's custom vjp picks it: `_flash` when autograd
    # records the call, else the inference forward (CPU tensors stand in for
    # CUDA ones with implementation='kernel')
    calls = []
    monkeypatch.setattr(tattention, "_flash", lambda *a, **kw: calls.append(("flash", kw)))
    monkeypatch.setattr(tattention, "_attention_kernel", lambda *a: calls.append(("attention_fwd", {})))
    monkeypatch.setattr(tattention, "_attention_max_free_kernel", lambda *a: calls.append(("attention_fwd_max_free", {})))

    _, (q, k, v, _) = _inputs(640, "float32", seed=7)
    for name, t in zip("qkv", (q, k, v), strict=True):
        t.requires_grad_(name in requires)

    context = {"grad": torch.enable_grad, "no_grad": torch.no_grad, "inference": torch.inference_mode}[mode]
    with context():
        tattention.dot_product_attention(q, k, v, implementation="kernel", max_free=max_free)

    assert [name for name, _ in calls] == [route]
    if route == "flash":
        assert calls[0][1] == {"implementation": "kernel"}


# (q shape, k shape, dtype, mask shape or "float", dropout rate, autograd
# mode) -> the route JAX's dispatch gives: the kernels' autograd function
# ("flash") or inference forward ("attention_fwd") with the bias mode and
# dropout, or the plain versions ("plain", or "dropout_plain", the Bernoulli
# fallback)
ROUTES = {
    "mask_batch_grad": ((2, 3, 512, 64), None, torch.float32, (2, 1, 512, 512), 0.0, "grad", ("flash", "batch", False)),
    "mask_full_no_grad": ((2, 3, 512, 64), None, torch.float32, (2, 3, 512, 512), 0.0, "no_grad",
                          ("attention_fwd", "full", False)),
    "mask_one_grad": ((1, 2, 1024, 128), None, torch.bfloat16, (1024, 1024), 0.0, "grad", ("flash", "one", False)),
    "mask_head_d256": ((2, 2, 512, 256), None, torch.float32, (2, 512, 512), 0.0, "no_grad",
                       ("attention_fwd", "head", False)),
    # without dropout, masked calls below L = 512 take XLA in JAX
    "mask_below_floor": ((2, 3, 256, 64), None, torch.float32, (2, 1, 256, 256), 0.0, "grad", ("plain",)),
    # float masks keep their gradient on the plain route
    "float_mask": ((2, 3, 512, 64), None, torch.float32, "float", 0.0, "grad", ("plain",)),
    # a mask that broadcasts to (L, L) only along its keys
    "mask_rows": ((2, 3, 512, 64), None, torch.float32, (512, 1), 0.0, "grad", ("plain",)),
    "dropout_grad": ((2, 3, 128, 64), None, torch.float32, None, 0.1, "grad", ("flash", None, True)),
    "dropout_no_grad": ((2, 3, 128, 64), None, torch.bfloat16, None, 0.1, "no_grad", ("attention_fwd", None, True)),
    "dropout_mask_grad": ((2, 3, 256, 192), None, torch.float32, (2, 1, 256, 256), 0.1, "grad",
                          ("flash", "batch", True)),
    "dropout_ragged": ((2, 3, 100, 64), None, torch.float32, None, 0.1, "grad", ("dropout_plain",)),
    "dropout_d32": ((2, 3, 128, 32), None, torch.float32, None, 0.1, "grad", ("dropout_plain",)),
    # cross-attention (SD's 77 text tokens, heads of 40) and JiT-H's heads of 80
    "cross_attention": ((2, 8, 256, 40), (2, 8, 77, 40), torch.float32, None, 0.0, "grad", ("plain",)),
    "d80": ((1, 16, 256, 80), None, torch.bfloat16, None, 0.0, "no_grad", ("plain",)),
    "ndim3": ((6, 256, 64), None, torch.float32, None, 0.0, "no_grad", ("plain",)),
    "float16": ((1, 2, 256, 64), None, torch.float16, None, 0.0, "no_grad", ("plain",)),
    # unmasked self-attention keeps the kernels at every L and head dim
    "d192_grad": ((1, 2, 256, 192), None, torch.float32, None, 0.0, "grad", ("flash", None, False)),
    "d256_no_grad": ((1, 2, 200, 256), None, torch.bfloat16, None, 0.0, "no_grad", ("attention_fwd", None, False)),
    # more (batch, head) pairs than a grid's y dimension takes
    "many_pairs": ((35000, 2, 1, 32), None, torch.float32, None, 0.0, "no_grad", ("attention_fwd", None, False)),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_kernel_route_masks_and_dropout(monkeypatch, case):
    # the card's route for masks, dropout and the shapes no kernel takes, as
    # JAX's `_use_pallas` decides it (CPU tensors stand in for CUDA ones with
    # implementation='kernel'); nothing launches
    q_shape, k_shape, dtype, mask_shape, rate, mode, route = ROUTES[case]
    calls = []

    def flash(q, k, v, scale, implementation=None, bias=None, mode="one", seed=None, rate=0.0):
        calls.append(("flash", None if bias is None else mode, seed is not None))

    def attention_fwd(q, k, v, scale, bias=None, mode="one", seed=None, rate=0.0):
        calls.append(("attention_fwd", None if bias is None else mode, seed is not None))

    monkeypatch.setattr(tattention, "_flash", flash)
    monkeypatch.setattr(tattention, "_attention_kernel", attention_fwd)
    monkeypatch.setattr(tattention, "_attention_max_free_kernel", lambda *a: pytest.fail("the max-free kernel ran"))
    monkeypatch.setattr(tattention, "_attention_plain", lambda *a, **kw: calls.append(("plain",)))
    monkeypatch.setattr(tattention, "_attention_dropout_plain", lambda *a, **kw: calls.append(("dropout_plain",)))

    q = torch.zeros(q_shape, dtype=dtype)
    k = v = torch.zeros(k_shape or q_shape, dtype=dtype)
    if mask_shape == "float":
        mask = torch.zeros(q_shape[-2:]).requires_grad_()
    elif mask_shape is not None:
        mask = torch.ones(mask_shape, dtype=torch.bool)
    else:
        mask = None
    q.requires_grad_(mode == "grad")

    context = torch.enable_grad if mode == "grad" else torch.no_grad
    with context():
        tattention.dot_product_attention(
            q, k, v, mask=mask, dropout_rate=rate, generator=torch.Generator(), implementation="kernel"
        )

    assert calls == [route]


def test_cpu_dropout_routes():
    # on the CPU, dropout at the kernels' shapes takes their plain versions
    # (one seed, one mask on both devices); 'plain' takes JAX's fallback
    _, (q, k, v, _) = _inputs(128, "float32", seed=8)
    auto = [tattention.dot_product_attention(q, k, v, dropout_rate=0.5, generator=torch.Generator().manual_seed(i))
            for i in (0, 0, 1)]
    plain = tattention.dot_product_attention(
        q, k, v, dropout_rate=0.5, generator=torch.Generator().manual_seed(0), implementation="plain"
    )

    assert torch.equal(auto[0], auto[1]) and not torch.equal(auto[0], auto[2])
    assert not torch.equal(auto[0], plain)
    assert torch.isfinite(plain).all()


@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
def test_unfused_route_hands_one_dtype_in_bf16(monkeypatch, rope):
    # the float32 QK-norm and RoPE cast back to the activations' dtype, so the
    # kernels, which refuse mixed dtypes, get bf16 q, k and v
    seen = []

    def record(q, k, v, **kwargs):
        seen.append((q.dtype, k.dtype, v.dtype))
        return v

    monkeypatch.setattr(tnn_attention, "dot_product_attention", record)
    generator = torch.Generator().manual_seed(0)
    msa = tnn_attention.MultiheadSelfAttention(
        128, pos_channels=2, attention_heads=2, rope=rope, device="cpu", generator=generator
    ).to(torch.bfloat16)
    x = torch.randn((2, 64, 128), generator=generator).to(torch.bfloat16)
    pos = torch.randn((64, 2), generator=generator).to(torch.bfloat16)

    y = msa(x, pos)

    assert seen == [(torch.bfloat16,) * 3]
    assert y.dtype == torch.bfloat16


# a small ViT denoiser at 64 x 64: 1024 tokens of two heads of 64


SMALL = dict(mod_features=16, hid_channels=128, hid_blocks=2, patch_size=2, attention_heads=2)  # noqa: C408
SIDE = 64


def test_vit_64_loss_gradients_match_jax():
    # with RoPE, the route with the most steps between the projection and the
    # attention
    rope = True
    k1, k2 = jax.random.split(jax.random.key(0))
    jbackbone = jembedding.Modulated(jvit.ViT(3, 3, rope=rope, **SMALL, key=k1), 16, key=k2)

    rng = np.random.default_rng(9)
    sd = {}
    for key, leaf in state_dict(jbackbone).items():
        scale = 0.2 if key.endswith("bias") else 1 / math.sqrt(leaf.shape[0])
        sd[key] = (scale * rng.standard_normal(leaf.shape)).astype(np.float32)
    jbackbone = load_state_dict(jbackbone, {k: jnp.asarray(v) for k, v in sd.items()})

    tbackbone = tembedding.Modulated(tvit.ViT(3, 3, rope=rope, **SMALL, device="cpu"), 16, device="cpu")
    tbackbone.load_state_dict(from_jax_state_dict(sd, tbackbone))
    td = tdenoise.KarrasDenoiser(tbackbone, tnoise.VPSchedule())

    x = rng.standard_normal((2, SIDE, SIDE, 3)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, size=2).astype(np.float32)
    key = jax.random.key(10)
    params, static = partition(jbackbone)

    def loss_fn(p):
        denoiser = jdenoise.KarrasDenoiser(combine(p, static), jnoise.VPSchedule())
        return denoiser.loss(jnp.asarray(x), jnp.asarray(t), key)

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want_grads = from_jax_state_dict(
        {k: np.array(v) for k, v in state_dict(combine(grads, static)).items()}, td.backbone
    )
    z = torch.from_numpy(np.array(jax.random.normal(key, x.shape, dtype=jnp.float32)))

    got = td._loss(torch.from_numpy(x), torch.from_numpy(t), z)
    got.backward()

    assert abs(got.item() - float(want)) <= TOL["float32"] * abs(float(want))
    named = dict(td.backbone.named_parameters())
    assert set(named) == set(want_grads)
    for name, param in named.items():
        assert param.grad is not None, name
        assert _rel_err(param.grad, want_grads[name]) <= TOL_COMPOSED, name
