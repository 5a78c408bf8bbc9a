r"""The PyTorch port's fused multi-head self-attention
(`azula_tpu_torch.ops.fused_msa`, `azula_tpu_torch.nn.attention`) against the
JAX package's, on the CPU: the same numpy inputs through both.

On the CPU, JAX's `fused_msa_attention` runs `_reference` and its
`MultiheadSelfAttention` the unfused route; the port runs its plain versions.
The CUDA kernel is held against the same plain version on the card by
`chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process
import types

from azula_tpu.nn import attention as jattention
from azula_tpu.ops import fused_msa as jfused
from azula_tpu.utils.pytree import load_state_dict, state_dict
from azula_tpu_torch.nn import attention as tattention
from azula_tpu_torch.nn.convert import from_jax_state_dict
from azula_tpu_torch.ops import _build
from azula_tpu_torch.ops import fused_msa as tfused

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

B, L, H, D = 2, 128, 2, 64
C = H * D


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float32), dtype=np.float64)


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, L, 3 * C)).astype(np.float32)
    theta = rng.standard_normal((L, C // 2)).astype(np.float32)
    return qkv, theta


@pytest.mark.parametrize("scale", [None, 1.0], ids=["scale_default", "scale_1"])
@pytest.mark.parametrize("eps", [1e-5, None], ids=["eps", "no_eps"])
@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference(dtype, rope, eps, scale):
    # Same op order and rounding points as `_reference`: float32 differs only
    # by summation order (abs 2e-5 on outputs of order 1); bfloat16 rounds q,
    # k, the weights and the output to 8 bits, and a value near a rounding
    # boundary may go either way in the two frameworks (1e-2 of max |ref|).
    jd, td = DTYPES[dtype]
    qkv, theta = _inputs()

    jqkv = jnp.asarray(qkv).astype(jd)
    if rope:
        cos2, sin2 = jfused.rope_tables(jnp.asarray(theta), H)
    else:
        cos2 = sin2 = None
    want = jfused._reference(jqkv, cos2, sin2, H, eps, 1 / math.sqrt(D) if scale is None else scale)

    got = tfused.fused_msa_attention(
        torch.from_numpy(qkv).to(td), H, torch.from_numpy(theta) if rope else None, eps=eps, scale=scale
    )

    assert got.dtype == td and tuple(got.shape) == (B, L, C)
    err = np.abs(_f64(got) - _f64(want)).max()
    if dtype == "float32":
        assert err <= 2e-5
    else:
        assert err <= 1e-2 * np.abs(_f64(want)).max()


def test_rope_tables_match_jax_and_apply_rope():
    Lr, Hr, Dr = 16, 2, 8
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((Lr, Hr * Dr)).astype(np.float32))
    theta = rng.standard_normal((Lr, Hr * Dr // 2)).astype(np.float32)

    cos2, sin2 = tfused.rope_tables(torch.from_numpy(theta), Hr)
    jcos2, jsin2 = jfused.rope_tables(jnp.asarray(theta), Hr)
    assert cos2.dtype == torch.float32 and tuple(cos2.shape) == (Lr, Hr * Dr)
    assert np.abs(_f64(cos2) - _f64(jcos2)).max() <= 1e-6
    assert np.abs(_f64(sin2) - _f64(jsin2)).max() <= 1e-6

    # x * cos2 + swap(x) * sin2 is the port's apply_rope on (H, L, D) heads
    swapped = x.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    got = x * cos2 + swapped * sin2

    xh = x.unflatten(-1, (Hr, Dr)).transpose(0, 1)
    th = torch.from_numpy(theta).unflatten(-1, (Hr, Dr // 2)).transpose(0, 1)
    want, _ = tattention.apply_rope(xh, xh, th)

    assert (want.transpose(0, 1).flatten(-2) - got).abs().max() <= 1e-6


def _msa_pair(qk_norm: bool, rope: bool, seed: int = 0):
    r"""The same random MSA in JAX and in the port (on the CPU)."""

    jmsa = jattention.MultiheadSelfAttention(
        C, pos_channels=2, attention_heads=H, qk_norm=qk_norm, rope=rope, key=jax.random.key(0)
    )
    rng = np.random.default_rng(seed)
    sd = {
        key: (rng.standard_normal(leaf.shape) / (1 if key.endswith("bias") else math.sqrt(leaf.shape[0])))
        .astype(np.float32)
        for key, leaf in state_dict(jmsa).items()
    }
    jmsa = load_state_dict(jmsa, {k: jnp.asarray(v) for k, v in sd.items()})
    jmsa.implementation = "xla"

    tmsa = tattention.MultiheadSelfAttention(
        C, pos_channels=2, attention_heads=H, qk_norm=qk_norm, rope=rope, device="cpu"
    )
    tmsa.load_state_dict(from_jax_state_dict(sd, tmsa))

    x = rng.standard_normal((B, L, C)).astype(np.float32)
    pos = rng.standard_normal((L, 2)).astype(np.float32)

    return jmsa, tmsa, x, pos


@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["no_qk_norm", "qk_norm"])
def test_msa_matches_jax(qk_norm, rope):
    jmsa, tmsa, x, pos = _msa_pair(qk_norm, rope)

    want = jmsa(jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got = tmsa(torch.from_numpy(x), torch.from_numpy(pos))

    assert tuple(got.shape) == (B, L, C)
    assert np.abs(_f64(got) - _f64(want)).max() <= 1e-4


@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["no_qk_norm", "qk_norm"])
def test_fused_plain_matches_unfused_route(qk_norm, rope):
    # the function the kernel computes equals the module's head-split route
    _, tmsa, x, pos = _msa_pair(qk_norm, rope, seed=1)
    x, pos = torch.from_numpy(x), torch.from_numpy(pos)

    with torch.no_grad():
        want = tmsa(x, pos)
        theta = tmsa.theta_proj(pos) if rope else None
        y = tfused.fused_msa_attention(
            tmsa.qkv_proj(x), H, theta, eps=1e-5 if qk_norm else None, implementation="plain"
        )
        got = tmsa.y_proj(y)

    assert (got - want).abs().max() <= 1e-4


def _fake(shape, dtype=torch.bfloat16, device="cuda"):
    r"""Stands in for a tensor on the card: the gate reads only these."""

    return types.SimpleNamespace(shape=tuple(shape), ndim=len(shape), dtype=dtype, device=torch.device(device))


THETA = _fake((256, 192))
GENERATOR = torch.Generator()


@pytest.mark.parametrize(
    "x,heads,theta,mask,dropout,generator,eligible",
    [
        (_fake((2, 256, 384)), 6, THETA, None, 0.0, None, True),  # the dit32 shape
        (_fake((2, 256, 384)), 6, None, None, 0.0, None, True),
        (_fake((2, 256, 384), torch.float32), 6, THETA, None, 0.0, None, True),
        (_fake((2, 256, 384)), 6, THETA, None, 0.1, None, True),  # dropout without a generator: inference
        (_fake((2, 512, 768)), 12, None, None, 0.0, None, True),
        (_fake((2, 256, 384), device="cpu"), 6, THETA, None, 0.0, None, False),  # the CPU takes the unfused route
        (_fake((2, 256, 384)), 6, THETA, _fake((256, 256), torch.bool), 0.0, None, False),
        (_fake((2, 256, 384)), 6, THETA, None, 0.1, GENERATOR, False),
        (_fake((2, 256, 384)), 6, _fake((1, 256, 192)), None, 0.0, None, False),  # batched theta
        (_fake((256, 384)), 6, THETA, None, 0.0, None, False),
        (_fake((2, 100, 384)), 6, None, None, 0.0, None, False),  # L % 128
        (_fake((2, 640, 384)), 6, None, None, 0.0, None, False),  # L > 512
        (_fake((2, 256, 384)), 16, None, None, 0.0, None, False),  # heads > 12
        (_fake((2, 256, 384)), 12, None, None, 0.0, None, False),  # D = 32
        (_fake((2, 256, 320)), 1, None, None, 0.0, None, False),  # D = 320 > 256
        (_fake((2, 256, 384), torch.float16), 6, None, None, 0.0, None, False),
    ],
)
def test_eligibility_gate(x, heads, theta, mask, dropout, generator, eligible):
    assert tfused.fused_msa_eligible(x, heads, theta, mask, dropout, generator) == eligible


def test_eligibility_on_cpu_tensors():
    x = torch.zeros((2, 256, 384), dtype=torch.bfloat16)
    theta = torch.zeros((256, 192), dtype=torch.bfloat16)

    assert not tfused.fused_msa_eligible(x, 6, theta, None, 0.0, None)


def test_implementations_and_no_launch_on_cpu():
    qkv, theta = _inputs(2)
    qkv, theta = torch.from_numpy(qkv), torch.from_numpy(theta)
    before = dict(_build.LAUNCHES)

    auto = tfused.fused_msa_attention(qkv, H, theta)
    assert torch.equal(auto, tfused.fused_msa_attention(qkv, H, theta, implementation="plain"))
    with pytest.raises(ValueError):
        tfused.fused_msa_attention(qkv, H, theta, implementation="kernel")
    with pytest.raises(ValueError):
        tfused.fused_msa_attention(qkv, H, theta, implementation="pallas")

    _, tmsa, x, pos = _msa_pair(True, True)
    with torch.no_grad():
        tmsa(torch.from_numpy(x), torch.from_numpy(pos))

    assert dict(_build.LAUNCHES) == before
    assert _build.LAUNCHES["fused_msa"] == 0


@pytest.mark.parametrize("implementation", ["ring", "ulysses"])
def test_sequence_parallel_routes_not_ported(implementation, monkeypatch):
    # the sequence-parallel routes are ported (azula_tpu_torch.parallel):
    # the MSA hands the split, normalized and rotated heads and its
    # `ring_axis` to the route's local function, as JAX's dispatch does; the
    # multi-rank runs are tests/test_torch_ring.py and test_torch_ulysses.py
    from azula_tpu_torch.parallel import ring, ulysses

    module = {"ring": ring, "ulysses": ulysses}[implementation]
    seen = {}

    def local(q, k, v, axis=None, mask=None, **kwargs):
        seen.update(axis=axis, shape=tuple(q.shape), kwargs=kwargs)
        return tattention.dot_product_attention(q, k, v, mask=mask)

    monkeypatch.setattr(module, f"{implementation}_attention_local", local)

    _, tmsa, x, pos = _msa_pair(True, True)
    want = tmsa(torch.from_numpy(x), torch.from_numpy(pos))
    tmsa.implementation, tmsa.ring_axis = implementation, "data"
    got = tmsa(torch.from_numpy(x), torch.from_numpy(pos))

    assert seen["axis"] == "data" and seen["shape"] == (B, H, L, D)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)

    tmsa.dropout = 0.1
    if implementation == "ring":
        with pytest.raises(NotImplementedError, match="ulysses"):
            tmsa(torch.from_numpy(x), torch.from_numpy(pos), generator=torch.Generator())
    else:
        tmsa(torch.from_numpy(x), torch.from_numpy(pos), generator=torch.Generator())
        assert seen["kwargs"]["dropout_rate"] == 0.1
