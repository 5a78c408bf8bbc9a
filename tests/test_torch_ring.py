r"""The port's ring attention (`azula_tpu_torch.parallel.ring`) against the
JAX package's, one case beside each of `tests/test_ring.py`, and each
rank's loops over the ring, driven alone in one process, against the
whole-sequence attention.

The port's side runs in 4 `gloo` processes (`tests/torch_dist.py`, suite
"ring"), started once for the file; the JAX side runs the unsplit
`_xla_attention`, which JAX's own tests hold its `ring_attention` to, and
`ring_attention` in bf16 on the 8 virtual CPU devices, here, while the
ranks work. Tolerances, relative to max |JAX|: float32 forwards 2e-5 (each
softmax sums 32 or 64 keys), gradients 1e-4.

The ring step merges each block's normalized output by log-sum-exp where
JAX's online softmax carries an unnormalized float32 sum against a running
max: the same function, rounded elsewhere. In float32 both stay within the
forward tolerance. In bf16 the port's plain LSE forward rounds each block's
exp-weights to bf16 against the block's max and each block's output to
bf16 before the float32 merge, where JAX rounds the weights against the
running max and the output once: each is within a few bf16 roundings
(2^-8 relative) of the exact attention, so the two are held within
`TOL_BF16` = 2^-6 of max |JAX|, four such roundings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

import torch_dist

from azula_tpu.ops.attention import _xla_attention
from azula_tpu.parallel import make_mesh, ring_attention
from azula_tpu_torch.ops.attention import _attention_bwd_plain, _attention_lse_plain, _mask_to_bias
from azula_tpu_torch.parallel.ring import LoneRank, ring_backward, ring_forward
from test_torch_ulysses import _case, _dit_inputs, _dit_reference, _qkv, _rel

TOL = 2e-5
TOL_GRAD = 1e-4
TOL_BF16 = 2**-6


def _mask(L: int) -> np.ndarray:
    mask = np.tril(np.ones((L, L), dtype=bool))
    mask[:, 50:] = False  # also mask a key band
    return mask


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("ring")
    inputs = {
        "matches_full": _qkv(0, (2, 4, 64, 16)),
        "matches_full_bf16": _qkv(0, (2, 4, 64, 16)),
        "grads": _qkv(1, (1, 2, 32, 8)),
        "dit_sequence_parallel": _dit_inputs(2, heads=2),
        "mask": {**_qkv(3, (2, 4, 64, 16)), "mask": _mask(64)},
    }
    jax_dit = inputs["dit_sequence_parallel"].pop("jax")
    procs = torch_dist.launch("ring", directory, inputs)

    try:
        mesh = make_mesh(model=1)
        refs = {}
        q, k, v = (jnp.asarray(inputs["matches_full"][c]) for c in "qkv")
        refs["matches_full"] = {"xla": np.asarray(_xla_attention(q, k, v))}
        qb, kb, vb = (t.astype(jnp.bfloat16) for t in (q, k, v))
        refs["matches_full_bf16"] = {"jax": np.asarray(ring_attention(qb, kb, vb, mesh).astype(jnp.float32))}
        for name in ("grads", "mask"):
            q, k, v = (jnp.asarray(inputs[name][c]) for c in "qkv")
            mask = inputs[name].get("mask")
            mask = None if mask is None else jnp.asarray(mask)

            def loss(q, k, v, mask=mask):
                y = _xla_attention(q, k, v, mask=mask)
                return jnp.sum(y**2), y

            (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
            refs[name] = {"xla": np.asarray(out), "grads": [np.asarray(g) for g in grads]}
        refs["dit_sequence_parallel"] = _dit_reference({**inputs["dit_sequence_parallel"], "jax": jax_dit})
    finally:
        outs = torch_dist.collect(procs, directory)

    return outs, refs


def test_ranks_import_no_jax(ranks):
    outs, _ = ranks
    assert all(out["modules"] == [] for out in outs)


def test_ring_attention_matches_full(ranks):
    got = _case(ranks, "matches_full")[0]
    want = ranks[1]["matches_full"]

    assert got["local"] == (2, 4, 16, 16)  # the output stays split along the sequence
    assert _rel(got["out"], want["xla"]) <= TOL


def test_ring_merge_against_online_softmax_bf16(ranks):
    got = _case(ranks, "matches_full_bf16")[0]
    want = ranks[1]["matches_full_bf16"]

    assert _rel(got["out"], want["jax"]) <= TOL_BF16


def test_ring_attention_grads(ranks):
    got = _case(ranks, "grads")[0]
    want = ranks[1]["grads"]

    # dq as in JAX's test, and dk, dv, which travel back around the ring
    for g, w in zip(got["grads"], want["grads"], strict=True):
        assert _rel(g, w) <= TOL_GRAD


def test_dit_sequence_parallel_forward_and_grads(ranks):
    got = _case(ranks, "dit_sequence_parallel")[0]
    want = ranks[1]["dit_sequence_parallel"]

    assert _rel(got["out"], want["out"]) <= TOL
    assert set(got["grads"]) == set(want["grads"])
    for key, g in got["grads"].items():
        assert _rel(g, want["grads"][key]) <= TOL_GRAD, key


def test_ring_attention_mask(ranks):
    got = _case(ranks, "mask")[0]
    want = ranks[1]["mask"]

    assert _rel(got["out"], want["xla"]) <= TOL
    for g, w in zip(got["grads"], want["grads"], strict=True):
        assert _rel(g, w) <= TOL_GRAD


def test_ring_refusals(ranks):
    for got in _case(ranks, "per_head_mask_raises"):
        assert got["raised"] is not None and "head-broadcast" in got["raised"]
    for got in _case(ranks, "msa_refuses_dropout"):
        assert got["raised"] is not None and "ulysses" in got["raised"]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_ring_step_over_blocks_is_the_whole_attention(masked):
    r"""One process drives each rank of a 4-rank ring alone through the
    ring's loops (`ring_forward`, `ring_backward` with `LoneRank`): the
    merged output and log-sum-exp are the whole sequence's, and the blocks'
    gradients summed over the ranks are its gradients (the plain versions on
    the CPU, float32)."""

    rng = np.random.default_rng(7)
    B, H, L, D, n = 2, 3, 64, 16, 4
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32)) for _ in range(4))
    scale = D**-0.5
    bias, mode = _mask_to_bias(torch.from_numpy(_mask(L)), q) if masked else (None, "one")

    o, lse = _attention_lse_plain(q, k, v, scale, bias, mode)
    dq, dk, dv = _attention_bwd_plain(q, k, v, o, lse, g, scale, bias, mode)

    Lb = L // n
    rows = [slice(i * Lb, (i + 1) * Lb) for i in range(n)]
    blocks = [torch.stack([k[:, :, s], v[:, :, s]]) for s in rows]
    dkv = torch.zeros((2, B, H, L, D))
    for r, s in enumerate(rows):
        b = None if bias is None else bias[:, None, s]
        o_r, lse_r = ring_forward(q[:, :, s], blocks[r], scale, b, mode, r, n, LoneRank(blocks, r))
        assert _rel(o_r, o[:, :, s]) <= TOL
        assert _rel(lse_r, lse[:, :, s]) <= TOL

        # the other ranks add nothing: the gradients this rank passes on are
        # its share, and its own block's come home as it sent them
        ring = LoneRank(blocks, r)
        dq_r, home = ring_backward(q[:, :, s], blocks[r], o_r, lse_r, g[:, :, s], scale, b, mode, r, n, ring)
        assert _rel(dq_r, dq[:, :, s]) <= TOL_GRAD
        assert torch.equal(home, ring.sent[0])
        for j, t in enumerate(ring.block_grads()):
            dkv[:, :, :, rows[j]] += t

    assert _rel(dkv[0], dk) <= TOL_GRAD
    assert _rel(dkv[1], dv) <= TOL_GRAD
