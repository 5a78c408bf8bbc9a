r"""The port's Ulysses attention (`azula_tpu_torch.parallel.ulysses`) against
the JAX package's, one case beside each of `tests/test_ulysses.py`.

The port's side runs in 4 `gloo` processes (`tests/torch_dist.py`, suite
"ulysses"), started once for the file; the JAX side runs the unsplit
`_xla_attention`, which JAX's own tests hold its `ulysses_attention` to,
and `ulysses_attention` with dropout on the 8 virtual CPU devices, here,
while the ranks work. Tolerances, relative to max |JAX| in float32: forwards 2e-5
(each softmax sums 32 or 64 keys), gradients 1e-4. The dropout draws of the
port (`torch.Generator`s folded with the rank) and of JAX (threefry keys
folded with the axis index) differ, so dropout is held to JAX by its
moments, and bit for bit to one process running the rank's heads with the
folded generator.
"""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest

import torch_cpu  # noqa: F401  one thread a process
import torch_dist

from azula_tpu.nn.dit import DiT as JaxDiT
from azula_tpu.ops.attention import _xla_attention
from azula_tpu.parallel import make_mesh, ulysses_attention
from azula_tpu.utils.pytree import combine, filter_eval_shape, load_state_dict, partition, state_dict
from azula_tpu_torch.nn.convert import from_jax_state_dict

TOL = 2e-5
TOL_GRAD = 1e-4


def _qkv(seed: int, shape) -> dict:
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(shape).astype(np.float32) for name in "qkv"}


def _dit_inputs(seed: int, heads: int) -> dict:
    rng = np.random.default_rng(seed)
    jdit = filter_eval_shape(JaxDiT, **torch_dist.SP_DIT, attention_heads=heads, key=jax.random.key(seed))
    sd = {}
    for key, leaf in state_dict(jdit).items():
        shape = tuple(leaf.shape)
        scale = 0.2 if key.endswith("bias") else 0.5 if key.endswith("param") else 1 / math.sqrt(shape[0])
        sd[key] = (scale * rng.standard_normal(shape)).astype(np.float32)
    B, L, C = 2, 32, torch_dist.SP_DIT["in_channels"]
    pos = np.arange(L, dtype=np.float32)[:, None] * np.ones((B, 1, 1), np.float32)
    return {
        "jax": load_state_dict(jdit, {k: jnp.asarray(v) for k, v in sd.items()}),
        "state": from_jax_state_dict(sd),
        "x": rng.standard_normal((B, L, C)).astype(np.float32),
        "mod": rng.standard_normal((8,)).astype(np.float32),
        "pos": pos,
    }


def _dit_reference(case: dict) -> dict:
    jdit = case.pop("jax")
    x, mod, pos = (jnp.asarray(case[k]) for k in ("x", "mod", "pos"))

    params, static = partition(jdit)

    def loss(p):
        y = combine(p, static)(x, mod=mod, pos=pos)
        return jnp.sum(y**2), y

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    grads = state_dict(combine(grads, static))
    return {
        "out": np.asarray(out),
        "grads": {k: v.numpy() for k, v in from_jax_state_dict({k: np.array(v) for k, v in grads.items()}).items()},
    }


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("ulysses")
    inputs = {
        "matches_full": _qkv(0, (2, 8, 64, 16)),
        "grads": _qkv(1, (1, 8, 32, 8)),
        "dit_sequence_parallel": _dit_inputs(2, heads=8),
        "mask": {**_qkv(3, (2, 8, 64, 16)), "mask": np.tril(np.ones((64, 64), dtype=bool))},
        "dropout": _qkv(4, (2, 8, 64, 16)),
        "tp_composition": _qkv(5, (2, 4, 16, 16)),
    }
    jax_dit = inputs["dit_sequence_parallel"].pop("jax")
    procs = torch_dist.launch("ulysses", directory, inputs)

    try:
        mesh = make_mesh(model=1)
        refs = {}
        for name in ("matches_full", "mask", "dropout"):
            q, k, v = (jnp.asarray(inputs[name][c]) for c in "qkv")
            mask = inputs[name].get("mask")
            refs[name] = {"xla": np.asarray(_xla_attention(q, k, v, mask=None if mask is None else jnp.asarray(mask)))}
        q, k, v = (jnp.asarray(inputs["dropout"][c]) for c in "qkv")
        refs["dropout"]["jax_dropout"] = np.asarray(ulysses_attention(q, k, v, mesh, dropout_rate=0.5, key=jax.random.key(4)))
        for name in ("grads", "tp_composition"):
            q, k, v = (jnp.asarray(inputs[name][c]) for c in "qkv")
            refs[name] = {
                "xla": np.asarray(_xla_attention(q, k, v)),
                "grads": [np.asarray(g) for g in jax.grad(lambda q, k, v: jnp.sum(_xla_attention(q, k, v) ** 2), argnums=(0, 1, 2))(q, k, v)],
            }
        refs["dit_sequence_parallel"] = _dit_reference({**inputs["dit_sequence_parallel"], "jax": jax_dit})
    finally:
        outs = torch_dist.collect(procs, directory)

    return outs, refs


def _case(ranks, name: str) -> list[dict]:
    outs, _ = ranks
    for out in outs:
        assert "error" not in out[name], out[name]["error"]
    return [out[name] for out in outs]


def test_ranks_import_no_jax(ranks):
    outs, _ = ranks
    assert all(out["modules"] == [] for out in outs)


def test_ulysses_attention_matches_full(ranks):
    got = _case(ranks, "matches_full")[0]
    want = ranks[1]["matches_full"]

    assert got["local"] == (2, 8, 16, 16)  # the output stays split along the sequence
    assert _rel(got["out"], want["xla"]) <= TOL


def test_ulysses_attention_grads(ranks):
    got = _case(ranks, "grads")[0]
    want = ranks[1]["grads"]

    for g, w in zip(got["grads"], want["grads"], strict=True):
        assert _rel(g, w) <= TOL_GRAD


def test_ulysses_head_divisibility(ranks):
    for got in _case(ranks, "head_divisibility"):
        assert got["raised"] is not None and "divisible" in got["raised"]


def test_dit_sequence_parallel_ulysses(ranks):
    got = _case(ranks, "dit_sequence_parallel")[0]
    want = ranks[1]["dit_sequence_parallel"]

    assert _rel(got["out"], want["out"]) <= TOL
    assert set(got["grads"]) == set(want["grads"])
    for key, g in got["grads"].items():
        assert _rel(g, want["grads"][key]) <= TOL_GRAD, key


def test_ulysses_attention_mask(ranks):
    got = _case(ranks, "mask")[0]
    want = ranks[1]["mask"]

    assert _rel(got["out"], want["xla"]) <= TOL


def test_ulysses_attention_dropout(ranks):
    got = _case(ranks, "dropout")
    want = ranks[1]["dropout"]
    ref = want["xla"]

    # rate ~ 0 is the deterministic result; a real rate is finite, differs
    # from it and is the same again from the same generator state
    out = got[0]["out"].numpy()
    assert _rel(got[0]["out0"], ref) <= 1e-4
    assert np.isfinite(out).all()
    assert not np.allclose(out, ref, atol=1e-3)
    assert np.array_equal(out, got[0]["again"].numpy())

    # each rank's heads are what one process draws with the folded generator
    assert all(g["own_heads_equal"] for g in got)

    # by moments against JAX's dropout: the shift from the deterministic
    # output has mean ~0 (dropout is unbiased) and the same mean square; the
    # 16,384 outputs put the estimates' spread well under the bounds
    ours, theirs = out - ref, want["jax_dropout"] - ref
    scale = np.sqrt(np.mean(theirs**2))
    assert abs(np.mean(ours)) <= 0.05 * scale and abs(np.mean(theirs)) <= 0.05 * scale
    assert abs(np.mean(ours**2) / np.mean(theirs**2) - 1) <= 0.1


def test_ulysses_tp_composition(ranks):
    got = _case(ranks, "tp_composition")[0]
    want = ranks[1]["tp_composition"]

    assert _rel(got["out"], want["xla"]) <= TOL
    assert _rel(got["grads"][0], want["grads"][0]) <= TOL_GRAD
