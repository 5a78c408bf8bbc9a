r"""The port's pipelines and serving recipes (`azula_tpu_torch.parallel.pp`,
`azula_tpu_torch.parallel.recipes`) against the JAX package's, one case
beside each of `tests/test_parallel.py`'s pipeline and serving tests.

The port's side runs in one group of 4 `gloo` processes for the whole file
(`tests/torch_dist.py`, suite "pipeline"): the pipelines on a (model=4)
mesh, the Flux server on (data=2, model=2). The JAX side runs here while the
ranks work, at the JAX tests' sizes: the sequential forwards, jitted, which
JAX's own tests hold equal to its pipelines, and its serving placement on
a (data=2, model=2) mesh of its virtual devices. Each module carries the
same random weights in both (the port's from `from_jax_state_dict`). The
lone-stage exchange runs here too, in this process.

Tolerances, relative to max |JAX|, float32: forwards 1e-5; gradients 1e-4
of the largest gradient; DDIM trajectories 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

import torch_dist

from jax.sharding import Mesh, NamedSharding
from azula_tpu.guidance import CFGDenoiser
from azula_tpu.models.flux import FluxDenoiser
from azula_tpu.models.flux import backbone as jflux
from azula_tpu.nn.dit import DiT as JaxDiT
from azula_tpu.nn.dit import DiTBlock as JaxDiTBlock
from azula_tpu.parallel import flux_serving_shardings
from azula_tpu.parallel.tp import _path_str
from azula_tpu.sample import DDIMSampler
from azula_tpu.utils.pytree import combine, partition, state_dict
from azula_tpu_torch.models.flux import convert as tflux_convert
from azula_tpu_torch.nn import convert as tnn_convert
from azula_tpu_torch.parallel import pp
from test_torch_parallel import _model, _normal, _port_state
from test_torch_ulysses import _case, _rel
from test_torch_vae import load_jax, random_state, skeleton

TOL = 1e-5
TOL_GRAD = 1e-4
TOL_DDIM = 1e-4

L, B, D = 8, 8, 16


def _inputs() -> tuple[dict, dict]:
    rng = np.random.default_rng(0)
    inputs, jax_models = {}, {}

    inputs["blocks_equality"] = {
        "w": _normal(rng, (L, D, D), 1 / np.sqrt(D)),
        "b": _normal(rng, (L, D), 0.1),
        "x": _normal(rng, (B, D)),
    }

    blocks, states = [], []
    for seed in range(4):
        jblock = skeleton(JaxDiTBlock, **torch_dist.PP_BLOCK)
        sd = random_state(jblock, 10 + seed)
        blocks.append(load_jax(jblock, sd))
        states.append(_port_state(tnn_convert, sd))
    jax_models["blocks"] = blocks
    inputs["real_dit_blocks"] = {"states": states, "x": _normal(rng, (4, 8, 32))}

    inputs["blocks_grads"] = {"w": _normal(rng, (4, D, D), 1 / np.sqrt(D)), "x": _normal(rng, (B, D))}

    inputs["blocks_pytree_state"] = {
        "w": _normal(rng, (4, D, D), 1 / np.sqrt(D)),
        "x": _normal(rng, (B, D)),
        "scale": _normal(rng, (B, 1), 0.1) + 1.0,
        "shift": _normal(rng, (D,), 0.1),
    }

    cases = {}
    jmodel, state = _model(JaxDiT, tnn_convert, 20, **torch_dist.PP_DIT)
    jax_models["dit"] = jmodel
    cases["mod=(B,D)"] = {"state": state, "x": _normal(rng, (B, 16, 3)), "mod": _normal(rng, (B, 16))}
    cases["mod=(D,)"] = {"state": state, "x": _normal(rng, (B, 16, 3)), "mod": _normal(rng, (16,))}
    jmodel, state = _model(JaxDiT, tnn_convert, 21, **torch_dist.PP_DIT, rope=True)
    jax_models["dit_rope"] = jmodel
    cases["pos=(B,L,P)"] = {
        "state": state, "config": {"rope": True},
        "x": _normal(rng, (B, 16, 3)), "pos": _normal(rng, (B, 16, 1)), "mod": _normal(rng, (1, 16)),
    }
    inputs["dit_equality"] = cases

    jmodel, state = _model(JaxDiT, tnn_convert, 22, **{**torch_dist.PP_DIT, "hid_blocks": 4})
    jax_models["dit_grads"] = jmodel
    inputs["dit_grads"] = {"state": state, "x": _normal(rng, (B, 16, 3)), "mod": _normal(rng, (B, 16))}

    jax_models["flux"], state = _model(jflux.FluxTransformer, tflux_convert, 23, **torch_dist.FLUX)
    inputs["serve_flux"] = {
        "state": state,
        "x1": _normal(rng, (8, 4, 4, 16)),
        "positive": {"prompt_clip": _normal(rng, (8, 20)), "prompt_t5": _normal(rng, (8, 6, 32)), "guidance": 4.0},
        "negative": {"prompt_clip": np.zeros((8, 20), np.float32), "prompt_t5": np.zeros((8, 6, 32), np.float32), "guidance": 4.0},
    }

    return inputs, jax_models


def _tanh_blocks(params, x):
    for i in range(params["w"].shape[0]):
        x = x + jnp.tanh(x @ params["w"][i] + params["b"][i])
    return x


def _serving_specs(denoiser) -> dict:
    r"""JAX's serving placement on a (data=2, model=2) mesh, as the port's
    placements read it: per mesh dim, the split dimension in torch's layout
    (a Linear weight's dims reversed) or None, by the port's names."""

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    specs = flux_serving_shardings(denoiser, mesh, min_size=torch_dist.FLUX_MIN_SIZE)

    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda s: isinstance(s, NamedSharding))
    for path, sharding in leaves:
        if not isinstance(sharding, NamedSharding):
            continue
        name = tflux_convert._rename(_path_str(path).lstrip("."))
        if name.endswith(".scale"):
            name = name.removesuffix(".scale") + ".weight"
        out[name] = tuple(sharding.spec) + (None,) * 8
    return out


def _references(inputs: dict, jax_models: dict) -> dict:
    refs = {}

    case = {k: jnp.asarray(v) for k, v in inputs["blocks_equality"].items()}
    refs["blocks_equality"] = np.asarray(jax.jit(_tanh_blocks)({"w": case["w"], "b": case["b"]}, case["x"]))

    x = jnp.asarray(inputs["real_dit_blocks"]["x"])
    mod = jnp.ones((1, 16))
    params = [partition(b) for b in jax_models["blocks"]]

    def seq(arrays, x):
        for a, (_, static) in zip(arrays, params, strict=True):
            x = combine(a, static)(x, mod)
        return x

    refs["real_dit_blocks"] = np.asarray(jax.jit(seq)([a for a, _ in params], x))

    case = {k: jnp.asarray(v) for k, v in inputs["blocks_grads"].items()}

    def seq_loss(w, x):
        for i in range(w.shape[0]):
            x = x + jnp.tanh(x @ w[i])
        return jnp.sum(x**2)

    gw, gx = jax.jit(jax.grad(seq_loss, argnums=(0, 1)))(case["w"], case["x"])
    refs["blocks_grads"] = {"w": np.asarray(gw), "x": np.asarray(gx)}

    case = {k: jnp.asarray(v) for k, v in inputs["blocks_pytree_state"].items()}
    h = case["x"]
    for i in range(4):
        h = h + jnp.tanh(case["scale"] * (h @ case["w"][i]) + case["shift"])
    refs["blocks_pytree_state"] = {"h": np.asarray(h), "scale": inputs["blocks_pytree_state"]["scale"]}

    refs["dit_equality"] = {}
    for name, case in inputs["dit_equality"].items():
        jmodel = jax_models["dit_rope" if "pos" in case else "dit"]
        arrays, static = partition(jmodel)
        kwargs = {k: jnp.asarray(case[k]) for k in ("pos",) if k in case}
        fn = jax.jit(lambda a, x, m, kw, static=static: combine(a, static)(x, m, **kw))
        refs["dit_equality"][name] = np.asarray(fn(arrays, jnp.asarray(case["x"]), jnp.asarray(case["mod"]), kwargs))

    case = inputs["dit_grads"]
    arrays, static = partition(jax_models["dit_grads"])
    gx, gm, ga = jax.jit(jax.grad(lambda x, m, a: jnp.sum(combine(a, static)(x, m) ** 2), argnums=(0, 1, 2)))(
        jnp.asarray(case["x"]), jnp.asarray(case["mod"]), arrays
    )
    grads = {k: np.array(v) for k, v in state_dict(combine(ga, static)).items()}
    refs["dit_grads"] = {
        "x": np.asarray(gx),
        "mod": np.asarray(gm),
        "params": {k: v.numpy() for k, v in tnn_convert.from_jax_state_dict(grads).items()},
    }

    case = inputs["serve_flux"]
    denoiser = FluxDenoiser(backbone=jax_models["flux"])
    x1 = jnp.asarray(case["x1"])
    positive, negative = ({k: jnp.asarray(v) for k, v in case[c].items()} for c in ("positive", "negative"))
    refs["serve_flux"] = {
        "out": np.asarray(DDIMSampler(denoiser, eta=0.0, steps=3)(x1, **positive)),
        "cfg": np.asarray(
            DDIMSampler(CFGDenoiser(denoiser), eta=0.0, steps=3)(x1, positive=positive, negative=negative, guidance=2.5)
        ),
        "specs": _serving_specs(denoiser),
    }

    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("pipeline")
    inputs, jax_models = _inputs()
    inputs["serve_flux"]["directory"] = str(directory / "checkpoint")

    procs = torch_dist.launch("pipeline", directory, inputs)

    try:
        refs = _references(inputs, jax_models)
    finally:
        outs = torch_dist.collect(procs, directory)

    return outs, refs, inputs


def _got(ranks, name: str) -> list[dict]:
    outs, _, _ = ranks
    return _case((outs, None), name)


def test_ranks_import_no_jax(ranks):
    outs, _, _ = ranks
    assert all(out["modules"] == [] for out in outs)


@pytest.mark.parametrize("microbatches", [None, 8], ids=["M=S", "M=8"])
def test_pipeline_blocks_equality(ranks, microbatches):
    _, refs, _ = ranks
    for got in _got(ranks, "blocks_equality"):
        assert _rel(got[f"M={microbatches}"], refs["blocks_equality"]) <= TOL


def test_pipeline_lone_stages_equal_the_ranks(ranks):
    r"""The 4 stages driven one after another in this process by the
    lone-stage exchange give the 4 ranks' output."""

    _, _, inputs = ranks
    case = inputs["blocks_equality"]
    params = {k: torch.as_tensor(case[k]) for k in ("w", "b")}
    k = L // torch_dist.WORLD

    received, launches = None, []
    with torch.no_grad():
        for s in range(torch_dist.WORLD):
            exchange = pp.LoneStage(received)
            local = [{n: v[s * k + i] for n, v in params.items()} for i in range(k)]
            out = pp.pipeline_stage(torch_dist.tanh_block, local, torch.as_tensor(case["x"]), s, torch_dist.WORLD, exchange)
            received = exchange.sent
            launches.append(sorted(exchange.sent))

    assert launches[:-1] == [[0, 1, 2, 3]] * 3 and launches[-1] == []
    for got in _got(ranks, "blocks_equality"):
        assert torch.equal(out, got["M=None"])


def test_pipeline_real_dit_blocks(ranks):
    _, refs, _ = ranks
    for got in _got(ranks, "real_dit_blocks"):
        assert _rel(got["out"], refs["real_dit_blocks"]) <= TOL
        assert got["refused"]


def test_pipeline_blocks_grads(ranks):
    _, refs, _ = ranks
    want = refs["blocks_grads"]
    scale = max(np.abs(w).max() for w in want.values())
    for got in _got(ranks, "blocks_grads"):
        for key in ("w", "x"):
            assert np.abs(got[key].numpy() - want[key]).max() <= TOL_GRAD * scale, key


def test_pipeline_blocks_pytree_state(ranks):
    _, refs, _ = ranks
    for got in _got(ranks, "blocks_pytree_state"):
        assert _rel(got["h"], refs["blocks_pytree_state"]["h"]) <= TOL
        assert torch.equal(got["scale"], torch.as_tensor(refs["blocks_pytree_state"]["scale"]))


@pytest.mark.parametrize("case", ["mod=(B,D)", "mod=(D,)"])
def test_pipeline_dit_equality(ranks, case):
    _, refs, _ = ranks
    for got in _got(ranks, "dit_equality"):
        assert got[case].shape == refs["dit_equality"][case].shape
        assert _rel(got[case], refs["dit_equality"][case]) <= TOL


def test_pipeline_dit_batched_pos_and_broadcast_mod(ranks):
    _, refs, _ = ranks
    for got in _got(ranks, "dit_equality"):
        assert _rel(got["pos=(B,L,P)"], refs["dit_equality"]["pos=(B,L,P)"]) <= TOL


def test_pipeline_dit_grads(ranks):
    r"""Every rank holds the sequential forward's input, modulation and
    replicated parameters' gradients (the backward sent back through the
    stages), and the gradients of its own stage's blocks and of no other's."""

    _, refs, _ = ranks
    want = refs["dit_grads"]
    scale = max(np.abs(w).max() for w in (want["x"], want["mod"], *want["params"].values()))
    k = 4 // torch_dist.WORLD
    for rank, got in enumerate(_got(ranks, "dit_grads")):
        for key in ("x", "mod"):
            assert np.abs(got[key].numpy() - want[key]).max() <= TOL_GRAD * scale, key

        own = {n for n in want["params"] if not n.startswith("blocks.") or int(n.split(".")[1]) // k == rank}
        assert set(got["params"]) == own, rank
        for name in own:
            assert np.abs(got["params"][name].numpy() - want["params"][name]).max() <= TOL_GRAD * scale, name


@pytest.mark.parametrize("path", ["out", "cfg", "mb"], ids=["distilled", "cfg", "chunked"])
def test_serve_flux_sampling_equality(ranks, path):
    r"""The serving recipe on (data=2, model=2) against JAX's unsharded DDIM
    sampler: the distilled path, fused-batch CFG against JAX's two-call CFG,
    and the chunked batch."""

    _, refs, _ = ranks
    want = refs["serve_flux"]["out" if path == "out" else "cfg"]
    for got in _got(ranks, "serve_flux"):
        assert got[path].shape == want.shape
        assert _rel(got[path], want) <= TOL_DDIM


def test_flux_serving_shardings_split_over_both_dims(ranks):
    r"""The port's placement is JAX's, parameter by parameter; a TP weight
    is split over both dims (its piece a quarter of it), and the pieces join
    back into the whole parameters."""

    _, refs, _ = ranks
    want = refs["serve_flux"]["specs"]
    for got in _got(ranks, "serve_flux"):
        assert set(got["specs"]) == set(want)
        for name, spec in got["specs"].items():
            ndim = len(got["pieces"][name])
            jax_spec = want[name][:ndim]
            for axis, (kind, dim) in zip(("data", "model"), spec, strict=True):
                if axis not in jax_spec:
                    assert kind == "Replicate", (name, axis)
                    continue
                d = jax_spec.index(axis)
                assert dim == (ndim - 1 - d if ndim == 2 else d), (name, axis)

        both = [n for n, spec in got["specs"].items() if spec[0][0] == "Shard" and spec[1][0] != "Replicate"]
        assert both
        assert got["unjoined"] == []
        assert got["dims"] == [("data", False), ("model", False), ("model", True)]


def test_serve_flux_refuses_another_placement(ranks):
    r"""A denoiser placed with another `min_size`, or by `shard_module`, is
    not served as if `serve_flux` had placed it."""

    for got in _got(ranks, "serve_flux"):
        assert set(got["refused"]) == {"min_size", "shard_module"}
        for case, message in got["refused"].items():
            assert message is not None and "already placed" in message, (case, message)


def test_serve_flux_sharded_checkpoint_roundtrip(ranks):
    r"""A serving placement saved by `save_checkpoint_sharded` loads into
    another placed denoiser, every piece bit for bit."""

    for got in _got(ranks, "serve_flux"):
        assert got["restored"]
