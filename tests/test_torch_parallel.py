r"""The port's parallel layer (`azula_tpu_torch.parallel`, the sharded
checkpoints of `azula_tpu_torch.utils.checkpoint`) against the JAX
package's, one case beside each of `tests/test_parallel.py` up to the
pipelines.

The port's side runs in 4 `gloo` processes (`tests/torch_dist.py`, suite
"parallel"), started once for the file, on meshes of (data=4), (data=2,
model=2) and (replica=2, data=1, model=2) where JAX's tests use its 8
virtual CPU devices; the JAX side runs here while the ranks work: the
unsplit modules, jitted, which JAX's own tests hold equal to its sharded
ones, and its sampler on the 8-device mesh. Split modules' gradients are
held to one rank's on the whole batch (Megatron's collectives must leave
them so), DiT's, FSDP's and the train step's also to JAX's. Each module carries the same
random weights in both (the port's from `from_jax_state_dict`).

Tolerances, relative to max |JAX|, float32: forwards 1e-5, or 2e-5 where a
softmax sums 64 keys or more (the SD UNet's self-attention over 256
pixels); gradients 1e-4 of the module's largest gradient; the parameters after three AdamW steps within 1e-4
of their largest move plus four float32 ulps of their values (AdamW divides
each gradient by its root mean square, which hides a gradient's scale: the
first step's gradients are held to JAX's as well). The data-parallel paths are also held bit for bit
to one rank on the whole batch where the same float sums run (sampling),
and the checkpoints bit for bit to what was saved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

import torch_dist

from azula_tpu.denoise import KarrasDenoiser
from azula_tpu.models.flux import backbone as jflux
from azula_tpu.models.sana import backbone as jsana
from azula_tpu.models.sd import backbone as jsd
from azula_tpu.nn.dit import DiT as JaxDiT
from azula_tpu.noise import RectifiedSchedule, VPSchedule
from azula_tpu.parallel import make_mesh, shard_batch
from azula_tpu.sample import DDIMSampler
from azula_tpu.train import make_train_step
from azula_tpu.utils.pytree import combine, partition, state_dict
from azula_tpu_torch import denoise as tdenoise
from azula_tpu_torch import noise as tnoise
from azula_tpu_torch import sample as tsample
from azula_tpu_torch.models.flux import convert as tflux_convert
from azula_tpu_torch.models.sana import convert as tsana_convert
from azula_tpu_torch.models.sd import convert as tsd_convert
from azula_tpu_torch.nn import convert as tnn_convert
from dummies import Dummy
from test_parallel import TimeDiT
from test_torch_ulysses import _case, _rel
from test_torch_vae import load_jax, random_state, skeleton

TOL = 1e-5
TOL_SOFTMAX = 2e-5
TOL_GRAD = 1e-4
TOL_TRAIN = 1e-4


def _normal(rng, shape, scale=1.0) -> np.ndarray:
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _port_state(convert, sd: dict) -> dict:
    return {k: v.clone() for k, v in convert.from_jax_state_dict(sd).items()}


def _model(cls, convert, seed: int, **config):
    jmodel = skeleton(cls, **config)
    sd = random_state(jmodel, seed)
    return load_jax(jmodel, sd), _port_state(convert, sd)


def _forward(jmodel, call) -> dict:
    r"""JAX's output, jitted."""

    params, static = partition(jmodel)
    return {"out": np.asarray(jax.jit(lambda p: call(combine(p, static)))(params))}


def _forward_and_grads(jmodel, call, convert) -> dict:
    r"""JAX's output and every parameter's gradient of the sum of its
    squares, in the port's layout."""

    params, static = partition(jmodel)

    def loss(p):
        y = call(combine(p, static))
        return jnp.sum(y**2), y

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    grads = {k: np.array(v) for k, v in state_dict(combine(grads, static)).items()}

    return {"out": np.asarray(out), "grads": {k: v.numpy() for k, v in convert.from_jax_state_dict(grads).items()}}


def _dummy_inputs(seed: int):
    jmodel = Dummy(torch_dist.DUMMY, key=jax.random.key(seed))
    sd = {k: np.array(v) for k, v in state_dict(jmodel).items()}
    return jmodel, _port_state(tnn_convert, sd)


def _inputs() -> tuple[dict, dict]:
    rng = np.random.default_rng(0)
    inputs, jax_models = {}, {}

    jmodel, state = _dummy_inputs(0)
    jax_models["dummy"] = jmodel
    inputs["data_parallel_sampling"] = {"state": state, "x1": _normal(rng, (16, torch_dist.DUMMY))}
    inputs["sample_sharded"] = {"state": state}

    jax_models["dit"], state = _model(JaxDiT, tnn_convert, 1, **torch_dist.TP_DIT)
    inputs["tensor_parallel_dit"] = {"state": state, "x": _normal(rng, (8, 16, 3)), "mod": np.ones((8, 16), np.float32)}

    jax_models["flux"], state = _model(jflux.FluxTransformer, tflux_convert, 2, **torch_dist.FLUX)
    H = W = 4
    grid = np.stack(np.meshgrid(np.zeros(1), np.arange(H), np.arange(W), indexing="ij"), axis=-1)
    inputs["tensor_parallel_flux"] = {
        "state": state,
        "hidden_states": _normal(rng, (4, H * W, 16)),
        "timestep": np.asarray([0.3, 0.9, 0.5, 0.7], np.float32),
        "encoder_hidden_states": _normal(rng, (4, 6, 32)),
        "pooled_projections": _normal(rng, (4, 20)),
        "guidance": np.full((4,), 4.0, np.float32),
        "img_ids": grid.reshape(-1, 3).astype(np.float32),
        "txt_ids": np.zeros((6, 3), np.float32),
    }

    for name, qk_norm in (("sana1", False), ("sana15", True)):
        jax_models[name], state = _model(jsana.SanaTransformer, tsana_convert, 3, **torch_dist.SANA, qk_norm=qk_norm)
        inputs[f"tensor_parallel_{name}"] = {
            "state": state,
            "hidden_states": _normal(rng, (4, 8, 8, 8)),
            "timestep": np.asarray([300.0, 800.0, 100.0, 500.0], np.float32),
            "encoder_hidden_states": _normal(rng, (4, 6, 24)),
            "encoder_attention_mask": np.ones((4, 6), np.float32),
        }

    jax_models["sd"], state = _model(jsd.SDUNet, tsd_convert, 4, **torch_dist.SD)
    inputs["tensor_parallel_sd"] = {
        "state": state,
        "x": _normal(rng, (4, 16, 16, 4)),
        "t": np.asarray([1.0, 5.0, 9.0, 3.0], np.float32),
        "ctx": _normal(rng, (4, 7, 24)),
    }

    jax_models["fsdp"], state = _model(JaxDiT, tnn_convert, 5, **torch_dist.FSDP_DIT)
    inputs["fsdp_forward"] = {"state": state, "x": _normal(rng, (8, 16, 3))}

    _, state = _model(JaxDiT, tnn_convert, 6, **torch_dist.CKPT_DIT)
    inputs["sharded_checkpoint_roundtrip"] = {"state": state, "x": _normal(rng, (4, 8, 3))}

    jmodel = TimeDiT(skeleton(JaxDiT, **torch_dist.TRAIN_DIT), torch_dist.TRAIN_DIT["mod_features"])
    sd = random_state(jmodel, 7)
    jax_models["train"] = load_jax(jmodel, sd)
    inputs["dp_tp_train_step"] = {
        "state": _port_state(tnn_convert, sd),
        "x": _normal(rng, (8, 16, 3)),
        "t": rng.uniform(0.05, 0.95, size=8).astype(np.float32),
    }

    return inputs, jax_models


def _references(inputs: dict, jax_models: dict) -> dict:
    refs = {}
    mesh = make_mesh()

    case = inputs["data_parallel_sampling"]
    sampler = DDIMSampler(KarrasDenoiser(backbone=jax_models["dummy"], schedule=VPSchedule()), steps=8)
    refs["data_parallel_sampling"] = {"jax": np.asarray(sampler(shard_batch(jnp.asarray(case["x1"]), mesh)))}

    # the port's own initial noise, through JAX's sampler
    tsampler = tsample.DDIMSampler(tdenoise.KarrasDenoiser(torch.nn.Identity(), tnoise.VPSchedule()), steps=8)
    x1 = tsampler.init((16, torch_dist.DUMMY), generator=torch.Generator().manual_seed(3))
    refs["sample_sharded"] = {"x1": x1, "jax": np.asarray(sampler(shard_batch(jnp.asarray(x1.numpy()), mesh)))}

    case = inputs["tensor_parallel_dit"]
    x, mod = jnp.asarray(case["x"]), jnp.asarray(case["mod"])
    refs["tensor_parallel_dit"] = _forward_and_grads(jax_models["dit"], lambda m: m(x, mod), tnn_convert)

    case = {k: jnp.asarray(v) for k, v in inputs["tensor_parallel_flux"].items() if k != "state"}
    refs["tensor_parallel_flux"] = _forward(jax_models["flux"], lambda m: m(**case))

    for name in ("sana1", "sana15"):
        case = {k: jnp.asarray(v) for k, v in inputs[f"tensor_parallel_{name}"].items() if k != "state"}
        refs[f"tensor_parallel_{name}"] = _forward(jax_models[name], lambda m, case=case: m(**case))

    case = inputs["tensor_parallel_sd"]
    x, t, ctx = (jnp.asarray(case[k]) for k in ("x", "t", "ctx"))
    refs["tensor_parallel_sd"] = _forward(jax_models["sd"], lambda m: m(x, t, ctx))

    x = jnp.asarray(inputs["fsdp_forward"]["x"])
    refs["fsdp_forward"] = _forward_and_grads(jax_models["fsdp"], lambda m: m(x), tnn_convert)

    case = inputs["dp_tp_train_step"]
    denoiser = KarrasDenoiser(backbone=jax_models["train"], schedule=RectifiedSchedule())
    params, static = partition(denoiser)
    optimizer = optax.adamw(1e-4)
    opt_state = optimizer.init(params)
    step = make_train_step(static, optimizer, donate=False)
    x, t = jnp.asarray(case["x"]), jnp.asarray(case["t"])
    keys = [jax.random.fold_in(jax.random.key(8), i) for i in range(torch_dist.TRAIN_STEPS)]
    start = {k: np.array(v) for k, v in state_dict(combine(params, static).backbone).items()}
    grads = jax.jit(jax.grad(lambda p: combine(p, static).loss(x, t, key=keys[0])))(params)
    grads = {k: np.array(v) for k, v in state_dict(combine(grads, static).backbone).items()}
    for k in keys:
        params, opt_state, _ = step(params, opt_state, x, t, k)
    after = {k: np.array(v) for k, v in state_dict(combine(params, static).backbone).items()}
    refs["dp_tp_train_step"] = {
        # the noise each step's loss drew, which the ranks take in its place
        "z": [np.asarray(jax.random.normal(k, x.shape, dtype=x.dtype)) for k in keys],
        "params": {k: v.numpy() for k, v in tnn_convert.from_jax_state_dict(after).items()},
        "start": {k: v.numpy() for k, v in tnn_convert.from_jax_state_dict(start).items()},
        "grads": {k: v.numpy() for k, v in tnn_convert.from_jax_state_dict(grads).items()},
    }

    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("parallel")
    inputs, jax_models = _inputs()
    inputs["sharded_checkpoint_roundtrip"]["directory"] = str(directory / "checkpoints")

    # the training noise is JAX's: drawn before the ranks start
    z = [np.asarray(jax.random.normal(jax.random.fold_in(jax.random.key(8), i), (8, 16, 3))) for i in range(torch_dist.TRAIN_STEPS)]
    inputs["dp_tp_train_step"]["z"] = z
    procs = torch_dist.launch("parallel", directory, inputs)

    try:
        refs = _references(inputs, jax_models)
    finally:
        outs = torch_dist.collect(procs, directory)

    return outs, refs


def _close_grads(got: dict, want: dict) -> None:
    r"""Every gradient within `TOL_GRAD` of the module's largest: a
    gradient that vanishes analytically (a bias before a normalization, a
    key bias under the softmax) is float noise in both."""

    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for key, g in got.items():
        assert np.abs(g.numpy() - want[key]).max() <= TOL_GRAD * scale, key


def test_ranks_import_no_jax(ranks):
    outs, _ = ranks
    assert all(out["modules"] == [] for out in outs)


def test_data_parallel_sampling(ranks):
    got = _case(ranks, "data_parallel_sampling")

    assert all(g["rows"] == (4, torch_dist.DUMMY) for g in got)  # each rank sampled its rows
    assert all(g["equal"] for g in got)  # gathered, one rank's trajectory bit for bit
    assert _rel(got[0]["out"], ranks[1]["data_parallel_sampling"]["jax"]) <= TOL


def test_sample_sharded(ranks):
    got = _case(ranks, "sample_sharded")
    want = ranks[1]["sample_sharded"]

    assert all(g["rows"] == (4, torch_dist.DUMMY) for g in got)
    assert all(g["equal"] for g in got)
    assert torch.equal(got[0]["x1"], want["x1"])  # every rank drew the whole x1
    assert bool(torch.isfinite(got[0]["out"]).all())
    assert _rel(got[0]["out"], want["jax"]) <= TOL


@pytest.mark.parametrize(
    "name, tol",
    [("dit", TOL), ("flux", TOL), ("sana1", TOL), ("sana15", TOL), ("sd", TOL_SOFTMAX)],
)
def test_tensor_parallel_forward_and_grads(ranks, name, tol):
    got = _case(ranks, f"tensor_parallel_{name}")[0]
    want = ranks[1][f"tensor_parallel_{name}"]

    assert got["split"], "no parameter split over 'model'"
    assert _rel(got["out"], want["out"]) <= tol
    # every gradient against one rank's on the whole batch, and DiT's also
    # against JAX's (JAX's tests hold the families' split forward only)
    _close_grads(got["grads"], {k: v.numpy() for k, v in got["alone"].items()})
    if "grads" in want:
        _close_grads(got["grads"], want["grads"])


def test_tensor_parallel_heads(ranks):
    # each rank holds half of every attention's heads
    assert _case(ranks, "tensor_parallel_dit")[0]["heads"] == [2]
    assert _case(ranks, "tensor_parallel_flux")[0]["heads"] == [1]
    assert _case(ranks, "tensor_parallel_sana1")[0]["heads"] == [1, 2]
    assert _case(ranks, "tensor_parallel_sd")[0]["heads"] == [1]


def test_fsdp_forward(ranks):
    got = _case(ranks, "fsdp_forward")
    want = ranks[1]["fsdp_forward"]

    assert got[0]["n_split"] > 0
    assert got[0]["local_numel"] < got[0]["numel"]  # the large parameters are split
    assert _rel(got[0]["out"], want["out"]) <= TOL
    _close_grads(got[0]["grads"], want["grads"])


def test_sharded_checkpoint_roundtrip(ranks):
    for got in _case(ranks, "sharded_checkpoint_roundtrip"):
        for layout in ("tp", "fsdp"):
            assert got[layout]["params"] and got[layout]["optimizer"] and got[layout]["out"], layout
            assert got[layout]["groups"] == 1e-4


def test_dp_tp_train_step(ranks):
    got = _case(ranks, "dp_tp_train_step")
    want = ranks[1]["dp_tp_train_step"]

    assert all(bool(torch.isfinite(torch.stack(g["losses"])).all()) for g in got)
    for g in got:
        # the first step's gradients, averaged over 'data', are JAX's
        _close_grads({k.removeprefix("backbone."): v for k, v in g["grads"].items()}, want["grads"])

        params = {k.removeprefix("backbone."): v for k, v in g["params"].items()}
        alone = {k.removeprefix("backbone."): v for k, v in g["alone"].items()}
        assert set(params) == set(want["params"]) == set(alone)
        for key, p in params.items():
            step = np.abs(want["params"][key] - want["start"][key]).max()
            assert step > 0, key
            # against JAX's make_train_step, and against one rank on the whole
            # batch: within TOL_TRAIN of the parameters' largest move plus
            # four ulps of their float32 values
            tol = TOL_TRAIN * step + 4 * np.spacing(np.abs(want["params"][key]).max())
            assert np.abs(p.numpy() - want["params"][key]).max() <= tol, key
            assert np.abs(p.numpy() - alone[key].numpy()).max() <= tol, key


def test_make_hybrid_mesh(ranks):
    for got in _case(ranks, "hybrid_mesh"):
        assert got["names"] == ("replica", "data", "model")
        assert got["shape"] == (2, 1, 2)
        # the all-reduce over 'model' adds the two column pieces
        assert torch.equal(got["out"], got["want"])


def test_make_hybrid_mesh_defaults(ranks):
    for got in _case(ranks, "hybrid_mesh_defaults"):
        assert got["shape"] == (1, 2, 2)  # one host: one replica
