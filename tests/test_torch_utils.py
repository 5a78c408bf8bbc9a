r"""The port's support modules (`azula_tpu_torch.utils.profiling`,
`azula_tpu_torch.utils.data`, `azula_tpu_torch.debug`) beside
`tests/test_utils.py`'s, and against the JAX package's where both compute
the same thing: the unshuffled batches, the edge cases of the data pipeline,
`process_shard` and `RaiseMock`. A shuffled epoch is a permutation that
covers each example once; its draws (`torch.randperm`) cannot be JAX's.
"""

import datetime
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process
import torch.distributed as dist

from azula_tpu import debug as jdebug
from azula_tpu.utils import data as jdata
from azula_tpu_torch import debug, parallel
from azula_tpu_torch.ops import _build
from azula_tpu_torch.ops.attention import dot_product_attention
from azula_tpu_torch.parallel import mesh as tmesh
from azula_tpu_torch.utils import data, profiling


def _data() -> dict:
    return {"x": np.arange(20 * 3, dtype=np.float32).reshape(20, 3), "y": np.arange(20)}


@pytest.fixture
def nan_checks():
    yield profiling.enable_nan_checks
    profiling.enable_nan_checks(False)


def test_throughput_counter():
    meter = profiling.Throughput()
    assert meter.rate() == 0.0

    x = torch.randn(16, 4, generator=torch.Generator().manual_seed(0))
    for _ in range(3):
        meter.update({"out": x * 2}, items=16)

    assert meter.items == 48
    assert meter.rate() > 0


def test_annotate_is_a_profiler_region():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("test-region"):
            torch.ones(3).mul(2)

    assert "test-region" in {e.name for e in prof.events()}


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("size", [4, 8, 7])
def test_batches_unshuffled_equal_jax(drop_last, size):
    got = list(data.batches(_data(), size, drop_last=drop_last))
    want = list(jdata.batches(_data(), size, drop_last=drop_last))

    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))


def test_batches_of_tensors_and_tuples():
    x, y = torch.arange(12.0).reshape(6, 2), torch.arange(6)
    got = list(data.batches((x, y), 3))
    assert [tuple(b[1].tolist()) for b in got] == [(0, 1, 2), (3, 4, 5)]
    assert all(isinstance(b, tuple) and torch.equal(b[0], x[b[1]]) for b in got)


def test_shuffled_epoch_is_a_permutation():
    g = torch.Generator().manual_seed(0)
    seen = np.concatenate([b["y"] for b in data.batches(_data(), 4, generator=g)])

    assert sorted(seen.tolist()) == list(range(20))
    assert not np.array_equal(seen, np.arange(20))

    again = np.concatenate([b["y"] for b in data.batches(_data(), 4, generator=torch.Generator().manual_seed(0))])
    np.testing.assert_array_equal(seen, again)


def test_prefetch_to_device_keeps_order():
    staged = list(data.prefetch_to_device(data.batches(_data(), 4), size=2, device="cpu"))

    assert len(staged) == 5
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu" for b in staged)
    np.testing.assert_array_equal(torch.cat([b["x"] for b in staged]).numpy(), _data()["x"])


def test_epochs_are_shuffled_permutations():
    stream = list(data.epochs(_data(), 8, generator=torch.Generator().manual_seed(1), num_epochs=3, device="cpu"))
    assert len(stream) == 6

    # each epoch draws its own order from the generator folded with its index
    orders = [torch.cat([b["y"] for b in stream[2 * e : 2 * e + 2]]).tolist() for e in range(3)]
    assert all(len(set(o)) == 16 for o in orders)
    assert orders[0] != orders[1]

    again = list(data.epochs(_data(), 8, generator=torch.Generator().manual_seed(1), num_epochs=3, device="cpu"))
    assert all(torch.equal(a["x"], b["x"]) for a, b in zip(stream, again, strict=True))


def test_data_pipeline_edge_cases():
    r"""As `tests/test_utils.py::test_data_pipeline_edge_cases`, each
    against JAX's: oversized batches raise, prefetch=0 stages without
    queueing, None batches pass through."""

    x = np.arange(10.0)

    for module in (data, jdata):
        with pytest.raises(ValueError):
            next(module.batches(x, 16))

    staged = list(data.prefetch_to_device(data.batches(x, 5), size=0, device="cpu"))
    want = list(jdata.prefetch_to_device(jdata.batches(x, 5), size=0))
    assert len(staged) == len(want) == 2
    np.testing.assert_array_equal(torch.cat(staged).numpy(), np.concatenate([np.asarray(w) for w in want]))

    mixed = [np.ones(2), None, np.zeros(2)]
    out = list(data.prefetch_to_device(iter(mixed), size=2, device="cpu"))
    assert len(out) == 3 and out[1] is None
    assert torch.equal(out[0], torch.ones(2, dtype=torch.float64))


def test_prefetch_to_device_on_a_mesh(tmp_path):
    r"""With a mesh, each rank stages its rows of the batch (`shard_batch`);
    at world size 1 all of them."""

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=30),
    )
    try:
        mesh = parallel.make_mesh(device="cpu")
        staged = list(data.prefetch_to_device(data.batches(_data(), 4), mesh=mesh))
        assert len(staged) == 5 and staged[0]["x"].device.type == "cpu"
        np.testing.assert_array_equal(torch.cat([b["x"] for b in staged]).numpy(), _data()["x"])

        # the default process group's rank and size
        assert data.process_shard(np.arange(10)).shape == (10,)
    finally:
        dist.destroy_process_group()
        tmesh._MESH = None


@pytest.mark.parametrize("count", [1, 3, 4])
def test_process_shard_equal_jax(count):
    x = {"a": np.arange(10), "b": np.arange(20).reshape(10, 2)}
    for i in range(count):
        got = data.process_shard(x, index=i, count=count)
        want = jdata.process_shard(x, index=i, count=count)
        for k in x:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))

    shards = [data.process_shard(np.arange(10), index=i, count=4) for i in range(4)]
    assert np.concatenate(shards).tolist() == list(range(8))

    assert data.process_shard(np.arange(10)).shape == (10,)

    with pytest.raises(ValueError):
        data.process_shard(np.arange(3), index=0, count=4)


def test_raise_mock_as_jax():
    for module in (debug, jdebug):
        mock = module.RaiseMock("transformers", ImportError("no module named transformers"))
        assert repr(mock) == "RaiseMock(transformers)"
        with pytest.raises(RuntimeError, match="'transformers' is unavailable") as info:
            mock()
        assert isinstance(info.value.__cause__, ImportError)
        with pytest.raises(RuntimeError):
            mock.AutoModel  # noqa: B018


def test_nan_checks_forward_and_backward(nan_checks):
    x = torch.tensor([-1.0, 1.0])

    nan_checks(True)
    with pytest.raises(FloatingPointError, match="log"):
        torch.log(x)

    # the backward too, which anomaly detection alone sees: 0 * inf in sqrt's
    z = torch.zeros(1, requires_grad=True)
    y = (torch.sqrt(z) * 0).sum()
    with pytest.raises(FloatingPointError):
        y.backward()

    nan_checks(False)
    assert torch.isnan(torch.log(x)).any()


def test_nan_checks_on_the_plain_route(nan_checks):
    r"""A NaN planted into attention's query (before the checks are on) is
    caught at the first operation of the CPU route that gives it."""

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 16, 8, generator=g) for _ in range(3))
    q[0, 0, 3, 2] = float("nan")

    nan_checks(True)
    with pytest.raises(FloatingPointError):
        dot_product_attention(q, k, v)

    nan_checks(False)
    assert torch.isnan(dot_product_attention(q, k, v)).any()


def test_nan_checks_on_the_kernel_route(nan_checks, monkeypatch):
    r"""The kernels write their outputs out of the dispatcher's sight, so the
    wrappers check them where they count the launch."""

    monkeypatch.setattr(_build, "LAUNCHES", _build.LAUNCHES.copy())
    out = torch.ones(2, 4)
    out[1, 2] = float("nan")

    nan_checks(True)
    with pytest.raises(FloatingPointError, match="fused_msa"):
        _build.launched("fused_msa", torch.ones(3), out)
    _build.launched("group_stats", torch.ones(3))

    nan_checks(False)
    _build.launched("fused_msa", out)
    assert _build.LAUNCHES["fused_msa"] == 2 and _build.LAUNCHES["group_stats"] == 1


def test_nan_checks_ignore_uninitialized_memory(nan_checks):
    nan_checks(True)
    for _ in range(8):
        torch.empty(4096).fill_(1.0)
        torch.empty_like(torch.ones(64, 64)).zero_()
