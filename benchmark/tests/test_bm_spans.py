r"""The readers of the program's own spans and records: the records of one
network call of the tiny cells against the configuration's `counts`, the
three readers on a CPU-traced run and on traces written by hand, and their
`None` where the program keeps no records."""

from __future__ import annotations

import math
import time

import pytest
import torch

from conftest import BENCH, TINY_ADM, TINY_CELLS, TINY_FLUX
from harness import draw, manifest, runner, spans
from harness.manifest import load_module
from harness.peaks import FLOPS_PER_S, HBM_BYTES_PER_S
from harness.trace import Trace

import configs_under_test as cut

CPU = torch.device("cpu")
METRICS = ("host_syncs_per_step", "attn_call_roofline", "gn_call_roofline")
GN = "void azula::group_norm_kernel<__nv_bfloat16, 8, true>(...)"
ATTN = "void azula::tc::attention_fwd_tc_kernel<128, 2, true, false, false>(...)"
CASES = [("adm256", TINY_ADM, "tiny_adm.ddim3_b4"), ("flux1_dev", TINY_FLUX, "tiny_flux.ddim3_b2")]


def reader(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}")


@pytest.fixture
def profiling():
    from azula_tpu_torch.utils import profiling

    profiling.clear_records()
    yield profiling
    profiling.clear_records()


def _one_call(name, config, traffic):
    r"""The records of one network call of the program built as the harness
    builds it, on the CPU."""

    from azula_tpu_torch.utils import profiling

    conf = cut.configuration(name)
    state = draw.weights(conf.parameters(config), 7, CPU, torch.bfloat16)
    denoiser = conf.build(config, state, CPU)
    x, cond = conf.inputs(config, traffic, 7, 0, CPU)
    with torch.inference_mode(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        denoiser(x, torch.tensor(0.5), **cond)
    return profiling.records()


@pytest.mark.parametrize("name,config,cell", CASES)
def test_one_calls_records_agree_with_the_counts(profiling, name, config, cell):
    traffic = TINY_CELLS[cell]
    counts = cut.configuration(name).counts(config, traffic)
    records = _one_call(name, config, traffic)

    attention = [r for r in records if r.op == "azula.ops.attention"]
    norms = [r for r in records if r.op == "azula.ops.group_norm"]
    assert sorted(r.shape for r in attention) == sorted(counts["attention"])
    for r in attention:
        B, H, Lq, Lk, D = r.shape
        assert r.flops == 4 * B * H * Lq * Lk * D
        assert r.bytes == counts["itemsize"] * B * H * D * (2 * Lq + 2 * Lk)
    assert sum(r.bytes for r in norms) == counts["gn_bytes"]
    assert {r.op for r in records} <= {"azula.ops.attention", "azula.ops.group_norm"}


def _traced_window(tiny_root, name):
    cell = manifest.cell(tiny_root, name, tiny_root / "benchmark")
    conf = cell.configuration
    state = draw.weights(conf.parameters(cell.config), 11, CPU, torch.bfloat16)
    denoiser = conf.build(cell.config, state, CPU)
    positions = runner.check_positions(11, cell.traffic["batch"], 1)
    window = runner.run_window(cell, denoiser, 11, 0.01, True, CPU, positions)
    return cell, window.trace


def _as_on_the_card(trace, profiling, monkeypatch):
    r"""The CPU trace with the card's kernels and routes stood in: one
    device operation of each kernel per record, and the records routed to
    the kernels, as a run on the card records them."""

    kept = profiling.records()
    routes = {"azula.ops.attention": "attention_fwd", "azula.ops.group_norm": "group_norm_silu"}
    monkeypatch.setattr(profiling, "records", lambda: [r._replace(route=routes.get(r.op, r.route)) for r in kept])
    ops = list(trace.ops)
    for r in kept:
        kernel = ATTN if r.op == "azula.ops.attention" else GN
        ops.append((kernel, trace.start, trace.start + 1000))
    return Trace(start=trace.start, end=trace.end, ops=ops, host=trace.host, calls=trace.calls)


@pytest.mark.parametrize("name", sorted(TINY_CELLS))
def test_readers_read_a_cpu_traced_run(tiny_root, profiling, monkeypatch, name):
    cell, trace = _traced_window(tiny_root, name)
    steps = cell.traffic["steps"]

    assert len(spans.spans(trace, spans.STEP)) == steps
    assert reader("host_syncs_per_step").read(trace, cell) == 0

    card = _as_on_the_card(trace, profiling, monkeypatch)
    attn = reader("attn_call_roofline").read(card, cell)
    assert math.isfinite(attn) and attn > 0
    gn = reader("gn_call_roofline").read(card, cell)
    if cell.counts["gn_bytes"]:
        assert math.isfinite(gn) and gn > 0
        bound = steps * cell.counts["gn_bytes"] / HBM_BYTES_PER_S
        n = sum(1 for op in card.ops if op[0] == GN)
        assert gn == pytest.approx(100 * bound / (n * 1e-6))
    else:
        assert gn is None


@pytest.mark.parametrize("metric", METRICS)
def test_readers_give_none_without_records(tiny_root, profiling, monkeypatch, metric):
    cell, trace = _traced_window(tiny_root, "tiny_adm.ddim3_b4")
    monkeypatch.delattr(profiling, "records")

    assert reader(metric).read(trace, cell) is None


def _hand_trace(records_ops=()):
    host = [
        ("azula.sample.step", 100, 1100),
        ("cudaLaunchKernel", 150, 160),
        ("cudaStreamSynchronize", 200, 500),
        ("cudaMemcpy", 450, 600),
        ("azula.sample.step", 1200, 1500),
        ("cudaLaunchKernel", 1250, 1450),
        ("Command Buffer Full", 1300, 1400),
        ("azula.sample.step", 1600, 1700),
        ("cudaStreamSynchronize", 1800, 1900),
        *records_ops,
    ]
    return Trace(start=0, end=2000, ops=[(ATTN, 0, 500)], host=host, calls=3)


def test_host_readers_on_a_hand_trace(profiling):
    cell = manifest.cell(BENCH.parent, "flux1_dev.1024px_b1")
    trace = _hand_trace()

    # two synchronising calls in the first step, none in the others: the
    # queue-full stall is no call, and the last sync lies outside any step
    assert spans.step_syncs(trace) == [2, 0, 0]
    assert reader("host_syncs_per_step").read(trace, cell) == pytest.approx(2 / 3)


@pytest.mark.parametrize("name", spans.SYNCS)
def test_each_synchronising_call_counts_in_its_step(profiling, name):
    cell = manifest.cell(BENCH.parent, "adm256.ddim64_b16")
    host = [("azula.sample.step", 0, 100), (name, 10, 20), ("azula.sample.step", 100, 200), (name, 200, 210)]
    trace = Trace(start=0, end=300, ops=[(GN, 0, 10)], host=host, calls=2)

    assert spans.step_syncs(trace) == [1, 0]
    assert reader("host_syncs_per_step").read(trace, cell) == 0.5


def test_call_roofline_takes_the_last_records_of_the_window(profiling, monkeypatch):
    cell = manifest.cell(BENCH.parent, "flux1_dev.1024px_b1")
    old = profiling.Record("azula.ops.attention", "attention_fwd_max_free", (9,), 10**18, 0)
    new = profiling.Record("azula.ops.attention", "attention_fwd_max_free", (1, 24, 4608, 4608, 128), 4 * 24 * 4608**2 * 128, 2 * 24 * 128 * 4 * 4608)
    plain = profiling.Record("azula.ops.attention", "plain", (1,), 10**18, 10**18)
    monkeypatch.setattr(profiling, "records", lambda: [old, new, plain])
    trace = _hand_trace([("azula.ops.attention", 120, 130), ("azula.ops.attention", 140, 145)])

    got = reader("attn_call_roofline").read(trace, cell)
    assert got == pytest.approx(100 * (new.flops / FLOPS_PER_S["bfloat16"]) / 500e-9)

    monkeypatch.setattr(profiling, "records", lambda: [new])
    with pytest.raises(LookupError):
        reader("attn_call_roofline").read(trace, cell)


def test_a_program_with_records_but_no_step_span_fails_loudly(profiling):
    cell = manifest.cell(BENCH.parent, "adm256.ddim64_b16")
    trace = Trace(start=0, end=1000, ops=[(GN, 0, 10)], host=[("aten::add", 0, 10)], calls=1)

    for metric in METRICS:
        with pytest.raises(LookupError):
            reader(metric).read(trace, cell)


def test_a_traced_run_reports_the_new_metrics_or_none(tiny_root):
    r"""A whole traced run of a tiny cell on the CPU, with the new metrics
    listed for it: the sync reader reads, and the call rooflines, which
    find no kernel on the CPU, fail loudly as `attn_roofline` does."""

    cell = manifest.cell(tiny_root, "tiny_flux.ddim3_b2", tiny_root / "benchmark")
    cell.per_layer = {"host_syncs_per_step": reader("host_syncs_per_step")}
    cell.units.update(host_syncs_per_step="syncs/step")
    result = runner.run(cell, 2**31 + 5, 0.05, True, CPU, time.perf_counter())

    assert result["correct"]
    assert result["metrics"]["host_syncs_per_step"]["value"] == 0
