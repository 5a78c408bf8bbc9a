r"""The reduction of a trace and the per-layer readers, on traces written by
hand."""

from __future__ import annotations

import math

import pytest

from conftest import ROOT
from harness import manifest
from harness.peaks import FLOPS_PER_S, HBM_BYTES_PER_S
from harness.trace import Trace, kind, quantile

GN = "void azula::group_norm_kernel<__nv_bfloat16, 8, true>(...)"
ATTN = "void azula::tc::attention_fwd_tc_kernel<128, 2, true, false, false>(...)"
GEMM = "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT"


def trace(calls=2):
    ops = [(GEMM, 100, 400), (GN, 350, 500), (ATTN, 700, 900), ("Memset (Device)", 950, 960)]
    host = [("aten::linear", 0, 1000), ("cudaLaunchKernel", 550, 560), ("aten::item", 600, 990)]
    return Trace(start=0, end=1000, ops=ops, host=host, calls=calls)


def test_busy_time_and_gaps():
    t = trace()
    assert t.busy_intervals() == [(100, 500), (700, 900), (950, 960)]
    assert t.busy_ns() == 610
    assert t.gaps() == [(0, 100), (500, 700), (900, 950), (960, 1000)]
    assert [label for label, _ in t.label_gaps()] == ["aten::linear", "aten::item", "aten::item", "aten::item"]


def test_breakdown_is_by_kind_and_name():
    b = trace().breakdown()
    assert b["device_ops"][0][0] == f"matmul (cuBLAS): {GEMM}"
    assert math.isclose(b["device_ops"][0][1], 300e-9)
    assert b["idle_gaps"][0][0] == "aten::item"
    assert kind(GN) == "group_norm (ours)" and kind(ATTN) == "attention forward (ours)"


def test_quantile_is_linear():
    assert quantile([1, 2, 3, 4, 5], 0.95) == pytest.approx(4.8)
    assert quantile([7], 0.95) == 7


def _cell():
    return manifest.cell(ROOT, "adm256.ddim64_b16")


def test_readers_of_the_adm_cell():
    cell = _cell()
    t = trace(calls=2)
    counts = cell.counts
    gn = cell.per_layer["gn_roofline"].read(t, cell)
    assert gn == pytest.approx(100 * (2 * counts["gn_bytes"] / HBM_BYTES_PER_S) / 150e-9)
    attn = cell.per_layer["attn_roofline"].read(t, cell)
    bound = 0.0
    for B, H, Lq, Lk, D in counts["attention"]:
        bound += max(4 * B * H * Lq * Lk * D / FLOPS_PER_S["bfloat16"], 2 * B * H * D * (2 * Lq + 2 * Lk) / HBM_BYTES_PER_S)
    assert attn == pytest.approx(100 * 2 * bound / 200e-9)
    assert cell.per_layer["idle_share"].read(t, cell) == pytest.approx(39.0)
    assert cell.per_layer["launches_per_step"].read(t, cell) == pytest.approx(2.0)
    assert cell.per_layer["mfu"].read(t, cell) == pytest.approx(100 * 2 * counts["flops"] / (1e-6 * 989e12))


def test_a_pattern_that_matches_nothing_fails_loudly():
    cell = _cell()
    t = Trace(start=0, end=1000, ops=[(GEMM, 0, 10)], host=[], calls=1)
    with pytest.raises(LookupError):
        cell.per_layer["gn_roofline"].read(t, cell)
    with pytest.raises(LookupError):
        cell.per_layer["attn_roofline"].read(t, cell)


def test_a_reader_without_work_reads_nothing():
    cell = manifest.cell(ROOT, "flux1_dev.1024px_b1")
    from harness.manifest import load_module
    from conftest import BENCH

    gn = load_module(BENCH / "metrics" / "gn_roofline.py", "bench_metric_gn_roofline")
    assert "gn_roofline" not in cell.per_layer
    assert gn.read(trace(), cell) is None
