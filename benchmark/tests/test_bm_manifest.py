r"""`BENCHMARK.json` against the contract it is written to, and the files
it names; adding a configuration, a cell and a per-layer metric takes new
files only."""

from __future__ import annotations

import json
import math
import re

import pytest

from conftest import BENCH, ROOT
from harness import manifest
from harness.trace import Trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_sizes():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCHMARK["run_seconds"] <= 51 and isinstance(BENCHMARK["run_seconds"], int)
    assert 1 <= len(BENCHMARK["paths"]) <= 16
    for path in BENCHMARK["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and not path.startswith("/") and ".." not in path
        assert not path.endswith("_torch")
    command = BENCHMARK["command"]
    assert len(command) <= 32 and all(TEXT.match(word) for word in command)
    assert (ROOT / command[1]).is_file() and command[1].startswith(BENCHMARK["paths"][0] + "/")
    # a full check of 24 cells fits its time
    cells = 24
    assert (2 + 14 * cells) * (BENCHMARK["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCHMARK[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in BENCHMARK[key]}) == len(BENCHMARK[key])
    metrics = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for metric in metrics:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES
    for config in BENCHMARK["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(config["why"]) and TEXT.match(config["source"]) and len(config["reduced"]) <= 16
    for cell in BENCHMARK["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["traffic"]) and cell["chips"] in (1, 4) and TEXT.match(cell["why"])


def test_end_to_end_metrics():
    by_name = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in by_name and by_name["setup_s"]["bound"] <= 0.25
    for metric in BENCHMARK["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


def test_files_of_every_entry():
    for config in BENCHMARK["configs"]:
        assert config["file"].startswith("benchmark/") and (ROOT / config["file"]).is_file()
        assert (BENCH / "configs" / f"{config['name']}.py").is_file()
        assert (BENCH / "reference" / f"{config['name']}.py").is_file()
        assert any(cell["config"] == config["name"] for cell in BENCHMARK["workloads"])
    for cell in BENCHMARK["workloads"]:
        traffic = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
        assert traffic["config"] == cell["config"]
        assert set(traffic["limits"]) == {"net_gap", "image_gap"}
    for metric in BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()


def test_per_layer_metrics_move_what_their_cells_report():
    cells = {c["name"] for c in BENCHMARK["workloads"]}
    for metric in BENCHMARK["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert TEXT.match(metric["layer"])
        moved = next(m for m in BENCHMARK["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    for cell in cells:
        reported = [m for m in BENCHMARK["per_layer"] if manifest.reports(BENCHMARK, m, cell)]
        assert reported, f"{cell} reports no per-layer metric"


def test_every_cell_loads():
    for cell in BENCHMARK["workloads"]:
        loaded = manifest.cell(ROOT, cell["name"], BENCH)
        assert {m["name"] for m in loaded.end_to_end} >= {"setup_s", "images_per_s"}
        assert loaded.counts["flops"] > 0


def test_new_files_add_a_config_a_cell_and_a_metric(tiny_root):
    r"""A copy of the benchmark with a configuration, a cell and a per-layer
    metric added as new files and manifest entries: the harness, unedited,
    finds and reads them."""

    for name in ("benchmark/harness", "benchmark/run.py"):
        old, new = BENCH.parent / name, tiny_root / name
        files = sorted(old.rglob("*.py")) if old.is_dir() else [old]
        for path in files:
            assert (new / path.relative_to(old) if old.is_dir() else new).read_bytes() == path.read_bytes()

    cell = manifest.cell(tiny_root, "tiny_adm.ddim3_b4", tiny_root / "benchmark")
    assert cell.configuration.__file__.startswith(str(tiny_root))
    assert "busy_ms_per_step" in cell.per_layer and cell.units["busy_ms_per_step"] == "ms"
    trace = Trace(start=0, end=10_000_000, ops=[("k", 0, 2_000_000), ("k", 1_000_000, 3_000_000)], host=[], calls=3)
    assert math.isclose(cell.per_layer["busy_ms_per_step"].read(trace, cell), 1.0)


@pytest.mark.parametrize("config", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_reduced_names_no_width(config):
    widths = re.compile(r"(hidden|intermediate|latent|state|projection|head|_dim$|_rank$|expansion|experts_per)")
    assert not any(widths.search(key) for key in config["reduced"])
