r"""`BENCHMARK.json` and the files it names.

Everything that belongs to one configuration, one cell or one per-layer
metric sits in files of its own, found by name under the benchmark's
directory:

- `configs/<config>.json`: the configuration's sizes (the manifest's `file`),
  and `configs/<config>.py`: how the program is built from them, the inputs
  a trajectory draws, and the work of one network call (`counts`);
- `reference/<config>.py`: the plain reference;
- `workloads/<cell>.json`: the cell's traffic: batch, sampler, steps, the
  size of what the check samples, and the limits of `correct`;
- `metrics/<metric>.py`: the reader of one per-layer metric, `read(trace,
  cell)`, which returns the metric's value or None where it finds nothing.

A new configuration, cell or metric is new files and new entries here; no
file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys

from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType


def load_module(path: Path, name: str) -> ModuleType:
    r"""Imports the file `path` as the module `name`."""

    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


@dataclass
class Cell:
    r"""One cell of the manifest, with everything a run of it reads."""

    name: str
    chips: int
    traffic: dict
    config: dict
    configuration: ModuleType
    reference: ModuleType
    end_to_end: list[dict]
    per_layer: dict[str, ModuleType] = field(default_factory=dict)
    units: dict[str, str] = field(default_factory=dict)

    @property
    def counts(self) -> dict:
        r"""The work of one network call, from the configuration's counts."""

        return self.configuration.counts(self.config, self.traffic)

    @property
    def calls_per_step(self) -> int:
        return self.reference.CALLS_PER_STEP[self.traffic["sampler"]]


def read(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(bench: dict, metric: dict, cell: str) -> bool:
    r"""Whether `cell` reports `metric`: the cells it lists, or else every
    cell that reports the end-to-end metric it moves (every cell, for one
    listed nowhere)."""

    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = next((m for m in bench["end_to_end"] if m["name"] == metric.get("moves")), None)
    return moved is None or "workloads" not in moved or cell in moved["workloads"]


def cell(root: Path, name: str, bench_dir: Path | None = None) -> Cell:
    r"""The cell `name` of the manifest at `root` (a checkout), its files
    under `bench_dir` (the benchmark's directory, `root/benchmark` by
    default)."""

    bench = read(root)
    bench_dir = bench_dir or root / "benchmark"
    for path in (str(bench_dir), str(root)):
        if path not in sys.path:
            sys.path.insert(0, path)

    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])

    traffic = json.loads((bench_dir / "workloads" / f"{name}.json").read_text())
    if traffic["config"] != entry["name"]:
        raise ValueError(f"{name}: its traffic names the configuration {traffic['config']!r}")
    config = json.loads((root / entry["file"]).read_text())
    tag = _ident(entry["name"])
    reference = load_module(bench_dir / "reference" / f"{entry['name']}.py", f"reference.{tag}")
    configuration = load_module(bench_dir / "configs" / f"{entry['name']}.py", f"bench_config_{tag}")

    per_layer = [m for m in bench["per_layer"] if reports(bench, m, name)]
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return Cell(
        name=name,
        chips=workload["chips"],
        traffic=traffic,
        config=config,
        configuration=configuration,
        reference=reference,
        end_to_end=end_to_end,
        per_layer={
            m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py", f"bench_metric_{_ident(m['name'])}")
            for m in per_layer
        },
        units={m["name"]: m["unit"] for m in end_to_end + per_layer},
    )
