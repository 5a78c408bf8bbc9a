r"""Tests that need the card, run on it by

    python3 -m pytest benchmark/tests -q -m card

The control of `correct` at each cell's own size: the plain reference in
fp8 (the precision below the configurations' bf16) fails at least one of
the cell's limits on every seed. And a short run of each cell through the
command is correct."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from harness import manifest

CELLS = [w["name"] for w in manifest.read(ROOT)["workloads"]]
SEEDS = (3_000_000_001, 3_000_000_002, 3_000_000_003)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_its_limits(card, name):
    import torch

    sys.path.insert(0, str(BENCH))
    from control import readings

    cell = manifest.cell(ROOT, name, BENCH)
    limits = cell.traffic["limits"]
    for seed in SEEDS:
        read = readings(cell, seed, torch.device("cuda", 0))
        assert any(read[k] > limits[k] for k in limits), (seed, read, limits)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(card, name):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed", "3000000004", "--seconds", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
