r"""A run of the harness on the CPU at tiny sizes: the whole run but for the
look for a card, sound and with the timed path broken underneath."""

from __future__ import annotations

import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, ROOT, TINY_CELLS
from harness import manifest, runner

CPU = torch.device("cpu")


def run(root, name, seed=2**31 + 11, trace=False):
    cell = manifest.cell(root, name, root / "benchmark")
    return runner.run(cell, seed, 0.05, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("name", sorted(TINY_CELLS))
def test_sound_run_is_correct(tiny_root, name):
    result = run(tiny_root, name)

    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "images_per_s", "step_ms_p95", "peak_mem_gib"}
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def test_traced_run_reports_per_layer_metrics(tiny_root):
    result = run(tiny_root, "tiny_adm.ddim3_b4", trace=True)

    assert result["correct"]
    # the CPU runs no device operation: the readers of device time find nothing or fail loudly
    assert "busy_s" in result["device"] and "window_s" in result["device"]
    assert "breakdown" in result


def _stuck_step(self, x_t, t, s, generator=None, **kwargs):
    self.denoiser(x_t, t, **kwargs)
    return x_t


def _half_batch(module, args, output):
    half = output.shape[0] // 2
    return torch.cat([output[:half], output[:half].mean(0, keepdim=True).expand_as(output[half:])])


def _altered_answer(module, args, output):
    return output.roll(1, dims=0) if output.shape[0] > 1 else -output


@pytest.mark.parametrize("name", sorted(TINY_CELLS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_answer"])
def test_broken_path_is_not_correct(tiny_root, monkeypatch, name, fault):
    from azula_tpu_torch import sample

    cell = manifest.cell(tiny_root, name, tiny_root / "benchmark")
    if fault == "state_unchanged":
        monkeypatch.setattr(sample.DDIMSampler, "step", _stuck_step)
    else:
        build = cell.configuration.build
        hook = _half_batch if fault == "half_batch" else _altered_answer

        def broken(config, state, device):
            denoiser = build(config, state, device)
            cell.configuration.network(denoiser).register_forward_hook(hook)
            return denoiser

        monkeypatch.setattr(cell.configuration, "build", broken)

    result = runner.run(cell, 5, 0.05, False, CPU, time.perf_counter())

    assert not result["correct"], result["checks"]


def test_run_needs_a_card():
    r"""Without a card the command prints no result and exits with another
    code than 0."""

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "adm256.ddim64_b16", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_needs_the_program(tmp_path):
    r"""In a directory that holds only the manifest and the benchmark's
    files, the command exits with another code than 0 and prints nothing."""

    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "adm256.ddim64_b16", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_positions_cover_both_halves():
    for seed in range(50):
        positions = runner.check_positions(seed, 16, 2)
        assert len(positions) == 2 and positions[0] < 8 <= positions[1]
    assert runner.check_positions(3, 1, 1) == [0]
