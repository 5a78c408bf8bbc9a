r"""Fixtures of the benchmark's tests: a copy of the benchmark with tiny
cells added by new files only, and the `card` marker."""

from __future__ import annotations

import copy
import json
import shutil
import sys

from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

for path in (str(BENCH), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_ADM = {
    "dtype": "bfloat16",
    "model": {
        "image_size": 32, "num_channels": 64, "num_res_blocks": 1, "channel_mult": [1, 2],
        "attention_resolutions": [16], "num_head_channels": 32, "num_classes": None, "learn_var": True,
        "clip_mean": True, "discrete_schedule": "linear", "discrete_steps": 1000, "resblock_updown": True,
        "use_scale_shift_norm": True, "use_new_attention_order": False,
    },
    "schedule": {"alpha_min": 0.01, "sigma_min": 0.01},
}
TINY_FLUX = {
    "dtype": "bfloat16",
    "model": {
        "attention_head_dim": 32, "axes_dims_rope": [8, 12, 12], "guidance_embeds": True, "in_channels": 16,
        "joint_attention_dim": 32, "num_attention_heads": 2, "num_layers": 1, "num_single_layers": 1,
        "patch_size": 1, "pooled_projection_dim": 16,
    },
    "schedule": {"alpha_min": 0.001, "sigma_min": 0.001, "gamma": 0.1},
}
# the limits of the tiny cells, which run bf16 on the CPU
TINY_LIMITS = {"net_gap": 0.05, "image_gap": 0.2}
TINY_CELLS = {
    "tiny_adm.ddim3_b4": {
        "config": "tiny_adm", "batch": 4, "sampler": "DDIMSampler", "steps": 3, "eta": 0.0,
        "check": {"images": 2}, "limits": TINY_LIMITS,
    },
    "tiny_flux.ddim3_b2": {
        "config": "tiny_flux", "batch": 2, "latent_side": 4, "text_tokens": 8, "guidance": 3.5,
        "sampler": "DDIMSampler", "steps": 3, "eta": 0.0, "check": {"images": 2}, "limits": TINY_LIMITS,
    },
}
# a per-layer metric that the benchmark does not have: device busy time per step
NEW_METRIC = '''
def read(trace, cell):
    steps = trace.calls / cell.calls_per_step
    return trace.busy_ns() / 1e6 / steps if steps else None
'''


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skipped, with its reason, where there is none")


@pytest.fixture
def card():
    r"""Skips the test where no CUDA card is present (decided when the test
    runs, never at import)."""

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    r"""A checkout whose benchmark is a copy of this one with two tiny
    configurations, two cells and one per-layer metric added as new files
    and new manifest entries: nothing of the copy is edited."""

    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    manifest = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))

    for name, config, base in (("tiny_adm", TINY_ADM, "adm256"), ("tiny_flux", TINY_FLUX, "flux1_dev")):
        (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
        shutil.copy(bench / "configs" / f"{base}.py", bench / "configs" / f"{name}.py")
        shutil.copy(bench / "reference" / f"{base}.py", bench / "reference" / f"{name}.py")
        manifest["configs"].append({
            "name": name, "source": "https://example.org/tiny", "file": f"benchmark/configs/{name}.json",
            "reduced": [], "why": "a tiny test configuration",
        })
    for name, traffic in TINY_CELLS.items():
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(traffic))
        manifest["workloads"].append({
            "name": name, "config": traffic["config"], "traffic": name.split(".", 1)[1], "chips": 1,
            "why": "a tiny test cell",
        })
    (bench / "metrics" / "busy_ms_per_step.py").write_text(NEW_METRIC)
    manifest["per_layer"].append({
        "name": "busy_ms_per_step", "unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "device: H100", "moves": "images_per_s", "workloads": list(TINY_CELLS),
    })
    for metric in manifest["per_layer"]:
        if metric["name"] in ("launches_per_step", "mfu", "idle_share"):
            metric["workloads"] = metric["workloads"] + list(TINY_CELLS)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path
