r"""Runs one cell of the benchmark once, on the card, and prints its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. With `--trace 0` the result line holds the
cell's end-to-end metrics; with `--trace 1` its per-layer metrics, read
from a profiler trace of the window's first trajectory. The last line of
standard output is one JSON object; the numbers that decide `correct` are
also the last lines of standard error, each beside its limit. A run exits
with another code than 0, and prints no result, without a card, with fewer
cards than the cell asks for, or when JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# every cache of the program at a fixed path inside the checkout (the
# port's kernel library is already built under `build/`)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path[:0] = [str(HERE), str(ROOT)]
    from harness import manifest, runner

    cell = manifest.cell(ROOT, args.workload, HERE)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), device, STARTED)

    loaded = runner.forbidden_modules()
    if loaded:
        print(f"the run imported {', '.join(loaded)}", file=sys.stderr)
        return 3

    print(f"card: {power_limit()}; set-up (s): {json.dumps(result.pop('setup_parts'))}", file=sys.stderr)
    if args.trace:
        print(f"device time by kind (s): {json.dumps(result.pop('kinds'))}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
