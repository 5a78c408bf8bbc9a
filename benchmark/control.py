r"""The control of `correct`: the plain reference put in the program's place
and computed in the precision below the configuration's (fp8 for bf16), on
the inputs that a run with each seed checks. Prints, for each seed, the
numbers that a run compares, read from the control.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

A run's limits must lie below what the control reads on every seed. The
benchmark's runs do not run this; `tests/test_bm_card.py` holds it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(cell, seed: int, device) -> dict[str, float]:
    r"""The numbers compared, read from the reference in fp8 against the
    float32 reference, for the trajectory and positions that a run with
    `seed` would check if the window ran one trajectory."""

    from harness import runner

    positions = runner.check_positions(seed, cell.traffic["batch"], cell.traffic["check"]["images"])
    want_first, want_final = runner.reference(cell, seed, 0, positions, device)
    got_first, got_final = runner.reference(cell, seed, 0, positions, device, "float8")
    return {"net_gap": runner.gap(got_first, want_first), "image_gap": runner.gap(got_final, want_final)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()

    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    from harness import manifest

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(ROOT, args.workload, HERE)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
