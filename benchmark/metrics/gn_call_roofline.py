r"""The GroupNorm kernel's share of its roofline, from the program's own
records: the bytes of each `azula.ops.group_norm` call routed to
`csrc/group_norm.cu` (its `LAUNCHES` name `group_norm` or
`group_norm_silu`) at the card's memory bandwidth, over the device time of
`gn_roofline`'s patterns. The work is counted by the program from each
call's shapes, not by the configuration. A cell with GroupNorm work whose
program keeps records but recorded no such call is an error."""

from __future__ import annotations

from pathlib import Path

from harness import spans
from harness.manifest import load_module
from harness.peaks import HBM_BYTES_PER_S

OP = "azula.ops.group_norm"
ROUTES = ("group_norm", "group_norm_silu")


def read(trace, cell) -> float | None:
    if not cell.counts["gn_bytes"]:
        return None
    kept = spans.records(trace, OP)
    if kept is None:
        return None
    nbytes = sum(r.bytes for r in kept if r.route in ROUTES)
    if not nbytes:
        raise LookupError(f"no {OP} record routed to {ROUTES} in a cell with GroupNorm work")
    patterns = load_module(Path(__file__).with_name("gn_roofline.py"), "bench_metric_gn_roofline").PATTERNS
    ns, n = trace.time_of(patterns)
    if not n:
        raise LookupError(f"no device operation matches {patterns} in a cell with GroupNorm work")
    return 100 * (nbytes / HBM_BYTES_PER_S) / (ns / 1e9)
