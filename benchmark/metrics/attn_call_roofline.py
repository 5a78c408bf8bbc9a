r"""The attention forward kernels' share of their roofline, from the
program's own records: each `azula.ops.attention` call routed to a kernel
of `csrc/attention_fwd.cu` (its `LAUNCHES` name starts `attention_fwd`)
counts its least time, the larger of its FLOPs at the card's peak and its
bytes at its memory bandwidth; their sum is over the device time of
`attn_roofline`'s patterns. The work is counted by the program from each
call's shapes, not by the configuration. Calls on other routes are left
out; a cell with attention work whose program keeps records but recorded
no such call is an error."""

from __future__ import annotations

from pathlib import Path

from harness import spans
from harness.manifest import load_module
from harness.peaks import FLOPS_PER_S, HBM_BYTES_PER_S

OP = "azula.ops.attention"
ROUTE = "attention_fwd"


def read(trace, cell) -> float | None:
    if not cell.counts["attention"]:
        return None
    kept = spans.records(trace, OP)
    if kept is None:
        return None
    peak = FLOPS_PER_S[cell.config["dtype"]]
    bound = sum(max(r.flops / peak, r.bytes / HBM_BYTES_PER_S) for r in kept if r.route.startswith(ROUTE))
    if not bound:
        raise LookupError(f"no {OP} record routed to {ROUTE}* in a cell with attention work")
    patterns = load_module(Path(__file__).with_name("attn_roofline.py"), "bench_metric_attn_roofline").PATTERNS
    ns, n = trace.time_of(patterns)
    if not n:
        raise LookupError(f"no device operation matches {patterns} in a cell with attention work")
    return 100 * bound / (ns / 1e9)
