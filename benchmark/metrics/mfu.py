r"""The traced trajectory's model FLOPs as a share of the card's bf16 peak
over the traced window: the network's convolutions, linear layers and
attention products counted from the configuration's shapes (the
configuration's `counts`), not from what the program launched."""

from __future__ import annotations

from harness.peaks import FLOPS_PER_S


def read(trace, cell) -> float | None:
    flops = cell.counts["flops"] * trace.calls
    if not flops or not trace.window_ns:
        return None
    return 100 * flops / (trace.window_ns / 1e9 * FLOPS_PER_S[cell.config["dtype"]])
