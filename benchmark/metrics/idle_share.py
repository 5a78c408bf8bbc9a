r"""The share of the traced window in which no operation ran on the
device: 1 - (union of the device's operations) / window."""

from __future__ import annotations


def read(trace, cell) -> float | None:
    if not trace.window_ns:
        return None
    return 100 * (1 - trace.busy_ns() / trace.window_ns)
