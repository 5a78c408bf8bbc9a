r"""The GroupNorm kernels' share of their roofline: the least time of the
traced trajectory's GroupNorm work at the card's memory bandwidth (each
input byte read once, each output byte written once, the affine
parameters; the configuration's `counts`), over the device time of the
kernels whose names hold these patterns. The work does not depend on which
kernel runs; a pattern that matches nothing where there is GroupNorm work
is an error, never a 0."""

from __future__ import annotations

from harness.peaks import HBM_BYTES_PER_S

# the port's csrc/group_norm.cu
PATTERNS = ("::group_norm_kernel<",)


def read(trace, cell) -> float | None:
    nbytes = cell.counts["gn_bytes"] * trace.calls
    if not nbytes:
        return None
    ns, n = trace.time_of(PATTERNS)
    if not n:
        raise LookupError(f"no device operation matches {PATTERNS} in a cell with GroupNorm work")
    return 100 * (nbytes / HBM_BYTES_PER_S) / (ns / 1e9)
