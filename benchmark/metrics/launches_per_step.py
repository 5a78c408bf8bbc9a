r"""Device operations (kernels, copies, fills) launched per sampler step in
the traced trajectory: the host dispatch layer's count, from the profiler's
trace."""

from __future__ import annotations


def read(trace, cell) -> float | None:
    steps = trace.calls / cell.calls_per_step
    return len(trace.ops) / steps if steps else None
