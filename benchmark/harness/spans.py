r"""What the program under test records of itself in a traced window: its
spans, found among the trace's host operations by name, and the records
that its kernel spans keep (`azula_tpu_torch.utils.profiling.records`).

A program without records (before they existed) gives `None`, and so do
the readers built on it. The records of the window are the last ones the
program kept, one for each of the op's spans in the window: the harness
reads them after the window, and nothing records once it closes.
"""

from __future__ import annotations

import bisect

__all__ = ["STEP", "SYNCS", "program", "records", "spans", "step_syncs"]

# the span of one sampler step
STEP = "azula.sample.step"
# the host operations that wait for the card
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def program():
    r"""The program's span module, or None where it keeps no records."""

    try:
        from azula_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if callable(getattr(profiling, "records", None)) else None


def spans(trace, name: str) -> list[tuple[int, int]]:
    r"""The `(start, end)` of the host spans `name` that start in the
    window, in order."""

    return sorted((s, e) for n, s, e in trace.host if n == name and trace.start <= s < trace.end)


def records(trace, op: str) -> list | None:
    r"""The records of the op's spans in the window, or None where the
    program keeps none."""

    prof = program()
    if prof is None:
        return None
    n = len(spans(trace, op))
    kept = [r for r in prof.records() if r.op == op]
    if len(kept) < n:
        raise LookupError(f"{n} {op} spans in the window but {len(kept)} records")
    return kept[len(kept) - n:]


def step_syncs(trace) -> list[int] | None:
    r"""The count of synchronising calls (:data:`SYNCS`) in each step span
    of the window. None where the program keeps no records; a program that
    keeps them but opened no step span raises."""

    if program() is None:
        return None
    steps = spans(trace, STEP)
    if not steps:
        raise LookupError(f"no {STEP} span in the traced window")

    syncs = sorted(s for n, s, e in trace.host if n in SYNCS)
    return [bisect.bisect_left(syncs, e) - bisect.bisect_left(syncs, s) for s, e in steps]
