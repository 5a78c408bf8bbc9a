r"""The reduction of a `torch.profiler` trace to what the per-layer metrics
read: the device's operations in the traced window, its busy time and idle
gaps, each gap labelled with the host operation running at its middle, and
the kernels by kind.

The raw events of the profiler (`kineto_results.events()`) are read, not
`key_averages()`, so that a trajectory's hundred thousand kernels reduce in
seconds.
"""

from __future__ import annotations

import collections
import heapq

from dataclasses import dataclass

__all__ = ["Trace", "WINDOW_SPAN", "kind", "quantile", "reduce"]

# the span that the harness opens around the traced trajectory
WINDOW_SPAN = "bench.window"


def kind(name: str) -> str:
    r"""The kind of a device operation by its name (the classifier of the
    port's own profiles)."""

    low = name.lower()
    if "::group_norm_kernel<" in name:
        return "group_norm (ours)"
    if "::group_stats_kernel<" in name:
        return "group_stats (ours)"
    if "attention_fwd_tc_kernel<" in name or "attention_fwd_kernel<" in name:
        return "attention forward (ours)"
    if "attention_bwd" in name or "flash_blhd" in name or "fused_msa" in name or "conv3x3" in name:
        return "other kernels (ours)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "pool" in low:
        return "other (norms, elementwise, reductions)"
    if "conv" in low or "fprop" in name or "implicit" in name or "nhwc" in low:
        return "convolution (cuDNN)"
    if any(word in low for word in ("gemm", "cutlass", "xmma", "nvjet")):
        return "matmul (cuBLAS)"
    if "copy" in low:
        return "copies (casts, layout)"
    return "other (norms, elementwise, reductions)"


@dataclass
class Trace:
    r"""The traced window: `ops` the device's operations `(name, start,
    end)` in it, `host` the host's operations, times in nanoseconds on the
    profiler's clock; `calls` the network calls that the window ran."""

    start: int
    end: int
    ops: list[tuple[str, int, int]]
    host: list[tuple[str, int, int]]
    calls: int

    @property
    def window_ns(self) -> int:
        return self.end - self.start

    def busy_intervals(self) -> list[tuple[int, int]]:
        r"""The union of the device's operations, clipped to the window."""

        merged: list[list[int]] = []
        for _, s, e in sorted(self.ops, key=lambda op: op[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy_intervals())

    def gaps(self) -> list[tuple[int, int]]:
        r"""The stretches of the window in which no device operation ran."""

        gaps, at = [], self.start
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.end > at:
            gaps.append((at, self.end))
        return gaps

    def time_of(self, patterns: tuple[str, ...]) -> tuple[int, int]:
        r"""The device time (ns) and the count of the operations whose name
        holds one of `patterns`."""

        matched = [e - s for name, s, e in self.ops if any(p in name for p in patterns)]
        return sum(matched), len(matched)

    def label_gaps(self) -> list[tuple[str, int]]:
        r"""Each gap with the innermost host operation running at its middle
        (`(no host operation)` where none ran)."""

        gaps = self.gaps()
        mids = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
        host = sorted(self.host, key=lambda op: op[1])
        labels = [""] * len(gaps)
        active: list[tuple[int, int, str]] = []  # (-start, end, name): the latest start on top
        j = 0
        for i in mids:
            mid = (gaps[i][0] + gaps[i][1]) // 2
            while j < len(host) and host[j][1] <= mid:
                heapq.heappush(active, (-host[j][1], host[j][2], host[j][0]))
                j += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            labels[i] = active[0][2] if active else "(no host operation)"
        return [(labels[i], e - s) for i, (s, e) in enumerate(gaps)]

    def breakdown(self, top: int = 10) -> dict:
        r"""The device operations that took most time, by kind and name, and
        the idle time by what the host was doing, in seconds."""

        ops, idle = collections.Counter(), collections.Counter()
        for name, s, e in self.ops:
            ops[f"{kind(name)}: {name[:160]}"] += (e - s) / 1e9
        for label, ns in self.label_gaps():
            idle[label[:160]] += ns / 1e9
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}

    def kinds(self) -> dict[str, float]:
        r"""Device seconds by kind."""

        out = collections.Counter()
        for name, s, e in self.ops:
            out[kind(name)] += (e - s) / 1e9
        return dict(out.most_common())


def _on_host(event) -> bool:
    return str(event.device_type()).endswith("CPU")


def reduce(events, calls: int) -> Trace:
    r"""A `Trace` of the raw profiler `events` (`kineto_results.events()`)
    inside the harness's window span."""

    window = [e for e in events if e.name() == WINDOW_SPAN and _on_host(e)]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans, not one")
    start = window[0].start_ns()
    end = start + window[0].duration_ns()

    ops, host = [], []
    for e in events:
        s = e.start_ns()
        span = (e.name(), s, s + e.duration_ns())
        if _on_host(e):
            if e is not window[0]:
                host.append(span)
        elif not e.is_user_annotation() and span[2] > start and s < end:
            ops.append(span)

    return Trace(start=start, end=end, ops=ops, host=host, calls=calls)


def quantile(values: list[float], q: float) -> float:
    r"""The `q` quantile of `values`, linear between the order statistics
    (numpy's default)."""

    ordered = sorted(values)
    at = q * (len(ordered) - 1)
    lo = int(at)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (at - lo)
