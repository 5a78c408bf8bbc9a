r"""One run of one cell: set-up, the timed window, the per-layer reading of
the traced run, and the check against the plain reference.

The window runs whole trajectories, `sampler(x, **cond)`, back to back,
each on inputs drawn from the seed by its index. Hooks on the denoiser
module record a CUDA event after each network call and, once the window's
time is up, stop the trajectory under way before its next call; a hook on
the network keeps its first output in each trajectory at the positions the
check samples, and the final samples are kept at those positions too. Work
is counted in completed network calls, so a trajectory cut off at the end
counts its share.

A traced run (`trace=True`) profiles the window's first trajectory whole
and then runs on untraced to the end of the window; its per-layer metrics
are read from that trajectory.
"""

from __future__ import annotations

import gc
import importlib
import math
import random
import sys
import time
import torch

from dataclasses import dataclass, field

from . import draw
from .manifest import Cell
from .trace import WINDOW_SPAN, Trace, quantile, reduce

GIB = 2**30
FORBIDDEN = ("jax", "jaxlib", "flax", "azula_tpu")


class WindowClosed(Exception):
    r"""Raised by the denoiser's pre-hook once the window's time is up."""


def forbidden_modules() -> list[str]:
    r"""The modules of this process whose top-level name (before the first
    dot) is one of :data:`FORBIDDEN`, compared whole: `azula_tpu_torch` is
    not `azula_tpu`."""

    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Marks:
    r"""Completion marks of the network calls: CUDA events recorded on the
    stream without a synchronise, or host times where the device is the
    host (the CPU runs of the tests)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.marks: list = []

    def mark(self):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def add(self) -> None:
        self.marks.append(self.mark())

    def gaps_ms(self, start) -> list[float]:
        r"""The time between consecutive marks, the first from `start`."""

        points = [start, *self.marks]
        if self.device.type == "cuda":
            return [a.elapsed_time(b) for a, b in zip(points, points[1:])]
        return [(b - a) * 1e3 for a, b in zip(points, points[1:])]


def check_positions(seed: int, batch: int, n: int) -> list[int]:
    r"""The batch positions that the check compares, drawn from the seed:
    one in each half of the batch first, so that work left out of either
    half shows."""

    rng = random.Random(draw.stream_seed(seed, "positions"))
    if n == 1 or batch == 1:
        return [rng.randrange(batch)]
    half = batch // 2
    chosen = {rng.randrange(half), half + rng.randrange(batch - half)}
    while len(chosen) < min(n, batch):
        chosen.add(rng.randrange(batch))
    return sorted(chosen)


def select(cond: dict, positions: list[int], batch: int) -> dict:
    r"""The conditioning of the rows at `positions`."""

    return {
        k: v[positions] if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == batch else v
        for k, v in cond.items()
    }


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    r"""The largest, over the rows, of :math:`\|g - w\|_2 / \|w\|_2`."""

    got = got.double().flatten(1)
    want = want.double().flatten(1)
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} against {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float(((got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-30)).max())


@dataclass
class Window:
    r"""What the timed window ran and kept."""

    seconds: float = 0.0
    calls: int = 0
    gaps_ms: list = field(default_factory=list)
    kept: dict = field(default_factory=dict)  # trajectory index -> (first output, final sample) at the positions
    trace: Trace | None = None
    memory_peak: int = 0


def sampler_class(name: str):
    return getattr(importlib.import_module("azula_tpu_torch.sample"), name)


def run_window(cell: Cell, denoiser, seed: int, seconds: float, trace: bool, device: torch.device, positions) -> Window:
    r"""Runs the window and returns what it measured and kept."""

    traffic, conf = cell.traffic, cell.configuration
    sampler = sampler_class(traffic["sampler"])(denoiser, steps=traffic["steps"], eta=traffic["eta"])
    network = conf.network(denoiser)
    marks, out = Marks(device), Window()
    state = {"deadline": math.inf, "first": None}

    def pre(module, args):
        if time.perf_counter() >= state["deadline"]:
            raise WindowClosed

    def post(module, args, output):
        marks.add()

    def keep_first(module, args, output):
        if state["first"] is None:
            state["first"] = output[positions].detach().clone()

    hooks = [
        denoiser.register_forward_pre_hook(pre),
        denoiser.register_forward_hook(post),
        network.register_forward_hook(keep_first),
    ]

    def trajectory(index: int) -> None:
        x, cond = conf.inputs(cell.config, traffic, seed, index, device)
        state["first"] = None
        final = sampler(x, **cond)
        out.kept[index] = (state["first"], final[positions].detach().clone())

    try:
        with torch.inference_mode():
            synchronize(device)
            t0 = time.perf_counter()
            start = marks.mark()
            if trace:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                with torch.profiler.profile(activities=activities) as prof:
                    with torch.profiler.record_function(WINDOW_SPAN):
                        trajectory(0)
                        synchronize(device)
                traced_calls = len(marks.marks)
            else:
                trajectory(0)
            # the window holds at least one whole trajectory
            state["deadline"] = t0 + seconds
            index = 1
            while time.perf_counter() < state["deadline"]:
                try:
                    trajectory(index)
                except WindowClosed:
                    break
                index += 1
            synchronize(device)
            out.seconds = time.perf_counter() - t0
    finally:
        for hook in hooks:
            hook.remove()

    out.calls = len(marks.marks)
    out.gaps_ms = marks.gaps_ms(start)
    if device.type == "cuda":
        out.memory_peak = torch.cuda.max_memory_allocated(device)
    if trace:
        out.trace = reduce(prof.profiler.kineto_results.events(), traced_calls)
        del prof
    return out


def end_to_end(cell: Cell, window: Window, setup_s: float) -> dict[str, float]:
    r"""The end-to-end readings of the window."""

    traffic = cell.traffic
    images = window.calls * traffic["batch"] / (traffic["steps"] * cell.calls_per_step)
    return {
        "setup_s": setup_s,
        "images_per_s": images / window.seconds,
        "step_ms_p95": quantile(window.gaps_ms, 0.95),
        "peak_mem_gib": window.memory_peak / GIB,
    }


def check(cell: Cell, seed: int, window: Window, positions, device) -> tuple[dict, int]:
    r"""The comparison that decides `correct`: one trajectory, drawn from
    the seed among those the window completed, at the sampled positions,
    against the plain reference run from the same inputs with weights drawn
    again from the seed. Returns the numbers compared, each with its limit,
    and the count of completed trajectories whose kept outputs are not
    finite."""

    done = sorted(window.kept)
    failed = sum(not all(bool(torch.isfinite(t).all()) for t in window.kept[i]) for i in done)
    index = random.Random(draw.stream_seed(seed, "trajectory")).choice(done)
    first, final = window.kept[index]

    ref_first, ref_final = reference(cell, seed, index, positions, device)
    limits = cell.traffic["limits"]
    readings = {"net_gap": gap(first, ref_first), "image_gap": gap(final, ref_final)}
    return {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}, failed


def reference(cell: Cell, seed: int, index: int, positions, device, precision: str = "float32"):
    r"""The reference's first network output and final sample for
    trajectory `index` at `positions`, in `precision` (the control's
    lower precision where it is not float32)."""

    from reference.common import no_tf32

    no_tf32()
    conf, traffic = cell.configuration, cell.traffic
    state = draw.weights(conf.parameters(cell.config), seed, device, getattr(torch, cell.config["dtype"]))
    x, cond = conf.inputs(cell.config, traffic, seed, index, device)
    with torch.no_grad():
        result = cell.reference.trajectory(
            cell.config, traffic, state, x[positions], select(cond, positions, traffic["batch"]), precision
        )
    del state
    return result


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, started: float) -> dict:
    r"""One run of `cell`: returns the result line's object. `started` is
    the host time at which the process began, from which set-up counts."""

    conf, traffic = cell.configuration, cell.traffic
    dtype = getattr(torch, cell.config["dtype"])
    positions = check_positions(seed, traffic["batch"], traffic["check"]["images"])

    parts = {"imports": time.perf_counter() - started}
    state = draw.weights(conf.parameters(cell.config), seed, device, dtype)
    synchronize(device)
    parts["weights"] = time.perf_counter() - started - sum(parts.values())
    denoiser = conf.build(cell.config, state, device)
    parts["build"] = time.perf_counter() - started - sum(parts.values())

    # warm-up: the cell's shapes through a two-step trajectory of its sampler
    warm = sampler_class(traffic["sampler"])(denoiser, steps=2, eta=traffic["eta"])
    with torch.inference_mode():
        x, cond = conf.inputs(cell.config, traffic, seed, -1, device)
        warm(x, **cond)[positions].clone()
    synchronize(device)
    del warm, x, cond
    setup_s = time.perf_counter() - started
    parts["warm_up"] = setup_s - sum(parts.values())

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = run_window(cell, denoiser, seed, seconds, trace, device, positions)

    # the program's state goes before the reference runs
    del denoiser, state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, failed = check(cell, seed, window, positions, device)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    result = {
        "correct": correct,
        "attempted": len(window.kept),
        "failed": failed,
        "metrics": {},
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
            "count": cell.chips,
            "memory_peak_bytes": window.memory_peak,
        },
    }
    if trace:
        t = window.trace
        result["device"]["busy_s"] = t.busy_ns() / 1e9
        result["device"]["window_s"] = t.window_ns / 1e9
        for name, reader in cell.per_layer.items():
            value = reader.read(t, cell)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": cell.units[name]}
        result["breakdown"] = t.breakdown()
        result["kinds"] = t.kinds()
    else:
        readings = end_to_end(cell, window, setup_s)
        result["metrics"] = {m["name"]: {"value": readings[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    result["setup_parts"] = parts
    result["checks"] = checks
    return result

