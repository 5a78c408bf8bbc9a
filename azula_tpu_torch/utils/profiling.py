r"""Tracing and profiling helpers.

Port of :mod:`azula_tpu.utils.profiling`:

- :func:`annotate` — the program's spans, named regions of a
  `torch.profiler` trace, opened only while a profiler records; a kernel
  call's span also keeps a :class:`Record` of its nominal work
  (:func:`records`, :func:`clear_records`);
- :class:`Throughput` — an items/s counter that marks each update on the
  card's stream and waits for the card once, when its rate is read;
- :func:`enable_nan_checks` — raises `FloatingPointError` where an operation
  gives a NaN, the counterpart of JAX's `jax_debug_nans`.
"""

from __future__ import annotations

__all__ = [
    "Record",
    "Throughput",
    "annotate",
    "clear_records",
    "enable_nan_checks",
    "records",
]

import collections
import contextlib
import time
import torch

from collections.abc import Callable
from torch.autograd import profiler as _profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from typing import NamedTuple

from ..ops import _build


class Record(NamedTuple):
    r"""One kernel call, kept while a profiler records.

    Attributes:
        op: The name of the call's span (`'azula.ops.attention'`, ...).
        route: The kernels it launched, by their `ops._build.LAUNCHES` names
            joined by `'+'`, or `'plain'` where it launched none.
        shape: The shape its work is counted from, in the op's own order.
        flops: Its nominal floating-point operations, from its arguments'
            shapes, whichever route computed them.
        bytes: Its nominal memory traffic: each input read once, each output
            written once.
    """

    op: str
    route: str
    shape: tuple[int, ...]
    flops: int
    bytes: int


# the newest records, so that a long or repeated profiler session keeps a
# bounded list (a traced sampling trajectory keeps a few thousand)
_KEEP = 1 << 16
_RECORDS: collections.deque[Record] = collections.deque(maxlen=_KEEP)

# a span while no profiler records: the flag check and this null context
_OFF = contextlib.nullcontext()


def records() -> list[Record]:
    r"""The records kept since the last :func:`clear_records`, oldest
    first: the newest 65,536 of them."""

    return list(_RECORDS)


def clear_records() -> None:
    r"""Drops the kept records."""

    _RECORDS.clear()


class _Span:
    r"""A `record_function` region; with `work`, a kernel call's span, which
    adds its :class:`Record` once it closes."""

    __slots__ = ("args", "before", "name", "region", "work")

    def __init__(self, name: str, work: Callable | None, args: tuple) -> None:
        self.name, self.work, self.args = name, work, args

    def __enter__(self) -> None:
        if self.work is not None:
            self.before = dict(_build.LAUNCHES)
        self.region = torch.profiler.record_function(self.name)
        self.region.__enter__()

    def __exit__(self, *exc) -> bool:
        self.region.__exit__(*exc)

        if self.work is not None and exc[0] is None:
            route = "+".join(k for k, n in _build.LAUNCHES.items() if n != self.before.get(k, 0))
            shape, flops, nbytes = self.work(*self.args)
            _RECORDS.append(Record(self.name, route or "plain", shape, flops, nbytes))

        return False


def annotate(name: str, work: Callable | None = None, *args):
    r"""The program's span: a named region of a `torch.profiler` trace, on
    the profiler's clock, inside the span open around it.

    While no profiler records in the process, it reads the profiler's own
    flag and opens nothing; there is no other switch. Code that
    `torch.compile` traces opens none either. While one records, the
    span is a `torch.profiler.record_function` region and, given `work`, a
    kernel call's span: once it closes, :func:`records` holds the call's
    :class:`Record`, with the route it took and its work `work(*args)`, a
    `(shape, flops, bytes)` triple.

    .. code-block:: python

        with annotate("azula.sample.step"):
            x = sampler.step(x, t, s)
    """

    if not _profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _OFF

    return _Span(name, work, args)


def _mark(tree):
    r"""A completion mark after the work queued for the first tensor of
    `tree`: a CUDA event on its device's current stream, or the host clock
    for a CPU tensor, which is ready already."""

    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                event = torch.cuda.Event(enable_timing=True)
                event.record(torch.cuda.current_stream(leaf.device))
                return event
            break

    return time.perf_counter()


def _ready(mark) -> bool:
    r"""Whether the work before a mark of :func:`_mark` is done, without a
    wait."""

    return not isinstance(mark, torch.cuda.Event) or mark.query()


def _seconds(first, last) -> float:
    r"""The seconds between two marks of :func:`_mark`, both done."""

    if isinstance(first, torch.cuda.Event):
        return first.elapsed_time(last) / 1e3

    return last - first


class Throughput:
    r"""Throughput counter on the card's clock.

    Each :meth:`update` marks the end of the work queued so far (a CUDA
    event; the host clock for CPU tensors) and never waits. :meth:`rate`
    waits once, for the last mark, and gives the items of the updates after
    the first over the time from the first mark to the last.

    .. code-block:: python

        meter = Throughput()
        for batch in batches:
            out = step(batch)
            meter.update(out, items=batch.shape[0])
        print(meter.rate(), "items/sec")
    """

    def __init__(self) -> None:
        self.items = 0
        self.first = self.last = None
        self.first_items = 0

    def update(self, result, items: int) -> None:
        self.last = _mark(result)
        self.items += items

        if self.first is None:
            self.first, self.first_items = self.last, items

    def rate(self) -> float:
        if self.first is None or self.last is self.first:
            return 0.0

        if isinstance(self.last, torch.cuda.Event):
            self.last.synchronize()
        elapsed = _seconds(self.first, self.last)

        return (self.items - self.first_items) / elapsed if elapsed > 0 else 0.0


# the operations that give uninitialized memory, which may hold any bits
_UNINITIALIZED = {"empty", "empty_like", "empty_strided", "empty_permuted", "new_empty", "new_empty_strided"}


class _NanChecks(TorchDispatchMode):
    r"""Raises `FloatingPointError` naming the operation when one of its
    floating outputs holds a NaN, in the forward and in the backward alike."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))

        if func.overloadpacket.__name__ not in _UNINITIALIZED:
            for leaf in tree_leaves(out):
                if (
                    isinstance(leaf, torch.Tensor)
                    and leaf.is_floating_point()
                    and leaf.device.type != "meta"
                    and bool(torch.isnan(leaf).any())
                ):
                    raise FloatingPointError(f"{func} gave a NaN")

        return out


_MODE: _NanChecks | None = None


def enable_nan_checks(enable: bool = True) -> None:
    r"""Toggles NaN checks: every PyTorch operation and every kernel of
    :mod:`azula_tpu_torch.ops` raises `FloatingPointError` when it gives a NaN.

    JAX's `jax_debug_nans` checks each primitive; here a dispatch mode checks
    each operation the dispatcher sees, and the kernel wrappers check their
    outputs themselves (the kernels write through `ctypes`, out of the
    dispatcher's sight). `torch.autograd.set_detect_anomaly` would see the
    backward only. The checks synchronize with the card at every operation.
    """

    global _MODE

    if enable and _MODE is None:
        _MODE = _NanChecks()
        _MODE.__enter__()
    elif not enable and _MODE is not None:
        _MODE.__exit__(None, None, None)
        _MODE = None

    _build.NAN_CHECKS = enable
