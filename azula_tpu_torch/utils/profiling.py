r"""Tracing and profiling helpers.

Port of :mod:`azula_tpu.utils.profiling`:

- :func:`annotate` — named regions in `torch.profiler` traces;
- :class:`Throughput` — an items/s counter that waits for the card at each
  update;
- :func:`enable_nan_checks` — raises `FloatingPointError` where an operation
  gives a NaN, the counterpart of JAX's `jax_debug_nans`.
"""

from __future__ import annotations

__all__ = [
    "annotate",
    "Throughput",
    "enable_nan_checks",
]

import contextlib
import time
import torch

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..ops import _build


@contextlib.contextmanager
def annotate(name: str):
    r"""Named trace region visible in `torch.profiler` traces."""

    with torch.profiler.record_function(name):
        yield


def _sync(tree) -> None:
    r"""Waits until the card has computed the first tensor of `tree`; a CPU
    tensor is ready already."""

    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
            return


class Throughput:
    r"""Synchronized throughput counter.

    .. code-block:: python

        meter = Throughput()
        for batch in batches:
            out = step(batch)
            meter.update(out, items=batch.shape[0])
        print(meter.rate(), "items/sec")
    """

    def __init__(self) -> None:
        self.items = 0
        self.start = None
        self.elapsed = 0.0

    def update(self, result, items: int) -> None:
        if self.start is None:
            self.start = time.perf_counter()

        _sync(result)

        self.items += items
        self.elapsed = time.perf_counter() - self.start

    def rate(self) -> float:
        if not self.elapsed:
            return 0.0
        return self.items / self.elapsed


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
