r"""Module and dtype utilities."""

from __future__ import annotations

__all__ = [
    "checkpoint",
    "default_device",
    "get_module_device",
    "get_module_dtype",
    "promote_dtype",
    "skip_init",
    "table_device",
]

import functools
import itertools
import torch
import torch.utils.checkpoint

from collections.abc import Callable
from torch import Tensor, nn


def default_device(device=None) -> torch.device:
    r"""The device of a model's parameters: the card (`'cuda'`) unless the
    caller names another."""

    return torch.device("cuda") if device is None else torch.device(device)


def table_device(device):
    r"""The device of a table that a module computes from its configuration
    and that no checkpoint holds (a non-persistent buffer): `device`, or the
    CPU when the module is built on the meta device (:func:`skip_init`),
    where the loader moves it with the loaded parameters."""

    if device is not None and torch.device(device).type == "meta":
        return torch.device("cpu")

    return device


def skip_init(ctor: Callable, *args, **kwargs) -> nn.Module:
    r"""Builds a module without parameter storage and without drawing its
    initial values: `ctor(*args, device="meta", **kwargs)`.

    Port of :func:`azula_tpu.nn.utils.skip_init`. The module's parameters
    and persistent buffers are shapes only; fill them with
    `module.load_state_dict(sd, strict=True, assign=True)`
    (:func:`azula_tpu_torch.models.utils.load_weights` does, on the target
    device and dtype). The tables a module computes from its configuration
    are built on the CPU (:func:`table_device`). `ctor` takes the `device`
    keyword, as the port's modules and `make_model`s do.

    Example:
        >>> layer = skip_init(Linear, 3, 5)
    """

    if "device" in kwargs:
        raise TypeError("skip_init builds on the meta device; it takes no `device`")

    return ctor(*args, device=torch.device("meta"), **kwargs)


def get_module_device(module: nn.Module) -> torch.device | None:
    r"""Returns the device of a module's first parameter or buffer, or
    :py:`None` for a module without tensors."""

    for tensor in itertools.chain(module.parameters(), module.buffers()):
        return tensor.device

    return None


def _linspace(start: float, stop: float, num: int, dtype: torch.dtype, device=None) -> Tensor:
    r"""`jnp.linspace(start, stop, num)` as XLA computes it under `jit`, in
    `dtype`: `start * (1 - f) + stop * f` with `f = i * (1 / (num - 1))` (XLA
    turns the division by a constant into a product with its reciprocal), and
    the last point exactly `stop`."""

    if num < 2:
        return torch.full((num,), start, dtype=dtype, device=device)

    recip = 1 / torch.tensor(num - 1, dtype=dtype, device=device)
    f = torch.arange(num - 1, dtype=dtype, device=device) * recip
    start_t = torch.tensor(start, dtype=dtype, device=device)
    stop_t = torch.tensor(stop, dtype=dtype, device=device)
    out = start_t * (1 - f) + stop_t * f

    return torch.cat([out, stop_t[None]])


def get_module_dtype(module: nn.Module) -> torch.dtype:
    r"""Returns the data type of a module's first floating-point parameter
    (float32 when it has none), used to run low-precision backbones inside
    full-precision sampling math."""

    for p in module.parameters():
        if p.is_floating_point():
            return p.dtype

    return torch.float32


def _map(fn: Callable, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, a) for a in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, a) for k, a in tree.items()}
    return fn(tree)


def _floating(a) -> bool:
    return isinstance(a, torch.Tensor) and a.is_floating_point()


def promote_dtype(fn: Callable | None = None, min_dtype: torch.dtype = torch.float32) -> Callable:
    r"""Decorator promoting floating-point tensor arguments to at least
    `min_dtype`; the outputs are cast back to the highest input precision.

    Port of :func:`azula_tpu.nn.utils.promote_dtype`: normalizations and
    positional encodings compute in float32 even when activations are
    bfloat16. Tensors nested in tuples, lists and dicts count too.
    """

    if fn is None:
        return functools.partial(promote_dtype, min_dtype=min_dtype)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        dtypes = []
        _map(lambda a: dtypes.append(a.dtype) if _floating(a) else None, (args, kwargs))

        if not dtypes:
            return fn(*args, **kwargs)

        in_dtype = functools.reduce(torch.promote_types, dtypes)
        up_dtype = torch.promote_types(in_dtype, min_dtype)

        args, kwargs = _map(lambda a: a.to(up_dtype) if _floating(a) else a, (args, kwargs))
        out = fn(*args, **kwargs)

        return _map(lambda a: a.to(in_dtype) if _floating(a) else a, out)

    return wrapper


def checkpoint(f: Callable, reentrant: bool = False) -> Callable:
    r"""Applies activation rematerialization to a function: the backward
    recomputes `f`'s activations instead of keeping them.

    Port of :func:`azula_tpu.nn.utils.checkpoint`, through
    `torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`: gradients
    flow to every input, explicit or captured. `reentrant` is accepted for
    the JAX package's signature and ignored, as there.

    `torch.utils.checkpoint` restores the global RNG states only. A
    generator that `f` takes as its `generator` keyword is replayed instead:
    the forward draws from it, and the recompute from a copy of its state
    before the call, so it draws what the forward drew.

    Arguments:
        f: A function.
        reentrant: Ignored.
    """

    del reentrant

    def wrapper(*args, generator: torch.Generator | None = None):
        if generator is None:
            return torch.utils.checkpoint.checkpoint(f, *args, use_reentrant=False)

        state = generator.get_state()
        runs = []

        def run(*args):
            g = generator
            if runs:
                g = torch.Generator(device=generator.device)
                g.set_state(state)
            runs.append(g)
            return f(*args, generator=g)

        return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)

    return wrapper
