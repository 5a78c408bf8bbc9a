r"""Restricted reading of PyTorch checkpoints.

Port of :mod:`azula_tpu.models.ptread`. A checkpoint may hold only what the
JAX package's reader admits: containers, primitives, tensors and storages
(the rebuild functions of `torch._utils`, the typed-storage classes,
`torch.Size`, `torch.serialization._get_layout`, `_codecs.encode`,
`torch.storage._load_from_bytes`) and numpy arrays, dtypes and scalars. Any
other global raises :class:`pickle.UnpicklingError` when the unpickler meets
it, before it is called.

- :func:`load_pt` reads both formats of `torch.save` (the zip container,
  memory-mapped, and the legacy sequential pickles) through `torch.load`
  with a `pickle_module` whose unpickler admits only those globals.
  (`torch.load(weights_only=True)` refuses numpy objects and admits some
  globals that the JAX reader refuses: `torch.device`, the dtypes, ...)
- :class:`RestrictedUnpickler` reads plain pickles (the NVlabs checkpoints),
  whose tensors reduce through `torch.storage._load_from_bytes`: the bytes
  it receives are a legacy-format file, read again by :func:`load_pt`, never
  by a full unpickle.
"""

from __future__ import annotations

__all__ = [
    "RestrictedUnpickler",
    "load_pt",
]

import collections
import io
import numpy as np
import os
import pickle
import torch
import types
import zipfile

from typing import IO, Any

_STORAGES = (
    "DoubleStorage",
    "FloatStorage",
    "HalfStorage",
    "BFloat16Storage",
    "LongStorage",
    "IntStorage",
    "ShortStorage",
    "CharStorage",
    "ByteStorage",
    "BoolStorage",
    "ComplexFloatStorage",
    "ComplexDoubleStorage",
)

_TORCH_GLOBALS = {
    ("collections", "OrderedDict"),
    ("torch._utils", "_rebuild_tensor"),
    ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_parameter"),
    ("torch.storage", "_load_from_bytes"),
    ("torch", "Size"),
    ("torch.serialization", "_get_layout"),
    ("_codecs", "encode"),
    *(("torch", name) for name in _STORAGES),
}

_NUMPY_GLOBALS = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}

ALLOWED = frozenset(_TORCH_GLOBALS | _NUMPY_GLOBALS)


def _multiarray():
    # numpy 2 moved `numpy.core` to `numpy._core` (the old name warns)
    try:
        from numpy._core import multiarray
    except ImportError:  # numpy < 2
        from numpy.core import multiarray

    return multiarray


def _load_from_bytes(b: bytes):
    r"""`torch.storage._load_from_bytes`, restricted: `b` is a legacy-format
    file (how a plain-pickled storage embeds its data), read by
    :func:`load_pt`."""

    return load_pt(io.BytesIO(b))


def _allow(module: str, name: str) -> None:
    if (module, name) not in ALLOWED:
        raise pickle.UnpicklingError(f"global '{module}.{name}' is not allowed in a weights checkpoint")


def _resolve(module: str, name: str) -> Any:
    r"""The object a permitted global stands for."""

    _allow(module, name)

    if module.startswith("numpy.") and module.endswith("multiarray"):
        return getattr(_multiarray(), name)
    if module == "numpy":
        return getattr(np, name)
    if (module, name) == ("torch.storage", "_load_from_bytes"):
        return _load_from_bytes
    if module == "collections":
        return collections.OrderedDict
    if module == "_codecs":
        import _codecs

        return _codecs.encode

    import importlib

    return getattr(importlib.import_module(module), name)


def load_pt(path: str | os.PathLike | IO[bytes], map_location: str | torch.device = "cpu") -> Any:
    r"""Loads a PyTorch checkpoint of either serialization format, admitting
    only the globals of :data:`ALLOWED`.

    The zip format is memory-mapped when `path` names a file: the tensors
    read the file's pages when they are first used.

    Arguments:
        path: The checkpoint file, or a binary file object.
        map_location: Where the tensors are placed.

    Returns:
        The deserialized object, typically a (nested) dict of tensors.

    Raises:
        pickle.UnpicklingError: On a global outside :data:`ALLOWED`.
    """

    if isinstance(path, (str, os.PathLike)):
        mmap = zipfile.is_zipfile(path)
        return torch.load(str(path), map_location=map_location, weights_only=False, pickle_module=_PICKLE, mmap=mmap)

    return torch.load(path, map_location=map_location, weights_only=False, pickle_module=_PICKLE)


class RestrictedUnpickler(pickle.Unpickler):
    r"""Unpickler of plain pickles restricted to checkpoint content.

    The globals of :data:`ALLOWED` resolve to the objects they name (torch's
    rebuild functions, numpy's constructors), `torch.storage._load_from_bytes`
    to a restricted read of its bytes; anything else raises. Subclasses may
    extend :meth:`find_class` (the NVlabs persistence hooks of
    :mod:`azula_tpu_torch.models.edm.convert`).
    """

    def find_class(self, module: str, name: str) -> Any:
        return _resolve(module, name)


class _Gate(RestrictedUnpickler):
    r"""The unpickler that `torch.load` subclasses to read both formats.

    `torch.load` wraps `pickle_module.Unpickler` in a class of its own whose
    `find_class` resolves storage names itself, before it calls the base's.
    Every subclass of this one checks each global against :data:`ALLOWED`
    first, then resolves it as the subclass would."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        resolve = cls.find_class

        def find_class(self, module: str, name: str) -> Any:
            _allow(module, name)
            return resolve(self, module, name)

        cls.find_class = find_class


# the `pickle_module` of `torch.load`: all its pickles go through the gate
_PICKLE = types.SimpleNamespace(
    __name__=f"{__name__}._PICKLE",
    Unpickler=_Gate,
    load=lambda f, **kwargs: _Gate(f, **kwargs).load(),
)
