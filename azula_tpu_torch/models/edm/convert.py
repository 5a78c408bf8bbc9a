r"""Weight conversion from the JAX package's EDM backbones.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(module)` yields for a precond wrapper
(keys under `model.`) or a bare UNet, as numpy arrays, and returns the state
dict of the port's module, whose keys are the NVlabs checkpoints': each
convolution's normalized `filter`, :math:`(k_f, k_f)`, becomes its
`resample_filter` buffer, :math:`(1, 1, k_f, k_f)`; the Fourier embedding's
`freqs` is copied as it is; GroupNorm `scale` -> `weight`, Linear and
convolution weights to PyTorch's layouts. A port state dict is therefore a
checkpoint-layout state dict, which the JAX package's
`convert_edm_state_dict` loads back.

The NVlabs checkpoints are pickled modules serialized through
`torch_utils.persistence`: each module reduces to
`_reconstruct_persistent_obj(meta)`, with `meta["state"]` its `__dict__`
(`_parameters`, `_buffers`, `_modules`, the constructor's `_init_args` and
`_init_kwargs`). :func:`load_nvlabs_pickle` reads them through the
restricted unpickler of :mod:`azula_tpu_torch.models.ptread`, the
reconstruction globals resolved to attribute bags (:class:`StubModule`):
no NVlabs source tree is needed. :func:`build_from_pickle` builds the port's
precond module from the hyperparameters stored in the pickle and fills it
with the stub's tensors, whose names are the port's.
"""

from __future__ import annotations

__all__ = [
    "StubModule",
    "build_from_pickle",
    "from_jax_state_dict",
    "load_nvlabs_pickle",
    "stub_state_dict",
]

import numpy as np
import os
import torch

from collections.abc import Mapping
from torch import nn

from ...nn.utils import skip_init
from ..ptread import RestrictedUnpickler
from ..utils import from_jax_arrays, load_device, load_weights


def resample_filters(sd: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    r"""`sd` with each `<conv>.filter`, :math:`(k_f, k_f)`, renamed to the
    checkpoints' `<conv>.resample_filter`, :math:`(1, 1, k_f, k_f)`."""

    out = {}
    for key, value in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf == "filter":
            key, value = f"{prefix}.resample_filter", np.asarray(value)[None, None]
        out[key] = value
    return out


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts a JAX EDM state dict (a precond's, a UNet's or a block's) to
    the port's layout.

    Arguments:
        sd: The JAX state dict, as numpy arrays.
        module: Optionally, the port's module, to hold the result to.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.
    """

    return from_jax_arrays(resample_filters(sd), module, raw=("resample_filter", "freqs"))


class StubModule:
    r"""What a persistent NVlabs module unpickles to: its original `__dict__`
    (parameters, buffers, children, constructor arguments) and the
    persistence metadata."""

    @property
    def class_name(self) -> str:
        return self._meta.get("class_name", "").rsplit(".", 1)[-1]

    @property
    def init_args(self) -> tuple:
        return tuple(self.__dict__.get("_init_args", ()))

    @property
    def init_kwargs(self) -> dict:
        return dict(self.__dict__.get("_init_kwargs", {}))


def _reconstruct_persistent_obj(meta) -> StubModule:
    obj = StubModule.__new__(StubModule)
    obj.__dict__["_meta"] = dict(meta)
    obj.__dict__.update(meta["state"] if isinstance(meta, dict) else meta.state)
    return obj


class _EasyDict(dict):
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


class _NVlabsUnpickler(RestrictedUnpickler):
    r"""The restricted unpickler, with the `torch_utils.persistence`
    reconstruction and `dnnlib.EasyDict` globals."""

    def find_class(self, module: str, name: str):
        if module.startswith("torch_utils") and name == "_reconstruct_persistent_obj":
            return _reconstruct_persistent_obj
        if module.startswith("dnnlib") and name == "EasyDict":
            return _EasyDict
        return super().find_class(module, name)


def load_nvlabs_pickle(path: str | os.PathLike) -> dict:
    r"""Unpickles an NVlabs checkpoint without the NVlabs source tree; the
    tensors' storages are read by :func:`~azula_tpu_torch.models.ptread.load_pt`.

    Returns:
        The content dict (e.g. `{'ema': StubModule, ...}`).
    """

    with open(path, "rb") as f:
        return _NVlabsUnpickler(f).load()


def stub_state_dict(stub: StubModule, prefix: str = "") -> dict[str, torch.Tensor]:
    r"""Flattens a stub module tree into dotted parameter and buffer names."""

    out = {}

    for name, value in {**stub.__dict__.get("_parameters", {}), **stub.__dict__.get("_buffers", {})}.items():
        if value is not None:
            out[f"{prefix}{name}"] = value

    for name, child in stub.__dict__.get("_modules", {}).items():
        if child is not None:
            out.update(stub_state_dict(child, prefix=f"{prefix}{name}."))

    return out


def build_from_pickle(path: str | os.PathLike, device=None, dtype: torch.dtype | None = None) -> nn.Module:
    r"""Builds the port's precond module (:class:`SongUNet` or
    :class:`DhariwalUNet` in its `VPPrecond`, `VEPrecond` or `EDMPrecond`)
    from an NVlabs checkpoint: the hyperparameters stored in the pickle, a
    :func:`~azula_tpu_torch.nn.utils.skip_init` construction, the EMA
    weights loaded strictly.

    Arguments:
        path: The pickle.
        device: The device of the module. Defaults to the card (`'cuda'`).
        dtype: The dtype of its floating tensors. Defaults to the file's.

    Returns:
        A module with the EDM calling convention `module(x, sigma,
        class_labels=...)` (channels-last).
    """

    from .backbone import PRECONDS, DhariwalUNet, SongUNet

    device = load_device(device)
    ema = load_nvlabs_pickle(path)["ema"]

    precond_cls = PRECONDS[ema.class_name]
    model_stub = ema.__dict__["_modules"]["model"]
    model_cls = {"SongUNet": SongUNet, "DhariwalUNet": DhariwalUNet}[model_stub.class_name]

    # the positional arguments are (img_resolution, in_channels, out_channels)
    kwargs = model_stub.init_kwargs
    kwargs.update(zip(("img_resolution", "in_channels", "out_channels"), model_stub.init_args))

    # the precond's own hyperparameters
    precond_kwargs = {k: ema.init_kwargs[k] for k in ("sigma_data", "beta_d", "beta_min", "M") if k in ema.init_kwargs}

    def make(device):
        return precond_cls(model_cls(**kwargs, device=device), **precond_kwargs)

    return load_weights(skip_init(make), stub_state_dict(ema), device=device, dtype=dtype)
