r"""Weight conversion from the JAX package's EDM2 backbone.

:func:`from_jax_state_dict` takes the flat mapping that
`azula_tpu.utils.pytree.state_dict(module)` yields for an `EDM2Precond`
(keys under `unet.`), a bare `EDM2UNet` or a block, as numpy arrays, and
returns the state dict of the port's module, whose keys are the NVlabs/edm2
checkpoints': `MPConv` weights from :math:`(*k, C_i, C_o)` (or
:math:`(C_i, C_o)`) to :math:`(C_o, C_i, *k)`, and the scalar gains
(`emb_gain`, `out_gain`) and the Fourier buffers (`freqs`, `phases`) copied
as they are. A port state dict is therefore a checkpoint-layout state dict,
which the JAX package's `convert_eldm_state_dict` loads back.

:func:`build_from_pickle` reads an NVlabs/edm2 checkpoint, serialized
through the same `torch_utils.persistence` format as EDM's, with the EDM
family's stub reader (:mod:`azula_tpu_torch.models.edm.convert`).
"""

from __future__ import annotations

__all__ = [
    "build_from_pickle",
    "from_jax_state_dict",
]

import numpy as np
import os
import torch

from collections.abc import Mapping
from torch import nn

from ...nn.utils import skip_init
from ..edm.convert import load_nvlabs_pickle, stub_state_dict
from ..utils import from_jax_arrays, load_device, load_weights


def from_jax_state_dict(
    sd: Mapping[str, np.ndarray], module: nn.Module | None = None
) -> dict[str, torch.Tensor]:
    r"""Converts a JAX EDM2 state dict to the port's layout.

    Arguments:
        sd: The JAX state dict, as numpy arrays.
        module: Optionally, the port's module, to hold the result to.

    Returns:
        The port's state dict, as CPU tensors of the arrays' dtypes.
    """

    return from_jax_arrays(sd, module, raw=("emb_gain", "out_gain", "freqs", "phases"))


def build_from_pickle(
    path: str | os.PathLike, device=None, dtype: torch.dtype | None = None
) -> tuple[nn.Module, np.ndarray | None, np.ndarray | None]:
    r"""Builds the port's :class:`EDM2Precond` from an NVlabs/edm2
    checkpoint: the hyperparameters stored in the pickle, a
    :func:`~azula_tpu_torch.nn.utils.skip_init` construction, the EMA
    weights loaded strictly. The uncertainty head of the post-hoc
    reconstructions (`logvar_*`), training machinery, is left out.

    Arguments:
        path: The pickle.
        device: The device of the module. Defaults to the card (`'cuda'`).
        dtype: The dtype of its floating tensors. Defaults to the file's.

    Returns:
        `(precond, shift, scale)`: the module and the per-channel latent
        statistics of the checkpoint's encoder (None without one).
    """

    from .backbone import EDM2Precond, EDM2UNet

    device = load_device(device)
    content = load_nvlabs_pickle(path)
    ema = content["ema"]

    kwargs = ema.init_kwargs
    kwargs.update(zip(("img_resolution", "img_channels", "label_dim"), ema.init_args))

    label_dim = kwargs.get("label_dim", 0)
    sigma_data = kwargs.pop("sigma_data", 0.5)
    for name in ("use_fp16", "use_bf16", "logvar_channels", "dropout"):
        kwargs.pop(name, None)

    def make(device):
        return EDM2Precond(EDM2UNet(**kwargs, device=device), label_dim=label_dim, sigma_data=sigma_data)

    sd = {k: v for k, v in stub_state_dict(ema).items() if not k.startswith("logvar")}
    module = load_weights(skip_init(make), sd, device=device, dtype=dtype)

    shift = scale = None
    encoder = content.get("encoder")
    if encoder is not None:
        state = {
            **encoder.__dict__.get("_buffers", {}),
            **encoder.__dict__.get("_parameters", {}),
            **{k: v for k, v in encoder.__dict__.items() if not k.startswith("_")},
        }
        if "bias" in state and "scale" in state:
            shift = np.asarray(torch.as_tensor(state["bias"]).float().reshape(-1))
            scale = np.asarray(torch.as_tensor(state["scale"]).float().reshape(-1))

    return module, shift, scale
