r"""Checkpointing.

Port of :func:`azula_tpu.utils.checkpoint.save_checkpoint` and
:func:`~azula_tpu.utils.checkpoint.load_checkpoint`: a module's state dict,
and optionally an optimizer's, in one file written by `torch.save` and read
back by `torch.load(weights_only=True)`. The orbax variants are not ported.
"""

from __future__ import annotations

__all__ = [
    "load_checkpoint",
    "save_checkpoint",
]

import torch

from pathlib import Path
from torch import nn


def save_checkpoint(path: str | Path, module: nn.Module, optimizer: torch.optim.Optimizer | None = None) -> None:
    r"""Saves the state dict of `module`, and of `optimizer` if given."""

    state = {"module": module.state_dict()}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    torch.save(state, path)


def load_checkpoint(
    path: str | Path,
    module: nn.Module,
    optimizer: torch.optim.Optimizer | None = None,
    strict: bool = True,
) -> nn.Module:
    r"""Restores `module` (and `optimizer`, if given) in place from a file
    written by :func:`save_checkpoint`, and returns `module`.

    Arguments:
        path: The checkpoint file.
        module: The module to restore.
        optimizer: The optimizer to restore; the file must hold its state.
        strict: Whether the module's keys must match the file's exactly.
    """

    state = torch.load(path, map_location="cpu", weights_only=True)

    module.load_state_dict(state["module"], strict=strict)

    if optimizer is not None:
        if "optimizer" not in state:
            raise KeyError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(state["optimizer"])

    return module
