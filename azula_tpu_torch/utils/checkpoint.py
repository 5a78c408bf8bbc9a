r"""Checkpointing.

Port of :func:`azula_tpu.utils.checkpoint.save_checkpoint` and
:func:`~azula_tpu.utils.checkpoint.load_checkpoint`: a module's state dict,
and optionally an optimizer's, in one file written by `torch.save` and read
back by `torch.load(weights_only=True)`.

The orbax variants, :func:`~azula_tpu.utils.checkpoint.save_checkpoint_orbax`
and :func:`~azula_tpu.utils.checkpoint.load_checkpoint_orbax`, become
:func:`save_checkpoint_sharded` and :func:`load_checkpoint_sharded` on
`torch.distributed.checkpoint`: each rank writes and reads its own pieces of
a module split by :mod:`azula_tpu_torch.parallel.tp` (tensor-parallel or
FSDP), and of its optimizer's state, into one checkpoint directory.
"""

from __future__ import annotations

__all__ = [
    "load_checkpoint",
    "load_checkpoint_sharded",
    "save_checkpoint",
    "save_checkpoint_sharded",
]

import torch

from pathlib import Path
from torch import Tensor, nn


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


def _entries(key: str, local: Tensor, placement, mesh) -> dict:
    r"""The checkpoint entries of one tensor: itself when it is replicated;
    else a DTensor over `mesh` per segment of its split, whose whole tensor
    is that segment of the unsplit parameter (split over a second mesh dim
    too where the placement says `then`)."""

    if placement is None:
        return {key: local}

    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ..parallel.tp import split_pieces

    axis, spec = placement.axis, placement.spec
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    dims = {axis: spec.dim}
    if placement.then is not None:
        then, dim = placement.then
        dims[then] = dim
    placements = [Shard(dims[name]) if name in dims else Replicate() for name in mesh.mesh_dim_names]

    pieces = split_pieces(local, placement, n)

    out = {}
    for i, (piece, whole) in enumerate(pieces):
        name = key if len(pieces) == 1 else f"{key}#{i}"
        stride = torch.empty(whole, device="meta").stride()
        out[name] = DTensor.from_local(
            piece.contiguous(), mesh, placements, run_check=False, shape=torch.Size(whole), stride=stride
        )

    return out


def _sharded_state(module: nn.Module, optimizer, mesh, keys=None) -> tuple[dict, dict]:
    r"""The flat state to save or to load into, and for each parameter and
    optimizer tensor the tensor to copy a loaded value back to."""

    state, targets = {}, {}
    params = dict(module.named_parameters())
    for key, value in module.state_dict(keep_vars=True).items():
        placement = getattr(params.get(key), "placement", None)
        entries = _entries(key, value.detach(), placement, mesh)
        state.update(entries)
        targets[key] = (value, list(entries), placement)

    if optimizer is not None:
        names = {id(p): name for name, p in params.items()}
        for group in optimizer.param_groups:
            for p in group["params"]:
                name = names[id(p)]
                slots = optimizer.state[p]
                if keys is not None and not slots:
                    # a fresh optimizer: its slots as the checkpoint holds
                    # them, of the parameter's shape or scalars (on the CPU,
                    # as torch.optim keeps its steps)
                    prefix = f"optimizer.{name}."
                    whole = getattr(p, "placement", None)
                    whole = tuple(p.shape) if whole is None else whole.shape
                    for key, meta in keys.items():
                        slot, _, segment = key.removeprefix(prefix).partition("#")
                        if not key.startswith(prefix) or slot in slots:
                            continue
                        if segment or tuple(meta.size) == whole:
                            slots[slot] = torch.zeros_like(p)
                        else:
                            slots[slot] = torch.zeros(meta.size, dtype=meta.properties.dtype)
                for slot, value in slots.items():
                    key = f"optimizer.{name}.{slot}"
                    placement = getattr(p, "placement", None) if value.shape == p.shape and value.ndim else None
                    entries = _entries(key, value, placement, mesh)
                    state.update(entries)
                    targets[key] = (value, list(entries), placement)
        state["optimizer.param_groups"] = [{k: v for k, v in g.items() if k != "params"} for g in optimizer.param_groups]

    return state, targets


def save_checkpoint_sharded(
    path: str | Path, module: nn.Module, optimizer: torch.optim.Optimizer | None = None, mesh=None
) -> None:
    r"""Saves a module split by :mod:`azula_tpu_torch.parallel.tp`, and its
    optimizer's state if given, with `torch.distributed.checkpoint`: every
    rank calls it, and writes its pieces into the directory `path`.

    The counterpart of :func:`azula_tpu.utils.checkpoint.save_checkpoint_orbax`.
    A split parameter (its `placement` attribute) is saved as a DTensor
    whose whole tensor is the unsplit parameter, or one per segment of a
    :class:`~azula_tpu_torch.parallel.tp.Segments` split; replicated tensors
    once.

    Arguments:
        path: The checkpoint directory.
        module: The module, split or not.
        optimizer: The optimizer over its parameters.
        mesh: The mesh of the split. Defaults to
            :func:`~azula_tpu_torch.parallel.mesh.get_mesh` when the module
            is split.
    """

    import torch.distributed.checkpoint as dcp

    if mesh is None and any(hasattr(p, "placement") for p in module.parameters()):
        from ..parallel.mesh import get_mesh

        mesh = get_mesh()

    state, _ = _sharded_state(module, optimizer, mesh)
    dcp.save(state, checkpoint_id=str(path))


def load_checkpoint_sharded(
    path: str | Path, module: nn.Module, optimizer: torch.optim.Optimizer | None = None, mesh=None
) -> nn.Module:
    r"""Restores, in place, a module split as it was when
    :func:`save_checkpoint_sharded` wrote `path`, and its optimizer if given;
    every rank calls it and reads its own pieces. Returns `module`.

    The counterpart of :func:`azula_tpu.utils.checkpoint.load_checkpoint_orbax`.
    """

    import torch.distributed.checkpoint as dcp

    if mesh is None and any(hasattr(p, "placement") for p in module.parameters()):
        from ..parallel.mesh import get_mesh

        mesh = get_mesh()

    keys = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
    if optimizer is not None and not any(key.startswith("optimizer.param_groups") for key in keys):
        raise KeyError(f"{path} holds no optimizer state")

    state, targets = _sharded_state(module, optimizer, mesh, keys)
    dcp.load(state, checkpoint_id=str(path))

    from ..parallel.tp import join_pieces

    with torch.no_grad():
        for target, names, placement in targets.values():
            parts = [state[name] for name in names]
            parts = [p.to_local() if hasattr(p, "to_local") else p for p in parts]
            target.copy_(parts[0] if placement is None else join_pieces(parts, placement))

    if optimizer is not None:
        for group, saved in zip(optimizer.param_groups, state["optimizer.param_groups"], strict=True):
            group.update(saved)

    return module
