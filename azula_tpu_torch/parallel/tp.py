r"""Tensor-parallel and fully sharded parameters.

Port of :mod:`azula_tpu.parallel.tp`. JAX annotates each parameter with a
sharding of its *global* array and lets the SPMD partitioner insert the
collectives. Here each rank holds its *piece* of a parameter, and the
modules that use the pieces call the collectives themselves, so that the
kernels of :mod:`azula_tpu_torch.ops` run on plain tensors of the rank's own
heads (they take no DTensor).

**Tensor parallelism** (Megatron). A rule table maps parameter names to
placements over the `'model'` mesh dim. torch's `Linear` weight is
(out, in), JAX's (in, out): a column-parallel `P(None, "model")` is
`Shard(0)` here, a row-parallel `P("model", None)` is `Shard(1)`. Each rule
table below keeps JAX's rules, in the port's names, one beside each, and
adds what a rank needs because it sees its piece and not the whole:

- a fused projection is split per segment (:class:`Segments`): the q, k and
  v thirds of `qkv_proj` each give every rank its heads (a contiguous cut
  would give rank 0 all of q and part of k), and so do the attention and
  MLP parts of the input of Flux's single-block `proj_out`;
- the modules that split heads (`heads` attributes) take the rank's head
  count, and the rotary projection of the DiT attention gives each rank its
  heads' angles;
- SANA 1.5's RMS q/k normalization across heads sums its squares over the
  ranks;
- a replicated parameter that a rank uses on its own heads (Flux's per-head
  q/k norms) gets the all-reduced gradient of all the heads.

A column-parallel `Linear` passes its input through an identity whose
backward all-reduces the input's gradient; a row-parallel `Linear`
all-reduces its output, with an identity backward, and adds its bias after.
Replicated parameters so get the one-rank gradient on every rank, and split
ones the one-rank gradient's piece.

**FSDP** follows JAX's rule (`tp.py:125-158`): every parameter of at least
`min_size` elements is split along its largest dimension that divides by the
`'data'` size, the rest replicated. It is built on explicit collectives, not
FSDP2's `fully_shard`: a forward pre-hook of the owning module all-gathers
the whole parameter (an autograd function whose backward all-reduces the
gradient and keeps this rank's piece, averaged over the ranks), and a
forward hook drops it again.
"""

from __future__ import annotations

__all__ = [
    "DIT_TP_RULES",
    "FLUX_TP_RULES",
    "Placement",
    "SANA_TP_RULES",
    "SD_TP_RULES",
    "Segments",
    "fsdp_shardings",
    "join_pieces",
    "module_shardings",
    "shard_module",
    "shard_module_fsdp",
    "split_pieces",
]

import copy
import dataclasses
import re
import torch
import torch.distributed as dist
import torch.nn.functional as F

from collections.abc import Callable
from typing import NamedTuple
from torch import Tensor, nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..nn.layers import Linear
from .mesh import get_mesh


@dataclasses.dataclass(frozen=True)
class Segments:
    r"""A placement that splits each segment of dimension `dim` contiguously
    over the ranks, and gives each rank its piece of every segment, in order.

    Arguments:
        dim: The split dimension.
        sizes: The segments' sizes: an int for that many equal segments, or
            a function of the parameter's shape.
    """

    dim: int
    sizes: int | Callable[[tuple[int, ...]], tuple[int, ...]] = 1

    def segments(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        if isinstance(self.sizes, int):
            return (shape[self.dim] // self.sizes,) * self.sizes
        return tuple(self.sizes(shape))


class Placement(NamedTuple):
    r"""How a parameter of a split module is split: the mesh dim, the
    placement over it (`Shard` or :class:`Segments`) and the whole shape;
    and, where the piece is split again over a second mesh dim (ZeRO-3 on a
    tensor-parallel piece, :func:`~azula_tpu_torch.parallel.recipes.flux_serving_shardings`),
    that dim and the dimension it splits (`then`), which the spec leaves
    whole. :func:`shard_module` and :func:`shard_module_fsdp` set it as the
    `placement` attribute of each piece, which the sharded checkpoints
    read."""

    axis: str
    spec: object
    shape: tuple[int, ...]
    then: tuple[str, int] | None = None


def _attention_and_mlp(shape: tuple[int, ...]) -> tuple[int, int]:
    r"""The input segments of Flux's single-block `proj_out`, (dim, dim +
    inner): the attention output, then the MLP's."""

    return shape[0], shape[1] - shape[0]


# (name regex, placement) — first match wins; names start with ".". JAX's
# rules, one beside each (JAX's spec in the comment), in torch's (out, in)
# weight layout. Megatron layout: column-parallel first matmul, row-parallel
# second, one all-reduce per block.
DIT_TP_RULES = (
    (r"\.msa\.qkv_proj\.weight$", Segments(0, 3)),  # P(None, "model")
    (r"\.msa\.qkv_proj\.bias$", Segments(0, 3)),  # P("model")
    (r"\.msa\.y_proj\.weight$", Shard(1)),  # P("model", None)
    (r"\.ffn1\.weight$", Shard(0)),  # P(None, "model")
    (r"\.ffn1\.bias$", Shard(0)),  # P("model")
    (r"\.ffn2\.weight$", Shard(1)),  # P("model", None)
    # the port's: each rank's heads' rotary angles
    (r"\.msa\.theta_proj\.weight$", Shard(0)),
)

# Megatron layout of the Flux MMDiT: heads and FFN hiddens split over
# 'model', output projections row-parallel. 'model' divides the heads (24
# for FLUX.1).
FLUX_TP_RULES = (
    # dual-stream joint attention: column-parallel q/k/v of both streams
    (r"\.attn\.(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj)\.weight$", Shard(0)),  # P(None, "model")
    (r"\.attn\.(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj)\.bias$", Shard(0)),  # P("model")
    (r"\.attn\.(to_out\.0|to_add_out)\.weight$", Shard(1)),  # P("model", None)
    # dual-stream feed-forwards
    (r"\.(ff|ff_context)\.net\.0\.proj\.weight$", Shard(0)),  # P(None, "model")
    (r"\.(ff|ff_context)\.net\.0\.proj\.bias$", Shard(0)),  # P("model")
    (r"\.(ff|ff_context)\.net\.2\.weight$", Shard(1)),  # P("model", None)
    # single-stream blocks: attention and MLP in parallel, one output
    (r"single_transformer_blocks\.\d+\.proj_mlp\.weight$", Shard(0)),  # P(None, "model")
    (r"single_transformer_blocks\.\d+\.proj_mlp\.bias$", Shard(0)),  # P("model")
    (r"single_transformer_blocks\.\d+\.proj_out\.weight$", Segments(1, _attention_and_mlp)),  # P("model", None)
)

# Attention-parallel layout of the Sana linear DiT: linear self-attention
# and cross-attention heads split over 'model'; the GLUMBConv feed-forward
# stays replicated (its GLU gate halves the expansion channels). 'model'
# divides both head counts.
SANA_TP_RULES = (
    (r"\.(attn1|attn2)\.(to_q|to_k|to_v)\.weight$", Shard(0)),  # P(None, "model")
    (r"\.(attn1|attn2)\.(to_q|to_k|to_v)\.bias$", Shard(0)),  # P("model")
    (r"\.(attn1|attn2)\.to_out\.0\.weight$", Shard(1)),  # P("model", None)
    # the port's: SANA 1.5's RMS norm across heads scales each rank's channels
    (r"\.(attn1|attn2)\.(norm_q|norm_k)\.weight$", Shard(0)),
)

# Attention-parallel layout of the SD UNet's transformer stages: self- and
# cross-attention heads split over 'model'; the GEGLU feed-forward and the
# convolutional stages stay replicated. 'model' divides the heads.
SD_TP_RULES = (
    (r"\.(attn1|attn2)\.(to_q|to_k|to_v)\.weight$", Shard(0)),  # P(None, "model")
    (r"\.(attn1|attn2)\.to_out\.0\.weight$", Shard(1)),  # P("model", None)
)


def _segments(spec, shape: tuple[int, ...]) -> tuple[int, ...]:
    return spec.segments(shape) if isinstance(spec, Segments) else (shape[spec.dim],)


def _piece(x: Tensor, spec, rank: int, n: int) -> Tensor:
    r"""This rank's piece of a whole tensor under `spec`; `x` itself over
    one rank."""

    if n == 1:
        return x

    parts = []
    for seg in x.split(list(_segments(spec, tuple(x.shape))), dim=spec.dim):
        if seg.shape[spec.dim] % n:
            raise ValueError(f"a dimension of {seg.shape[spec.dim]} does not split over {n} ranks")
        parts.append(seg.chunk(n, dim=spec.dim)[rank])

    return torch.cat(parts, dim=spec.dim)


def split_pieces(local: Tensor, placement: Placement, n: int) -> list[tuple[Tensor, tuple[int, ...]]]:
    r"""Cuts a rank's piece of a parameter split over `n` ranks into its
    pieces of the placement's segments (one for a `Shard`, one per segment
    of a :class:`Segments`), each with the segment's whole shape; the
    whole parameter is the segments' concatenation along the split
    dimension. :func:`join_pieces` is the inverse."""

    spec, shape = placement.spec, placement.shape

    out = []
    segments = _segments(spec, shape)
    for piece, size in zip(local.split([s // n for s in segments], dim=spec.dim), segments, strict=True):
        whole = list(shape)
        whole[spec.dim] = size
        out.append((piece, tuple(whole)))

    return out


def join_pieces(pieces: list[Tensor], placement: Placement) -> Tensor:
    r"""Joins a rank's pieces of the segments of a split parameter into its
    piece of the parameter, or the segments themselves into the parameter:
    the inverse of :func:`split_pieces`."""

    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=placement.spec.dim)


def module_shardings(module: nn.Module, rules=DIT_TP_RULES) -> dict:
    r"""Returns the placement of each parameter of `module` over the
    `'model'` dim, by name: the first rule whose regex matches, else
    `Replicate()`. JAX's takes the mesh to build its shardings; placements
    need none."""

    out = {}
    for name, _ in module.named_parameters():
        for pattern, spec in rules:
            if re.search(pattern, "." + name):
                out[name] = spec
                break
        else:
            out[name] = Replicate()

    return out


class _CopyToModel(torch.autograd.Function):
    r"""Identity forward, all-reduced gradient: the input of a
    column-parallel region."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    r"""All-reduced forward, identity gradient: the output of a row-parallel
    region."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    r"""All-reduced forward and gradient: a sum over the ranks whose every
    summand each rank uses."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class ColumnParallelLinear(Linear):
    r"""A `Linear` whose output features are split over the ranks of
    `group`: the rank's rows of the weight and of the bias."""

    def __init__(self, weight: Tensor, bias: Tensor | None, group: dist.ProcessGroup) -> None:
        nn.Module.__init__(self)

        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.group = group

    def forward(self, x: Tensor) -> Tensor:
        return super().forward(_CopyToModel.apply(x, self.group))


class RowParallelLinear(Linear):
    r"""A `Linear` whose input features are split over the ranks of `group`:
    the rank's columns of the weight; the partial products are all-reduced,
    then the whole bias is added."""

    def __init__(self, weight: Tensor, bias: Tensor | None, group: dist.ProcessGroup) -> None:
        nn.Module.__init__(self)

        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.group = group

    def forward(self, x: Tensor) -> Tensor:
        y = _ReduceFromModel.apply(F.linear(x, self.weight.to(x.dtype)), self.group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ParallelRMSNorm(nn.Module):
    r"""An RMS normalization over channels split over the ranks of `group`
    (SANA 1.5's across heads): the squares are summed over the ranks, and
    each rank scales its channels by its piece of the weight.

    Arguments:
        norm: The whole normalization (`eps`, `weight`).
        weight: This rank's piece of the weight.
        channels: The whole number of channels.
        group: The process group.
    """

    def __init__(self, norm: nn.Module, weight: Tensor, channels: int, group: dist.ProcessGroup) -> None:
        super().__init__()

        self.weight = nn.Parameter(weight)
        self.eps = norm.eps
        self.channels = channels
        self.group = group

    def forward(self, x: Tensor) -> Tensor:
        h = x.float()
        ss = _AllReduce.apply(torch.square(h).sum(dim=-1, keepdim=True), self.group)
        h = h * torch.rsqrt(ss / self.channels + self.eps)

        return h.to(x.dtype) * self.weight.to(x.dtype)


def _owner(module: nn.Module, name: str) -> tuple[nn.Module, str, str]:
    prefix, _, leaf = name.rpartition(".")
    return module.get_submodule(prefix), prefix, leaf


def _replace(root: nn.Module, prefix: str, new: nn.Module) -> None:
    parent, _, child = prefix.rpartition(".")
    setattr(root.get_submodule(parent), child, new)


def shard_module(
    module: nn.Module, mesh: DeviceMesh | None = None, rules=DIT_TP_RULES, inplace: bool = False
) -> nn.Module:
    r"""Returns a copy of `module` (or `module` itself, split in place, with
    `inplace`: the whole parameters are dropped as their pieces replace them,
    so that a model that fills the card is never held twice) split over the
    mesh's `'model'` dim by the rules: each split `Linear` becomes a :class:`ColumnParallelLinear`
    (`Shard(0)`, :class:`Segments` of dim 0) or a
    :class:`RowParallelLinear` (`Shard(1)`, :class:`Segments` of dim 1), an
    RMS norm with a split weight a :class:`ParallelRMSNorm`, and each module
    with a `heads` attribute above a split projection takes the rank's head
    count. Parameter names are kept, so the state dict has the module's
    keys with the rank's pieces. Compose with data parallelism by splitting
    the inputs' batch over `'data'` (:func:`~azula_tpu_torch.parallel.mesh.shard_batch`).

    Raises:
        ValueError: When a column-parallel weight's bias has no matching
            rule, a rule matches a module that cannot be split, or a split
            does not divide.
    """

    if mesh is None:
        mesh = get_mesh()

    group = mesh.get_group("model")
    rank, n = mesh.get_local_rank("model"), mesh.size(mesh.mesh_dim_names.index("model"))

    specs = module_shardings(module, rules)
    if not inplace:
        module = copy.deepcopy(module)

    split = {name: spec for name, spec in specs.items() if not isinstance(spec, Replicate)}
    owners = {}
    for name in split:
        owner, prefix, leaf = _owner(module, name)
        owners.setdefault(prefix, (owner, {}))[1][leaf] = split[name]

    columns = set()
    for prefix, (owner, leaves) in owners.items():
        weight = leaves.get("weight")
        if isinstance(owner, Linear) and weight is not None:
            column = weight.dim == 0
            bias = owner.bias
            if column and bias is not None:
                if "bias" not in leaves:
                    raise ValueError(f"{prefix}.weight is split by rows but no rule splits {prefix}.bias")
                bias = _piece(bias.detach(), leaves["bias"], rank, n)
            elif bias is not None:
                bias = bias.detach().clone()
            w = _piece(owner.weight.detach(), weight, rank, n)
            cls = ColumnParallelLinear if column else RowParallelLinear
            new = cls(w, bias, group)
            new.weight.placement = Placement("model", weight, tuple(owner.weight.shape))
            if column and new.bias is not None:
                new.bias.placement = Placement("model", leaves["bias"], tuple(owner.bias.shape))
            _replace(module, prefix, new)
            if column:
                columns.add(prefix)
        elif set(leaves) == {"weight"} and hasattr(owner, "eps") and owner.weight.ndim == 1:
            w = _piece(owner.weight.detach(), weight, rank, n)
            new = ParallelRMSNorm(owner, w, owner.weight.shape[0], group)
            new.weight.placement = Placement("model", weight, tuple(owner.weight.shape))
            _replace(module, prefix, new)
        else:
            raise ValueError(f"the rules split {sorted(leaves)} of {prefix}, which is no Linear or RMS norm")

    split_heads = []
    for prefix, sub in module.named_modules():
        heads = getattr(sub, "heads", None)
        if isinstance(heads, int) and any(c in columns for c in (f"{prefix}.{k}".lstrip(".") for k, _ in sub.named_children())):
            if heads % n:
                raise ValueError(f"{prefix} has {heads} heads, which do not split over {n} ranks")
            sub.heads = heads // n
            split_heads.append(sub)

    # a replicated parameter used on the rank's heads (Flux's per-head q/k
    # norms) enters the split region as its input does: all-reduced gradient
    for sub in split_heads:
        for owner in sub.modules():
            if isinstance(owner, (ColumnParallelLinear, RowParallelLinear, ParallelRMSNorm)):
                continue
            leaves = [leaf for leaf, _ in owner.named_parameters(recurse=False)]
            if leaves:
                _use_hooks(owner, leaves, lambda p, leaf: _CopyToModel.apply(p, group))

    return module


def fsdp_shardings(module: nn.Module, mesh: DeviceMesh | None = None, axis: str = "data", min_size: int = 2**16) -> dict:
    r"""Returns the ZeRO-3 placement of each parameter of `module` over the
    `axis` dim, by name: `Shard(d)` of its largest dimension that divides by
    the dim's size if it has at least `min_size` elements, else
    `Replicate()`."""

    if mesh is None:
        mesh = get_mesh()

    n = mesh.size(mesh.mesh_dim_names.index(axis))

    out = {}
    for name, p in module.named_parameters():
        out[name] = Replicate()
        if p.numel() < min_size:
            continue
        for d in sorted(range(p.ndim), key=lambda d: p.shape[d], reverse=True):
            if p.shape[d] % n == 0:
                out[name] = Shard(d)
                break

    return out


class _GatherParameter(torch.autograd.Function):
    r"""All-gathers a parameter's pieces along `dim`; the backward averages
    the whole gradient over the ranks and keeps this rank's piece (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        if dist.get_world_size(group) == 1:
            return x.view_as(x)
        pieces = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(pieces, x.contiguous(), group=group)
        return torch.cat(pieces, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(n, dim=ctx.dim)[dist.get_rank(ctx.group)] / n, None, None


def _use_hooks(owner: nn.Module, leaves, use: Callable[[Tensor, str], Tensor]) -> None:
    r"""Makes `owner`'s forward see `use(p, leaf)` in place of each parameter
    `p` named `leaf` in `leaves`: a forward pre-hook shadows the attribute (the
    instance's `__dict__` comes before the module's parameters), a forward
    hook drops it. The parameters, their names and the state dict stay."""

    def pre(mod, args):
        for leaf in leaves:
            mod.__dict__[leaf] = use(mod._parameters[leaf], leaf)

    def post(mod, args, output):
        for leaf in leaves:
            mod.__dict__.pop(leaf, None)

    owner.register_forward_pre_hook(pre)
    owner.register_forward_hook(post)


def _split_over(module: nn.Module, specs: dict, mesh: DeviceMesh, axis: str) -> nn.Module:
    r"""Splits, in place, each parameter of `module` that `specs` maps to a
    `Shard` over the mesh's `axis` dim, as :func:`shard_module_fsdp`
    describes; a piece of :func:`shard_module` split so again records the
    second dim in its placement (`Placement.then`). Returns `module`."""

    group = mesh.get_group(axis)
    rank, n = mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))

    owners = {}
    for name, spec in specs.items():
        if isinstance(spec, Shard):
            owner, prefix, leaf = _owner(module, name)
            whole = owner._parameters[leaf]
            piece = nn.Parameter(_piece(whole.detach(), spec, rank, n))
            placement = getattr(whole, "placement", None)
            if placement is None:
                piece.placement = Placement(axis, spec, tuple(whole.shape))
            else:
                piece.placement = placement._replace(then=(axis, spec.dim))
            piece.fsdp_group = group
            owner._parameters[leaf] = piece
            owners.setdefault(prefix, (owner, {}))[1][leaf] = spec.dim

    for owner, leaves in owners.values():
        _use_hooks(owner, leaves, lambda p, leaf, dims=leaves: _GatherParameter.apply(p, dims[leaf], group))

    return module


def shard_module_fsdp(module: nn.Module, mesh: DeviceMesh | None = None, axis: str = "data", min_size: int = 2**16) -> nn.Module:
    r"""Returns a copy of `module` whose parameters are split by
    :func:`fsdp_shardings`: each split parameter keeps its name and holds
    the rank's piece, and the module that owns it gathers the whole tensor
    for its forward only (the module docstring). A split parameter has an
    `fsdp_group` attribute, the group whose gradients its backward has
    averaged (:func:`~azula_tpu_torch.parallel.batch.average_gradients`
    leaves it alone)."""

    if mesh is None:
        mesh = get_mesh()

    specs = fsdp_shardings(module, mesh, axis, min_size)

    return _split_over(copy.deepcopy(module), specs, mesh, axis)
