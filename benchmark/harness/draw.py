r"""Weights and inputs drawn from the run's seed.

Every stream of draws has its own generator, seeded from the run's seed and
the stream's name, so that the program's side and the reference's side can
draw the same tensors independently: the weights once, the inputs of each
trajectory by its index.
"""

from __future__ import annotations

import hashlib
import math
import torch

# where each leaf starts in the flat buffer: a multiple of this many elements
# (256 bytes in bf16), so that every leaf is aligned as a separate allocation
ALIGN = 128


def stream_seed(seed: int, *parts) -> int:
    r"""A 63-bit seed for the stream named by `parts` under the run's `seed`."""

    digest = hashlib.sha256(repr((int(seed), *parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *parts))


def _kind(name: str, shapes: dict) -> tuple[str, int]:
    r"""How a leaf is drawn: `('uniform', fan_in)` for a weight of two or
    more dimensions and for the bias beside one, `('gain', 0)` for the
    weight of a norm, `('shift', 0)` for the bias of a norm."""

    shape = shapes[name]
    if len(shape) >= 2:
        return "uniform", math.prod(shape[1:])
    if name.endswith("bias"):
        weight = shapes.get(name[: -len("bias")] + "weight", ())
        if len(weight) >= 2:
            return "uniform", math.prod(weight[1:])
        return "shift", 0
    return "gain", 0


def weights(shapes: dict[str, tuple[int, ...]], seed: int, device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    r"""A state dict of `shapes` in `dtype` on `device`, drawn from `seed` in
    one call into one buffer, each leaf a view of it: layers (and their
    biases) uniform in :math:`\pm 1/\sqrt{\text{fan-in}}`, as PyTorch
    initializes them; norm gains :math:`1 + U(-0.1, 0.1)` and norm shifts
    :math:`U(-0.1, 0.1)`, so that the affine parts of the norms do work. No
    layer is zero: the ones a model initializes at zero are drawn like the
    others."""

    offsets, total = {}, 0
    for name, shape in shapes.items():
        offsets[name] = total
        total += -(-math.prod(shape) // ALIGN) * ALIGN

    flat = torch.empty(total, device=device, dtype=dtype)
    flat.uniform_(-1.0, 1.0, generator=generator(device, seed, "weights"))

    state = {}
    for name, shape in shapes.items():
        leaf = flat[offsets[name] : offsets[name] + math.prod(shape)].view(shape)
        kind, fan_in = _kind(name, shapes)
        if kind == "uniform":
            leaf.mul_(1 / math.sqrt(fan_in))
        elif kind == "gain":
            leaf.mul_(0.1).add_(1.0)
        else:
            leaf.mul_(0.1)
        state[name] = leaf

    return state
