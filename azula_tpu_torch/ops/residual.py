r"""The residual sum of a block with its convolutions' biases, channels-last.

:func:`residual_add` computes :math:`\mathrm{skip} + h + (b_1 + b_2)`, the
per-channel biases broadcast over the leading axes, in float32, rounded once
to the output dtype. A residual block whose last convolution (and skip
convolution) runs without bias passes the biases here, so that they are
added in the pass that reads the two branches anyway, not in a pass of
their own after each convolution (cuDNN leaves the bias to a separate
broadcast `add_` over the convolution's output).

On the card the sum is always the hand-written kernel `csrc/residual.cu`;
on the CPU it is its plain version, which rounds at the same point. The JAX
package has no such kernel: XLA adds a convolution's bias in the
convolution itself.
"""

from __future__ import annotations

__all__ = [
    "residual_add",
]

import torch

from torch import Tensor

from . import _build
from ..utils import profiling

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _residual_add_plain(skip: Tensor, h: Tensor, *biases: Tensor) -> Tensor:
    r"""Plain PyTorch version: `(skip + h) + (b_1 + b_2)` in float32, with
    zero, one or two biases, each taken in the output dtype (the promoted
    dtype of `skip` and `h`) and summed first, rounded once to the output
    dtype."""

    dtype = torch.promote_types(skip.dtype, h.dtype)
    y = skip.float() + h.float()
    if len(biases) == 2:
        y = y + (biases[0].to(dtype).float() + biases[1].to(dtype).float())
    elif biases:
        y = y + biases[0].to(dtype).float()

    return y.to(dtype)


def _residual_add_kernel(skip: Tensor, h: Tensor, *biases: Tensor) -> Tensor:
    r"""Launches `csrc/residual.cu` on CUDA tensors; counts the launch under
    `"residual_add"`. The inputs are brought to what the kernel reads:
    `skip`, `h` and the biases in the output dtype (float32 or bfloat16),
    contiguous. The kernel itself takes any number of channels and any
    alignment (16-byte vectors where every pointer and the rows allow them,
    single elements otherwise)."""

    dtype = torch.promote_types(skip.dtype, h.dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"the residual_add kernel takes float32 or bfloat16, got {dtype}")
    if any(t.device != h.device for t in (skip, *biases)):
        raise ValueError(f"residual_add takes tensors on one device, got {[str(t.device) for t in (skip, h, *biases)]}")

    skip, h = skip.to(dtype).contiguous(), h.to(dtype).contiguous()
    biases = [b.to(dtype).contiguous() for b in biases]
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out

    b0 = biases[0].data_ptr() if len(biases) > 0 else None
    b1 = biases[1].data_ptr() if len(biases) > 1 else None
    C = h.shape[-1]

    status = _build.library().azula_residual_add(
        skip.data_ptr(), h.data_ptr(), b0, b1, out.data_ptr(), h.numel() // C, C, _DTYPES[dtype],
        _build.stream(h.device),
    )
    _build.check(status, "residual_add")
    _build.launched("residual_add", out)

    return out


def _residual_forward(skip: Tensor, h: Tensor, biases: tuple[Tensor, ...]) -> Tensor:
    if h.device.type == "cuda":
        return _residual_add_kernel(skip, h, *biases)

    return _residual_add_plain(skip, h, *biases)


class _ResidualAdd(torch.autograd.Function):
    r"""The sum's gradient: the output's gradient as it is to `skip` and `h`
    (in their dtypes), and its sum over every axis but the channels to each
    bias."""

    @staticmethod
    def forward(ctx, skip, h, *biases):
        ctx.dtypes = (skip.dtype, h.dtype, *(b.dtype for b in biases))
        return _residual_forward(skip, h, biases)

    @staticmethod
    def backward(ctx, g):
        gs, gh, *gb = ctx.dtypes
        g_bias = g.float().sum(dim=tuple(range(g.ndim - 1))) if gb else None
        return (
            g.to(gs),
            g.to(gh),
            *(g_bias.to(dtype) for dtype in gb),
        )


def _residual_work(skip: Tensor, h: Tensor, *biases: Tensor) -> tuple[tuple[int, ...], int, int]:
    r"""A call's nominal work: shape :math:`(B, HW, C)`, no FLOPs counted (it
    is bound by its bytes), `skip` and `h` read once, the output written
    once, each bias read once."""

    B, C = h.shape[0], h.shape[-1]
    nbytes = (skip.numel() * skip.element_size() + 2 * h.numel() * h.element_size()
              + sum(b.numel() * b.element_size() for b in biases))

    return (B, h.numel() // (B * C), C), 0, nbytes


def residual_add(skip: Tensor, h: Tensor, *biases: Tensor | None) -> Tensor:
    r"""The residual sum `skip + h` with per-channel biases, in float32,
    rounded once.

    On a CUDA device the sum is the kernel `csrc/residual.cu`, which takes
    float32 and bfloat16 (raises :class:`TypeError` for other dtypes); on the
    CPU its plain version.

    Arguments:
        skip: The skip branch, with shape :math:`(B, *, C)` (channels last).
        h: The residual branch, with the shape of `skip`.
        biases: At most two per-channel biases, each with shape :math:`(C,)`,
            taken in the output dtype and summed first; a `None` among them is
            left out.

    Returns:
        :math:`\mathrm{skip} + h + \sum_i b_i`, with the shape of `h` and the
        promoted dtype of `skip` and `h`.
    """

    biases = tuple(b for b in biases if b is not None)
    if skip.shape != h.shape or h.ndim < 1 or len(biases) > 2 or any(b.shape != h.shape[-1:] for b in biases):
        shapes = [tuple(t.shape) for t in (skip, h, *biases)]
        raise ValueError(f"residual_add takes skip and h of one shape (B, *, C) and up to two (C,) biases, got {shapes}")

    with profiling.annotate("azula.ops.residual_add", _residual_work, skip, h, *biases):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (skip, h, *biases)):
            return _ResidualAdd.apply(skip, h, *biases)

        return _residual_forward(skip, h, biases)
