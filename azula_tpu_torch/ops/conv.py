r"""Direct 3x3 convolution, channels-last.

Port of :mod:`azula_tpu.ops.conv`: :func:`conv3x3` computes a 3x3, stride 1,
zero-padded ("SAME") convolution of an NHWC input with HWIO weights
:math:`(3, 3, C, K)`, accumulating in float32, output in the input's dtype.
On the card its forward is the hand-written kernel `csrc/conv3x3.cu` (the
port of `_pallas_conv3x3`); on the CPU, its plain version. The kernel has
two forms, which its C entry chooses from the dtype and the channels before
any launch (:func:`_conv3x3_form` mirrors the rule): an implicit GEMM on the
tensor cores (bf16 with `C % 8 == 0` and `K % 8 == 0`) and a direct
convolution on the CUDA cores (float32 and the other bf16 shapes). Its
gradient goes through the library convolution's, as JAX's custom vjp goes
through XLA's.

As in the JAX package, no layer calls it: it is an opt-in entry point, and
:func:`can_use_conv3x3` says which shapes JAX's dispatch admits.
"""

from __future__ import annotations

__all__ = [
    "can_use_conv3x3",
    "conv3x3",
]

import torch
import torch.nn.functional as F

from torch import Tensor
from torch.autograd.function import once_differentiable

from . import _build
from ..utils import profiling

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _conv3x3_form(x_shape, K: int, dtype: torch.dtype) -> str:
    r"""The form of `csrc/conv3x3.cu` that a call on an input of shape
    `x_shape` (B, H, W, C) with K output channels takes, as its C entry
    (`tensor_cores` there) chooses it: `"tensor_cores"` (the implicit GEMM on
    `wgmma`) for bfloat16 with C and K multiples of 8, whose rows TMA reads
    at 16-byte strides; else `"cuda_cores"` (the direct convolution)."""

    C = x_shape[-1]
    if dtype == torch.bfloat16 and C % 8 == 0 and K % 8 == 0:
        return "tensor_cores"
    return "cuda_cores"


def _conv3x3_plain(x: Tensor, w: Tensor) -> Tensor:
    r"""Plain PyTorch version: the zero-padded input and nine shifted
    (B H W, C) x (C, K) products, accumulated in float32."""

    B, H, W, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()

    y = torch.zeros((B, H, W, w.shape[-1]), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            y += xp[:, dy : dy + H, dx : dx + W] @ wf[dy, dx]

    return y.to(x.dtype)


@_build.forward_only("conv3x3", "under grad, call conv3x3: its backward goes through the library convolution")
def _conv3x3_kernel(x: Tensor, w: Tensor) -> Tensor:
    r"""Launches `csrc/conv3x3.cu` on CUDA tensors x (B, H, W, C) and
    w (3, 3, C, K); counts the launch under `"conv3x3"` and, on the
    tensor-core form, also under `"conv3x3_tc"`."""

    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"the conv3x3 kernel needs CUDA tensors on one device, got {x.device} and {w.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"the conv3x3 kernel takes float32 or bfloat16 of one dtype, got {x.dtype} and {w.dtype}")
    if x.ndim != 4 or w.ndim != 4 or w.shape[:3] != (3, 3, x.shape[-1]):
        raise ValueError(f"the conv3x3 kernel takes x (B, H, W, C) and w (3, 3, C, K), got {x.shape} and {w.shape}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the conv3x3 kernel takes contiguous tensors")

    B, H, W, C = x.shape
    K = w.shape[-1]
    tensor_cores = _conv3x3_form(x.shape, K, x.dtype) == "tensor_cores"
    if tensor_cores and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("the conv3x3 kernel's tensor-core form takes 16-byte aligned x and w")

    y = torch.empty((B, H, W, K), dtype=x.dtype, device=x.device)

    status = _build.library().azula_conv3x3(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H, W, C, K, _DTYPES[x.dtype], _build.stream(x.device)
    )
    _build.check(status, "conv3x3")
    _build.launched("conv3x3", y)
    if tensor_cores:
        _build.LAUNCHES["conv3x3_tc"] += 1

    return y


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        if x.device.type == "cuda":
            return _conv3x3_kernel(x, w)
        return _conv3x3_plain(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # the library convolution's gradient, in PyTorch's (B, C, H, W) and
        # (K, C, 3, 3) views of the channels-last tensors
        x, w = ctx.saved_tensors
        h = x.permute(0, 3, 1, 2)
        wk = w.permute(3, 2, 0, 1)
        gk = g.permute(0, 3, 1, 2)

        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(h.shape, wk, gk, padding=1).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(h, wk.shape, gk, padding=1).permute(2, 3, 1, 0)

        return gx, gw


def conv3x3(x: Tensor, w: Tensor) -> Tensor:
    r"""3x3 / stride-1 / SAME convolution, channels-last.

    The kernel on a CUDA tensor (any shape it is given), the plain version on
    a CPU tensor. Call :func:`can_use_conv3x3` first to follow the JAX
    package's dispatch; other shapes use the layers' convolution.

    Arguments:
        x: The input, with shape :math:`(B, H, W, C)`.
        w: The weights, with shape :math:`(3, 3, C, K)` (HWIO).

    Returns:
        The output, with shape :math:`(B, H, W, K)` and the dtype of `x`.
    """

    with profiling.annotate("azula.ops.conv3x3"):
        return _Conv3x3.apply(x, w)


def can_use_conv3x3(x_shape, w_shape, stride, padding, periodic: bool) -> bool:
    r"""The JAX package's dispatch conditions for the kernel: a card (CUDA)
    available; 3x3 kernel, stride 1, padding ((1, 1), (1, 1)), not periodic;
    `C % 128 == 0` and `K % 128 == 0`; H even and at least 8.

    JAX's last condition, that a row band fits the TPU's VMEM, becomes the
    kernel's shared memory, which is a fixed size at every shape (the
    tensor-core form's three stages of a 128-position input box and a
    64 x 128 weight tile, the CUDA-core form's 10 x 10 x 16 input tile and
    9 x 16 x 64 weights), so no shape fails it. Every admitted bf16 call
    takes the tensor-core form.
    """

    if not torch.cuda.is_available():
        return False
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False

    _, H, _, C = x_shape
    kh, kw, _, K = w_shape

    if (kh, kw) != (3, 3) or tuple(stride) != (1, 1):
        return False
    if tuple(map(tuple, padding)) != ((1, 1), (1, 1)) or periodic:
        return False
    if C % 128 != 0 or K % 128 != 0:
        return False

    return H % 2 == 0 and H >= 8
