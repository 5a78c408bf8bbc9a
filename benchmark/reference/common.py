r"""What the references share: the precision of their products, the DDIM
sampler, and how a reference holds the benchmark's weights."""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from torch import Tensor, nn

# the largest finite float8 e4m3 value
FP8_MAX = 448.0


class Ops:
    r"""The products of a reference (linear layers, convolutions, attention
    matmuls) in float32 with TF32 off, their operands first rounded to
    `precision`: `'float32'` (the reference itself, no rounding) or
    `'float8'` (e4m3 with one scale per operand tensor, as an fp8 GEMM takes
    them: the control). Everything between the products stays float32."""

    def __init__(self, precision: str = "float32") -> None:
        if precision not in ("float32", "float8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def round(self, x: Tensor) -> Tensor:
        x = x.float()
        if self.precision == "float8":
            scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x

    def linear(self, x: Tensor, weight: Tensor, bias: Tensor | None) -> Tensor:
        return F.linear(self.round(x), self.round(weight), None if bias is None else bias.float())

    def conv(self, x: Tensor, weight: Tensor, bias: Tensor | None, stride: int = 1, padding: int = 0) -> Tensor:
        r"""A 2-d convolution of an NCHW tensor."""

        return F.conv2d(
            self.round(x), self.round(weight), None if bias is None else bias.float(), stride=stride, padding=padding
        )

    def attention(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        r"""Softmax attention of (B, H, L, D) tensors, float32 softmax."""

        scores = torch.matmul(self.round(q), self.round(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
        weights = torch.softmax(scores, dim=-1)
        return torch.matmul(self.round(weights), self.round(v))


def no_tf32() -> None:
    r"""Float32 products in float32: cuBLAS and cuDNN would otherwise take
    TF32, a lower precision than the reference states."""

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def served(x: Tensor, dtype: torch.dtype) -> Tensor:
    r"""`x` rounded to the served dtype and widened again: what a network
    served in `dtype` receives as its input."""

    return x.to(dtype).double()


def parameter(module: nn.Module, name: str, *shape: int) -> None:
    r"""Declares a parameter of `shape` on the meta device: the references
    get their values from the benchmark's state dict (`load_state_dict(...,
    assign=True)`), kept in the dtype the benchmark drew them in."""

    module.register_parameter(name, nn.Parameter(torch.empty(shape, device="meta"), requires_grad=False))


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True) -> None:
        super().__init__()

        parameter(self, "weight", out_features, in_features)
        if bias:
            parameter(self, "bias", out_features)
        else:
            self.bias = None

    def forward(self, x: Tensor, ops: Ops) -> Tensor:
        return ops.linear(x, self.weight, self.bias)


def shapes(module: nn.Module) -> dict[str, tuple[int, ...]]:
    r"""The names and shapes of a reference's parameters."""

    return {name: tuple(p.shape) for name, p in module.named_parameters()}


def ddim(denoise, schedule, x: Tensor, steps: int, eta: float = 0.0) -> tuple[Tensor, Tensor]:
    r"""DDIM (Song et al., 2021) from time 1 to 0 in `steps` equal steps, in
    float64 between the network calls:

    .. math:: x_s = \alpha_s \hat{x} + \sigma_s \frac{x_t - \alpha_t \hat{x}}{\sigma_t}

    with :math:`\hat{x}` the denoiser's mean at :math:`(x_t, t)`. Only
    :math:`\eta = 0` is deterministic, and only it is compared.

    Returns:
        The network's output at the first call and the final sample.
    """

    if eta != 0:
        raise ValueError("the reference DDIM is deterministic: eta = 0")

    times = torch.linspace(1.0, 0.0, steps + 1, dtype=torch.float64, device=x.device)
    x = x.double()
    first = None

    for i in range(steps):
        t, s = times[i], times[i + 1]
        alpha_t, sigma_t = schedule(t)
        alpha_s, sigma_s = schedule(s)
        mean, output = denoise(x, t)
        if first is None:
            first = output
        x = alpha_s * mean + sigma_s / sigma_t * (x - alpha_t * mean)

    return first, x


CALLS_PER_STEP = {"DDIMSampler": 1}
SAMPLERS = {"DDIMSampler": ddim}
