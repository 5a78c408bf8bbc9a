r"""Attention layers.

Port of :mod:`azula_tpu.nn.attention`: fused-QKV multi-head self-attention
with optional QK RMS-norm and learned continuous RoPE. On the card, inputs
that pass the fused gate go through the fused MSA kernel
(:func:`azula_tpu_torch.ops.fused_msa.fused_msa_attention`); the others, and
every input on the CPU, split the heads and go through
:func:`azula_tpu_torch.ops.attention.dot_product_attention`.
"""

from __future__ import annotations

__all__ = [
    "MultiheadSelfAttention",
    "apply_rope",
]

import math
import torch

from torch import Tensor, nn

from ..ops.attention import dot_product_attention
from ..ops.fused_msa import fused_msa_attention, fused_msa_eligible
from .layers import Identity, Linear, RMSNorm
from .utils import default_device, promote_dtype


class MultiheadSelfAttention(nn.Module):
    r"""Creates a multi-head self-attention layer.

    Arguments:
        channels: The number of channels :math:`H \times C`.
        pos_channels: The number of positional channels :math:`P` (with RoPE).
        attention_heads: The number of attention heads :math:`H`.
        qkv_bias: Whether to add bias to the query-key-value projection.
        qk_norm: Whether to use query-key RMS-normalization.
        rope: Whether to use learned continuous rotary positional embedding.
        dropout: The attention dropout rate in :math:`[0, 1]`.
        implementation: :py:`None` or `'auto'` (the fused kernel where the
            gate admits the input, else the attention of
            :func:`~azula_tpu_torch.ops.attention.dot_product_attention`),
            `'kernel'` or `'plain'` (the unfused route, forwarded), or the
            sequence-parallel routes `'ring'` and `'ulysses'`
            (:mod:`azula_tpu_torch.parallel.ring`,
            :mod:`~azula_tpu_torch.parallel.ulysses`), for inputs that hold
            this rank's tokens of a sequence split over `ring_axis`.
        ring_axis: The ranks that split the sequence under `'ring'` or
            `'ulysses'`: a process group, the name of a dim of the current
            mesh, or :py:`None` for all ranks.
        device: The device of the parameters. Defaults to the card (`'cuda'`).
        dtype: The dtype of the parameters. Defaults to float32.
        generator: The generator of the initial parameters (the JAX `key`).
    """

    def __init__(
        self,
        channels: int,
        pos_channels: int = 1,
        attention_heads: int = 1,
        qkv_bias: bool = True,
        qk_norm: bool = True,
        rope: bool = False,
        dropout: float | None = None,
        implementation: str | None = None,
        ring_axis=None,
        *,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()

        if channels % attention_heads:
            raise ValueError(f"{channels} channels do not split into {attention_heads} heads")
        if implementation not in (None, "auto", "kernel", "plain", "ring", "ulysses"):
            raise ValueError(f"unknown attention implementation '{implementation}'")

        device = default_device(device)
        factory = dict(device=device, dtype=dtype, generator=generator)  # noqa: C408

        self.qkv_proj = Linear(channels, 3 * channels, bias=qkv_bias, **factory)
        self.y_proj = Linear(channels, channels, bias=False, **factory)

        if qk_norm:
            self.qk_norm = RMSNorm(dim=-1, eps=1e-5)
        else:
            self.qk_norm = Identity()

        if rope:
            # learned continuous RoPE: angles are a linear map of the
            # P positions, random log-magnitudes times random unit directions
            magnitude = torch.rand((channels // 2, 1), device=device, generator=generator)
            magnitude = torch.exp(math.log(1e-1) * magnitude)
            direction = torch.randn((channels // 2, pos_channels), device=device, generator=generator)
            direction = direction / torch.linalg.vector_norm(direction, dim=-1, keepdim=True)

            self.theta_proj = Linear(pos_channels, channels // 2, bias=False, **factory)
            with torch.no_grad():
                self.theta_proj.weight.copy_(magnitude * direction)
        else:
            self.theta_proj = None

        self.heads = attention_heads
        self.dropout = 0.0 if dropout is None else dropout
        self.implementation = implementation
        self.ring_axis = ring_axis

    def forward(
        self,
        x: Tensor,
        pos: Tensor | None = None,
        mask: Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> Tensor:
        r"""
        Arguments:
            x: The input tokens :math:`x`, with shape :math:`(*, L, H \times C)`.
            pos: Optional position vectors :math:`p`, with shape :math:`(*, L, P)`.
            mask: Optional attention mask, with shape :math:`(L, L)`.
            generator: The generator of the attention dropout, which it enables
                (training; the JAX `key`).

        Returns:
            The output tokens :math:`y`, with shape :math:`(*, L, H \times C)`.
        """

        qkv = self.qkv_proj(x)

        theta = None if self.theta_proj is None else self.theta_proj(pos)

        if self.implementation in (None, "auto") and fused_msa_eligible(
            x, self.heads, theta, mask, self.dropout, generator
        ):
            # one kernel on the projection layout (B, L, 3 H C): no head
            # transpose, no L x L weights in memory
            eps = self.qk_norm.eps if isinstance(self.qk_norm, RMSNorm) else None
            y = fused_msa_attention(qkv, self.heads, theta, eps=eps)
            return self.y_proj(y)

        # (*, L, 3 H C) -> 3 x (*, H, L, C), views; on the card the attention
        # copies them contiguous for its kernels, and under grad those copies,
        # its output and the rows' log-sum-exp are what its backward saves.
        # The QK-norm and RoPE compute in float32 and cast back, so q, k and v
        # keep the activations' dtype.
        q, k, v = qkv.unflatten(-1, (3, self.heads, -1)).movedim(-3, 0).transpose(-3, -2)
        q, k = self.qk_norm(q), self.qk_norm(k)

        if theta is not None:
            theta = theta.unflatten(-1, (self.heads, -1)).transpose(-3, -2)
            q, k = apply_rope(q, k, theta)

        if self.implementation == "ring":
            # masks are cut to the blocks of the ring; dropout is refused, as
            # its weights would need a counter scheme shared with the
            # backward's recomputation across the ring's steps
            if generator is not None and self.dropout > 0:
                raise NotImplementedError(
                    "ring attention does not support dropout; use implementation='ulysses' for "
                    "sequence-parallel dropout training"
                )

            from ..parallel.ring import ring_attention_local

            y = ring_attention_local(q, k, v, axis=self.ring_axis, mask=mask)
        elif self.implementation == "ulysses":
            from ..parallel.ulysses import ulysses_attention_local

            y = ulysses_attention_local(
                q,
                k,
                v,
                axis=self.ring_axis,
                mask=mask,
                dropout_rate=self.dropout if generator is not None else 0.0,
                generator=generator,
            )
        else:
            y = dot_product_attention(
                q,
                k,
                v,
                mask=mask,
                dropout_rate=self.dropout if generator is not None else 0.0,
                generator=generator,
                implementation=self.implementation,
            )

        y = y.transpose(-3, -2).flatten(-2)  # (*, L, H C)

        return self.y_proj(y)


@promote_dtype
def apply_rope(q: Tensor, k: Tensor, theta: Tensor) -> tuple[Tensor, Tensor]:
    r"""Rotates query/key pairs by position-dependent angles.

    Arguments:
        q: The query vectors, with shape :math:`(*, C)`.
        k: The key vectors, with shape :math:`(*, C)`.
        theta: Rotary angles, with shape :math:`(*, C / 2)`.

    Returns:
        The rotated query and key vectors, with shape :math:`(*, C)`.
    """

    cos_theta = torch.cos(theta)
    sin_theta = torch.sin(theta)

    def rotate(z: Tensor) -> Tensor:
        z = z.unflatten(-1, (-1, 2))
        real, imag = z[..., 0], z[..., 1]
        z = torch.stack(
            (real * cos_theta - imag * sin_theta, real * sin_theta + imag * cos_theta),
            dim=-1,
        )
        return z.flatten(-2)

    return rotate(q), rotate(k)
