r"""Classifier-free guidance (CFG).

Port of :mod:`azula_tpu.guidance.cfg`.

References:
    | Classifier-Free Diffusion Guidance (Ho et al., 2022)
    | https://arxiv.org/abs/2207.12598
"""

from __future__ import annotations

__all__ = [
    "CFGDenoiser",
]

import torch

from collections.abc import Callable
from torch import Tensor
from typing import Any

from ..denoise import Denoiser, DiracPosterior
from ..noise import Schedule


def _map2(fn: Callable, p, n):
    r"""`jax.tree.map(fn, p, n)` over dicts, lists and tuples."""

    if isinstance(p, dict) and isinstance(n, dict) and p.keys() == n.keys():
        return {k: _map2(fn, p[k], n[k]) for k in p}
    if isinstance(p, (list, tuple)) and type(p) is type(n) and len(p) == len(n):
        return type(p)(_map2(fn, a, b) for a, b in zip(p, n, strict=True))
    if isinstance(p, (dict, list, tuple)) or isinstance(n, (dict, list, tuple)):
        raise ValueError(f"CFGDenoiser(batched=True): conditioning structures differ: {p!r} vs {n!r}")
    return fn(p, n)


class CFGDenoiser(Denoiser):
    r"""Creates a CFG denoiser module.

    Arguments:
        denoiser: A denoiser :math:`q_\phi(X \mid X_t)`.
        batched: Whether to fuse the positive and negative predictions into
            one :math:`2B`-batch denoiser call instead of two :math:`B`-batch
            calls. The positive and negative conditioning must then share
            their keys and, after batch broadcasting, their shapes.
    """

    def __init__(self, denoiser: Denoiser, batched: bool = False) -> None:
        super().__init__()

        self.denoiser = denoiser
        self.batched = batched

    @property
    def schedule(self) -> Schedule:
        return self.denoiser.schedule

    def forward(
        self,
        x_t: Tensor,
        t: Tensor,
        positive: dict[str, Any],
        negative: dict[str, Any] = {},  # noqa: B006
        guidance: float | Tensor = 1.0,
        **kwargs,
    ) -> DiracPosterior:
        r"""
        Arguments:
            x_t: A noisy tensor :math:`x_t`, with shape :math:`(B, *)`.
            t: The time :math:`t`, with shape :math:`()` or :math:`(B)`.
            positive: The positive label :math:`c_+` as keyword arguments.
            negative: The negative label :math:`c_-` as keyword arguments.
            guidance: The guidance strength :math:`\omega \in \mathbb{R}_+`.
            kwargs: Optional keyword arguments.

        Returns:
            The Dirac delta :math:`\delta(X - \mu)` with
            :math:`\mu = (1 + \omega) \mu_\phi(x_t \mid c_+) - \omega \mu_\phi(x_t \mid c_-)`.
        """

        if self.batched:
            # a loud contract instead of a silent two-call fallback
            if positive.keys() != negative.keys():
                raise ValueError(
                    "CFGDenoiser(batched=True) requires positive and negative "
                    "conditioning to share keys; got "
                    f"positive={sorted(positive)} vs negative={sorted(negative)}. "
                    "Pass batched=False for asymmetric conditioning."
                )

            B = x_t.shape[0]

            def batchify(a: Tensor) -> Tensor:
                # a leading dim in (1, B) is read as the batch axis; anything
                # else is an unbatched leaf and gets one
                if a.ndim == 0 or a.shape[0] not in (1, B):
                    a = a[None]
                return a.expand(B, *a.shape[1:])

            def fuse(name: str, p, n) -> Tensor:
                p = batchify(torch.as_tensor(p, device=x_t.device))
                n = batchify(torch.as_tensor(n, device=x_t.device))
                if p.shape != n.shape:
                    raise ValueError(
                        f"CFGDenoiser(batched=True): conditioning '{name}' has "
                        f"incompatible shapes {tuple(p.shape)} vs {tuple(n.shape)} after "
                        "batch broadcasting"
                    )
                return torch.cat([p, n])

            x2 = torch.cat([x_t, x_t])
            t2 = torch.broadcast_to(torch.as_tensor(t, device=x_t.device), (B,))
            t2 = torch.cat([t2, t2])
            cond = {
                k: _map2(lambda p, n, _k=k: fuse(_k, p, n), positive[k], negative[k])
                for k in positive
            }

            mean = self.denoiser(x2, t2, **cond, **kwargs).mean
            pos, neg = mean[:B], mean[B:]

            return DiracPosterior(mean=pos + guidance * (pos - neg))

        q_pos = self.denoiser(x_t, t, **positive, **kwargs)
        q_neg = self.denoiser(x_t, t, **negative, **kwargs)

        return DiracPosterior(mean=q_pos.mean + guidance * (q_pos.mean - q_neg.mean))
