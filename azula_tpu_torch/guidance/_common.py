r"""What the guidance methods share: the autograd islands (vector-Jacobian
products through a function, taken inside a sampler that runs without
grad) and the choice of linear solver."""

from __future__ import annotations

import functools
import torch

from collections.abc import Callable
from torch import Tensor

from ..linalg.solve import cg, gmres


def require_autograd(name: str) -> None:
    r"""Raises where autograd cannot run: under `torch.inference_mode()`,
    whose tensors no graph may record."""

    if torch.is_inference_mode_enabled():
        raise RuntimeError(
            f"{name} takes vector-Jacobian products, which torch.inference_mode() forbids: "
            "run the sampler under torch.no_grad() instead"
        )


def vjp(f: Callable[[Tensor], Tensor], x: Tensor, name: str) -> tuple[Tensor, Callable[..., Tensor]]:
    r"""`jax.vjp(f, x)`: the value of `f` at `x`, detached, and its pullback.

    The pullback keeps the graph for the next product; the call with
    `last=True` frees it. Nothing that is returned holds the graph.
    """

    require_autograd(name)

    with torch.enable_grad():
        x = x.detach().requires_grad_()
        y = f(x)

    def pullback(v: Tensor, last: bool = False) -> Tensor:
        (g,) = torch.autograd.grad(y, x, v.to(y.dtype), retain_graph=not last)
        return g

    return y.detach(), pullback


def jvp(f: Callable[[Tensor], Tensor], x: Tensor, v: Tensor) -> Tensor:
    r"""`jax.jvp(f, (x,), (v,))[1]`, by forward-mode differentiation."""

    return torch.func.jvp(f, (x,), (v,))[1]


def make_solver(name: str, iterations: int) -> Callable:
    r"""The named linear solver (`'cg'` or `'gmres'`) with its iterations."""

    if name == "cg":
        return functools.partial(cg, iterations=iterations)
    elif name == "gmres":
        return functools.partial(gmres, iterations=iterations)
    else:
        raise ValueError(f"Unknown solver '{name}'.")
