r"""Fixed-iteration Krylov solvers.

Port of :mod:`azula_tpu.linalg.solve`. Both solvers run a fixed number of
iterations with no convergence test, so a solve never waits for the card.
The scalar recurrences run at a working precision (float32 by default, as in
the JAX package), while the operator is evaluated in the caller's dtype (it
may be a bf16 backbone's vector-Jacobian product); denominators are floored
at the working precision's machine epsilon.
"""

from __future__ import annotations

__all__ = [
    "cg",
    "gmres",
]

import torch

from collections.abc import Callable
from torch import Tensor


def _rowdot(u: Tensor, v: Tensor) -> Tensor:
    r"""Batched inner product over the trailing axis: `(*, D) -> (*,)`."""

    return torch.sum(u * v, dim=-1)


def cg(
    A: Callable[[Tensor], Tensor],
    b: Tensor,
    x0: Tensor | None = None,
    iterations: int = 1,
    dtype: torch.dtype | None = None,
) -> Tensor:
    r"""Runs :math:`n` conjugate-gradient iterations on :math:`Ax = b`.

    CG requires :math:`A` to act as a symmetric PSD operator. The recurrence
    is the textbook one (Hestenes & Stiefel), with the step length's and the
    mixing factor's denominators floored at machine epsilon, so an early
    exact solve takes zero-length steps instead of giving NaNs.

    Arguments:
        A: The linear operator :math:`x \mapsto Ax`.
        b: The right-hand side :math:`b`, with shape :math:`(*, D)`.
        x0: An optional warm start with shape :math:`(*, D)`; zero when omitted.
        iterations: The number of iterations :math:`n`.
        dtype: Working precision of the recurrence (default float32).

    Returns:
        The iterate :math:`x_n`, with shape :math:`(*, D)`, in `b`'s dtype.
    """

    if dtype is None:
        dtype = torch.float32

    tiny = torch.finfo(dtype).eps
    io_dtype = b.dtype

    if x0 is None:
        sol = torch.zeros_like(b, dtype=dtype)
        resid = b.to(dtype)
    else:
        sol = x0.to(dtype)
        resid = (b - A(x0)).to(dtype)

    resid_sq = _rowdot(resid, resid)
    dirn = resid

    for _ in range(iterations):
        op_dir = A(dirn.to(io_dtype)).to(dtype)
        step = resid_sq / torch.clamp(_rowdot(dirn, op_dir), min=tiny)

        sol = sol + step[..., None] * dirn
        resid = resid - step[..., None] * op_dir

        new_sq = _rowdot(resid, resid)
        mix = new_sq / torch.clamp(resid_sq, min=tiny)
        dirn = resid + mix[..., None] * dirn
        resid_sq = new_sq

    return sol.to(io_dtype)


def gmres(
    A: Callable[[Tensor], Tensor],
    b: Tensor,
    x0: Tensor | None = None,
    iterations: int = 1,
    dtype: torch.dtype | None = None,
) -> Tensor:
    r"""Runs :math:`m` GMRES iterations on :math:`Ax = b`.

    Works for any square operator. The Krylov basis is built by modified
    Gram-Schmidt (Arnoldi), and each new Hessenberg column is rotated into
    upper-triangular form by the Givens rotations so far and one new one, so
    the least-squares problem at the end is one small triangular solve. The
    loop over the :math:`m` columns is unrolled in Python, each column a list
    of batched scalars, as in the JAX package.

    Arguments:
        A: The linear operator :math:`x \mapsto Ax`.
        b: The right-hand side :math:`b`, with shape :math:`(*, D)`.
        x0: An optional warm start with shape :math:`(*, D)`; zero when omitted.
        iterations: The Krylov subspace dimension :math:`m`.
        dtype: Working precision of the recurrence (default float32).

    Returns:
        The iterate :math:`x_m`, with shape :math:`(*, D)`, in `b`'s dtype.
    """

    if dtype is None:
        dtype = torch.float32

    tiny = torch.finfo(dtype).eps
    io_dtype = b.dtype
    m = iterations

    resid = b if x0 is None else b - A(x0)
    resid = resid.to(dtype)

    def unit(v):
        length = torch.linalg.vector_norm(v, dim=-1)
        return v / torch.clamp(length[..., None], min=tiny), length

    def make_rotation(a, h):
        # the plane rotation [c -s; s c] [a; h] = [hypot(a, h); 0]
        hyp = torch.clamp(torch.sqrt(a * a + h * h), min=tiny)
        return a / hyp, -h / hyp

    q0, resid_len = unit(resid)

    basis = [q0]  # orthonormal Krylov vectors, each (*, D)
    upper = []  # rotated (triangular) Hessenberg columns, column j has j + 1 entries
    rhs = [resid_len]  # rotated residual projections, one more per column
    rotations = []

    for j in range(m):
        w = A(basis[j].to(io_dtype)).to(dtype)

        # modified Gram-Schmidt against every basis vector so far
        col = []
        for q in basis:
            proj = _rowdot(w, q)
            w = w - proj[..., None] * q
            col.append(proj)
        w, spill = unit(w)
        col.append(spill)
        basis.append(w)

        # replay the rotations so far, then one more zeroes the subdiagonal
        for i, (c, s) in enumerate(rotations):
            hi, lo = col[i], col[i + 1]
            col[i] = c * hi - s * lo
            col[i + 1] = s * hi + c * lo

        c, s = make_rotation(col[j], col[j + 1])
        rotations.append((c, s))
        col[j] = c * col[j] - s * col[j + 1]
        col[j + 1] = torch.zeros_like(col[j])

        # the same rotation acts on the residual projections
        rhs.append(s * rhs[j])
        rhs[j] = c * rhs[j]

        upper.append(col)

    # the (m, m) triangular system R y = g, columns zero-padded to stack
    zero = torch.zeros_like(rhs[0])
    R = torch.stack(
        [torch.stack(col[:m] + [zero] * (m - len(col[:m])), dim=-1) for col in upper],
        dim=-1,
    )  # (*, m, m), column j in R[..., :, j]
    g = torch.stack(rhs[:m], dim=-1)

    y = torch.linalg.solve_triangular(
        R + tiny * torch.eye(m, dtype=dtype, device=R.device),
        g[..., None],
        upper=True,
    )[..., 0]

    span = torch.stack(basis[:m], dim=-2)  # (*, m, D)
    update = torch.einsum("...i,...ij->...j", y, span)

    sol = update if x0 is None else x0 + update

    return sol.to(io_dtype)
