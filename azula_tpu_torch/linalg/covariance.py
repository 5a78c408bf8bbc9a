r"""Structured covariance matrices.

Port of :mod:`azula_tpu.linalg.covariance`: an algebra of structured
covariances (isotropic, diagonal, full-eigen, diagonal plus or minus low
rank, Kronecker) closed under addition with isotropic terms, scalar scaling
and inversion (Woodbury). The factors are plain tensors given to
`__init__`, as in the JAX package; the covariances compute on their
factors' device and in their dtype.
"""

from __future__ import annotations

__all__ = [
    "Covariance",
    "DMLRCovariance",
    "DPLRCovariance",
    "DiagonalCovariance",
    "FullCovariance",
    "IsotropicCovariance",
    "KroneckerCovariance",
]

import abc
import math
import string
import torch

from collections.abc import Sequence
from torch import Tensor


class Covariance(abc.ABC):
    r"""Abstract covariance matrix."""

    @property
    @abc.abstractmethod
    def shape(self) -> Sequence[int]:
        pass

    @abc.abstractmethod
    def __add__(self, other: Covariance) -> Covariance:
        pass

    def __radd__(self, other: Covariance) -> Covariance:
        return self.__add__(other)

    @abc.abstractmethod
    def __mul__(self, other: Covariance) -> Covariance:
        pass

    def __rmul__(self, other: Covariance) -> Covariance:
        return self.__mul__(other)

    @abc.abstractmethod
    def __matmul__(self, x: Tensor) -> Tensor:
        pass

    def __call__(self, x: Tensor) -> Tensor:
        return self.__matmul__(x)

    @abc.abstractmethod
    def color(self, x: Tensor) -> Tensor:
        r"""Applies a matrix square root :math:`M` (with :math:`M M^\top = C`) to `x`."""

        pass

    @property
    @abc.abstractmethod
    def inv(self) -> Covariance:
        pass

    @abc.abstractmethod
    def logdet(self) -> Tensor:
        pass


class IsotropicCovariance(Covariance):
    r"""Isotropic covariance matrix :math:`C = \lambda I`.

    Arguments:
        lmbda: The scale :math:`\lambda`, a Python number or a tensor of one
            element.
    """

    def __init__(self, lmbda: Tensor | float) -> None:
        if isinstance(lmbda, Tensor):
            self.lmbda = lmbda.reshape(())
        else:
            self.lmbda = lmbda

    @property
    def shape(self) -> Sequence[int]:
        raise NotImplementedError("IsotropicCovariance's shape is ambiguous.")

    @staticmethod
    def from_data(X: Tensor) -> IsotropicCovariance:
        return IsotropicCovariance(torch.var(X, correction=1))

    def __add__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return IsotropicCovariance(self.lmbda + other.lmbda)
        else:
            return NotImplemented

    def __mul__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return IsotropicCovariance(self.lmbda * other.lmbda)
        else:
            return NotImplemented

    def __matmul__(self, x: Tensor) -> Tensor:
        return self.lmbda * x

    def color(self, x: Tensor) -> Tensor:
        if isinstance(self.lmbda, Tensor):
            return torch.sqrt(self.lmbda) * x
        else:
            return math.sqrt(self.lmbda) * x

    @property
    def inv(self) -> IsotropicCovariance:
        return IsotropicCovariance(1 / self.lmbda)

    def logdet(self) -> Tensor:
        raise NotImplementedError("IsotropicCovariance's log determinant is ambiguous.")


class DiagonalCovariance(Covariance):
    r"""Diagonal covariance matrix :math:`C = \mathrm{diag}(D)`."""

    def __init__(self, D: Tensor) -> None:
        self.D = D

    @property
    def shape(self) -> Sequence[int]:
        return self.D.shape

    @staticmethod
    def from_data(X: Tensor) -> DiagonalCovariance:
        return DiagonalCovariance(torch.var(X, dim=0, correction=1))

    def __add__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return DiagonalCovariance(self.D + other.lmbda)
        elif isinstance(other, DiagonalCovariance):
            return DiagonalCovariance(self.D + other.D)
        else:
            return NotImplemented

    def __mul__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return DiagonalCovariance(self.D * other.lmbda)
        elif isinstance(other, DiagonalCovariance):
            return DiagonalCovariance(self.D * other.D)
        else:
            return NotImplemented

    def __matmul__(self, x: Tensor) -> Tensor:
        y = x.reshape(-1, *self.shape)
        y = self.D * y
        return y.reshape(x.shape)

    def color(self, x: Tensor) -> Tensor:
        y = x.reshape(-1, *self.shape)
        y = torch.sqrt(self.D) * y
        return y.reshape(x.shape)

    @property
    def inv(self) -> DiagonalCovariance:
        return DiagonalCovariance(1 / self.D)

    def logdet(self) -> Tensor:
        return torch.log(self.D).sum()


class FullCovariance(Covariance):
    r"""Full covariance matrix :math:`C = Q \, \mathrm{diag}(L) \, Q^\top`
    (eigendecomposition).

    Arguments:
        Q: The eigenvectors, with shape :math:`(*, D)` (the event shape, then
            one column per eigenvalue).
        L: The eigenvalues, with shape :math:`(D,)`.
    """

    def __init__(self, Q: Tensor, L: Tensor) -> None:
        self.Q, self.L = Q, L

    @property
    def shape(self) -> Sequence[int]:
        return self.Q.shape[:-1]

    @staticmethod
    def from_data(X: Tensor) -> FullCovariance:
        r"""Eigendecomposes the sample covariance of `X` (rows are samples)."""

        count, *event = X.shape
        dim = math.prod(event)

        assert count > dim, "need more samples than features for a full-rank estimate"

        flat = X.reshape(count, dim)
        centered = flat - flat.mean(dim=0)
        L, Q = torch.linalg.eigh(centered.T @ centered / (count - 1))

        return FullCovariance(Q.reshape(*event, dim), L)

    def __add__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return FullCovariance(self.Q, self.L + other.lmbda)
        else:
            return NotImplemented

    def __mul__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return FullCovariance(self.Q, self.L * other.lmbda)
        else:
            return NotImplemented

    def __matmul__(self, x: Tensor) -> Tensor:
        y = x.reshape(-1, *self.shape)
        y = torch.einsum("...i,n...->ni", self.Q, y)
        y = self.L * y
        y = torch.einsum("...i,ni->n...", self.Q, y)
        return y.reshape(x.shape)

    def color(self, x: Tensor) -> Tensor:
        y = x.reshape(-1, self.Q.shape[-1])
        y = torch.sqrt(self.L) * y
        y = torch.einsum("...i,ni->n...", self.Q, y)
        return y.reshape(x.shape)

    @property
    def inv(self) -> FullCovariance:
        return FullCovariance(self.Q, 1 / self.L)

    def logdet(self) -> Tensor:
        return torch.log(self.L).sum()


class DPLRCovariance(Covariance):
    r"""Diagonal plus low-rank (DPLR) covariance matrix
    :math:`\mathrm{diag}(D) + V V^\top`. Inversion goes through the Woodbury
    identity and the rank-sized capacitance matrix :math:`K`.

    Arguments:
        D: The diagonal, with the event shape.
        V: The low-rank factor, with shape :math:`(*, r)`.
    """

    def __init__(self, D: Tensor, V: Tensor) -> None:
        self.D, self.V = D, V

    @property
    def shape(self) -> Sequence[int]:
        return self.D.shape

    @property
    def rank(self) -> int:
        return self.V.shape[-1]

    @staticmethod
    def from_data(X: Tensor, rank: int = 1, iterations: int = 0) -> DPLRCovariance:
        r"""Fits the factor model :math:`x \sim N(\bar x, \mathrm{diag}(D) + VV^\top)`:
        the loadings start from the leading principal subspace of the
        centered data and are refined by `iterations` rounds of
        factor-analysis expectation-maximization, as the JAX package does."""

        count, *event = X.shape
        dim = math.prod(event)

        assert 0 < rank < min(dim, count)

        Y = X.reshape(count, dim)
        Y = Y - Y.mean(dim=0)
        denom = count - 1

        # the leading principal subspace, from the smaller Gram matrix
        if dim <= count:
            evals, evecs = torch.linalg.eigh(Y.T @ Y / denom)
            top_vals, top_dirs = evals[-rank:], evecs[:, -rank:]
        else:
            evals, evecs = torch.linalg.eigh(Y @ Y.T / denom)
            top_vals = evals[-rank:]
            top_dirs = Y.T @ evecs[:, -rank:]
            top_dirs = top_dirs / torch.linalg.vector_norm(top_dirs, dim=0, keepdim=True)

        V = top_dirs * torch.sqrt(top_vals)
        marginal_var = torch.var(Y, dim=0, correction=1)
        D = marginal_var - torch.square(V).sum(dim=-1)

        # EM: the E-step's posterior means through the Woodbury inverse, the
        # M-step's loadings from the normal equations
        eye = torch.eye(rank, dtype=Y.dtype, device=Y.device)
        for _ in range(iterations):
            proj = DPLRCovariance(D, V).inv(V.T)  # rows of V^T C^-1, (rank, dim)
            latent = Y @ proj.T  # posterior means, (count, rank)
            second = eye - proj @ V + latent.T @ latent / denom

            V = torch.linalg.solve(second.T, latent.T @ Y / denom).T
            D = marginal_var - torch.einsum("nf,ni,fi->f", Y, latent, V) / denom

        return DPLRCovariance(D.reshape(event), V.reshape(*event, -1))

    def __add__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return DPLRCovariance(self.D + other.lmbda, self.V)
        elif isinstance(other, DiagonalCovariance):
            return DPLRCovariance(self.D + other.D, self.V)
        elif isinstance(other, DPLRCovariance):
            return DPLRCovariance(self.D + other.D, torch.cat((self.V, other.V), dim=-1))
        else:
            return NotImplemented

    def __mul__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return DPLRCovariance(self.D * other.lmbda, self.V * _sqrt(other.lmbda))
        else:
            return NotImplemented

    def __matmul__(self, x: Tensor) -> Tensor:
        y = x.reshape(-1, *self.shape)
        y = self.D * y + torch.einsum("...i,ni->n...", self.V, torch.einsum("...i,n...->ni", self.V, y))
        return y.reshape(x.shape)

    def color(self, x: Tensor) -> Tensor:
        return _color_low_rank(self.D, self.V, x, 1)

    @property
    def K(self) -> Tensor:
        r"""The capacitance matrix :math:`K = I + V^\top D^{-1} V`."""

        return torch.eye(self.rank, dtype=self.D.dtype, device=self.D.device) + torch.einsum(
            "...i,...,...j->ij", self.V, 1 / self.D, self.V
        )

    @property
    def inv(self) -> DMLRCovariance:
        return DMLRCovariance(*_woodbury(self.D, self.V, self.K))

    def logdet(self) -> Tensor:
        return torch.log(self.D).sum() + torch.linalg.slogdet(self.K)[1]


class DMLRCovariance(Covariance):
    r"""Diagonal minus low-rank (DMLR) covariance matrix
    :math:`\mathrm{diag}(D) - V V^\top`, the inverse of a
    :class:`DPLRCovariance` and vice versa."""

    def __init__(self, D: Tensor, V: Tensor) -> None:
        self.D, self.V = D, V

    @property
    def shape(self) -> Sequence[int]:
        return self.D.shape

    @property
    def rank(self) -> int:
        return self.V.shape[-1]

    def __add__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return DMLRCovariance(self.D + other.lmbda, self.V)
        elif isinstance(other, DiagonalCovariance):
            return DMLRCovariance(self.D + other.D, self.V)
        elif isinstance(other, DMLRCovariance):
            return DMLRCovariance(self.D + other.D, torch.cat((self.V, other.V), dim=-1))
        else:
            return NotImplemented

    def __mul__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return DMLRCovariance(self.D * other.lmbda, self.V * _sqrt(other.lmbda))
        else:
            return NotImplemented

    def __matmul__(self, x: Tensor) -> Tensor:
        y = x.reshape(-1, *self.shape)
        y = self.D * y - torch.einsum("...i,ni->n...", self.V, torch.einsum("...i,n...->ni", self.V, y))
        return y.reshape(x.shape)

    def color(self, x: Tensor) -> Tensor:
        return _color_low_rank(self.D, self.V, x, -1)

    @property
    def K(self) -> Tensor:
        r"""The capacitance matrix :math:`K = I - V^\top D^{-1} V`."""

        return torch.eye(self.rank, dtype=self.D.dtype, device=self.D.device) - torch.einsum(
            "...i,...,...j->ij", self.V, 1 / self.D, self.V
        )

    @property
    def inv(self) -> DPLRCovariance:
        return DPLRCovariance(*_woodbury(self.D, self.V, self.K))

    def logdet(self) -> Tensor:
        return torch.log(self.D).sum() + torch.linalg.slogdet(self.K)[1]


def _sqrt(a: Tensor | float) -> Tensor | float:
    return torch.sqrt(a) if isinstance(a, Tensor) else math.sqrt(a)


def _woodbury(D: Tensor, V: Tensor, K: Tensor) -> tuple[Tensor, Tensor]:
    r"""The diagonal and low-rank factor of the inverse of
    :math:`\mathrm{diag}(D) \pm V V^\top`, with capacitance matrix :math:`K`."""

    D = 1 / D
    L, Q = torch.linalg.eigh(K)
    V = torch.einsum("...,...i,ij,j->...j", D, V, Q, 1 / torch.sqrt(L))

    return D, V


def _color_low_rank(D: Tensor, V: Tensor, x: Tensor, sign: int) -> Tensor:
    r"""A square root of :math:`\mathrm{diag}(D) \pm V V^\top` applied to `x`:
    :math:`D^{1/2} (I + U (\sqrt{1 \pm \Lambda} - 1) U^\top)` where
    :math:`U \Lambda U^\top` is the thin eigendecomposition of
    :math:`D^{-1/2} V V^\top D^{-1/2}`."""

    W = torch.einsum("...,...i->...i", torch.sqrt(1 / D), V)
    L, Q = torch.linalg.eigh(torch.einsum("...i,...j->ij", W, W))
    U = torch.einsum("...i,ij,j->...j", W, Q, 1 / torch.sqrt(L))

    y = x.reshape(-1, *D.shape)
    y = y + torch.einsum(
        "...i,i,ni->n...",
        U,
        torch.sqrt(1 + sign * L) - 1,
        torch.einsum("...i,n...->ni", U, y),
    )
    y = torch.sqrt(D) * y

    return y.reshape(x.shape)


class KroneckerCovariance(Covariance):
    r"""Kronecker-factorized covariance matrix.

    .. math:: C = (Q_1 \otimes \dots \otimes Q_n) \, L \, (Q_1 \otimes \dots \otimes Q_n)^\top

    where the :math:`Q_i` are per-axis orthonormal matrices and the inner
    :math:`L` is itself a (diagonal or DPLR) covariance.
    """

    def __init__(self, Qs: Sequence[Tensor], L: Covariance) -> None:
        self.Qs = tuple(Qs)
        self.L = L

    @property
    def shape(self) -> Sequence[int]:
        return tuple(Q.shape[0] for Q in self.Qs)

    @staticmethod
    def from_data(X: Tensor, rank: int = 0, iterations: int = 0) -> KroneckerCovariance:
        r"""Estimates per-axis eigenbases from the axis-marginal covariances,
        then fits the inner covariance on the data in the joint (Kronecker)
        eigenbasis: diagonal by default, DPLR when `rank > 0`."""

        axis_bases = []
        for axis in range(1, X.ndim):
            flat = torch.movedim(X, axis, -1).reshape(-1, X.shape[axis])
            _, Q = torch.linalg.eigh(torch.cov(flat.T))
            axis_bases.append(Q)

        # rotate the samples into the joint eigenbasis one axis at a time
        Y = X
        for axis, Q in enumerate(axis_bases, start=1):
            Y = torch.movedim(torch.movedim(Y, axis, -1) @ Q, -1, axis)

        if rank > 0 and len(axis_bases) > 1:
            L = DPLRCovariance.from_data(Y, rank=rank, iterations=iterations)
        else:
            L = DiagonalCovariance.from_data(Y)

        return KroneckerCovariance(axis_bases, L)

    def __add__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return KroneckerCovariance(self.Qs, self.L + other)
        else:
            return NotImplemented

    def __mul__(self, other: Covariance) -> Covariance:
        if isinstance(other, IsotropicCovariance):
            return KroneckerCovariance(self.Qs, self.L * other)
        else:
            return NotImplemented

    def _rotate(self, y: Tensor, synthesis: bool) -> Tensor:
        r"""Analysis (:math:`Q^\top y`) or synthesis (:math:`Q y`) along every axis."""

        abc = string.ascii_lowercase[: len(self.Qs)]
        ABC = abc.upper()
        src, dst = (ABC, abc) if synthesis else (abc, ABC)

        return torch.einsum(
            f"...{src}," + ",".join(f"{i}{i.upper()}" for i in abc) + f"->...{dst}",
            y,
            *self.Qs,
        )

    def __matmul__(self, x: Tensor) -> Tensor:
        y = x.reshape(-1, *self.shape)
        y = self._rotate(y, synthesis=False)
        y = self.L @ y
        y = self._rotate(y, synthesis=True)
        return y.reshape(x.shape)

    def color(self, x: Tensor) -> Tensor:
        y = x.reshape(-1, *self.shape)
        y = self.L.color(y)
        y = self._rotate(y, synthesis=True)
        return y.reshape(x.shape)

    @property
    def inv(self) -> KroneckerCovariance:
        return KroneckerCovariance(self.Qs, self.L.inv)

    def logdet(self) -> Tensor:
        return self.L.logdet()
