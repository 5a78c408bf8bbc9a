r"""The PyTorch port's linear algebra (`azula_tpu_torch.linalg`: `cg`, `gmres`
and the six covariances) and `GaussianDenoiser` against the JAX package's,
on the CPU, in float32.

`eigh` fixes its eigenvectors only up to sign, so covariances are compared
by their actions: `cov @ x`, `cov.inv @ x`, `logdet`, and `color` either on
an object built from JAX's own factors or through the Gram matrix of its
columns, :math:`M^\top M` with :math:`M` the colored identity, which no sign
changes. Test data have distinct eigenvalues and variances from 0.5 to 3:
on an ill-conditioned sample covariance float32 `eigh` moves both packages
far from float64 (ROADMAP's rounding differences). Every comparison is within
1e-4 of max |reference| (the solvers: within 1e-4 of max |reference| after
8 iterations of float32 recurrences on well-conditioned operators).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  one thread a process

from azula_tpu import denoise as jdenoise
from azula_tpu import noise as jnoise
from azula_tpu.linalg import covariance as jcov
from azula_tpu.linalg import solve as jsolve
from azula_tpu_torch import denoise as tdenoise
from azula_tpu_torch import noise as tnoise
from azula_tpu_torch.linalg import covariance as tcov
from azula_tpu_torch.linalg import solve as tsolve

from test_torch_samplers import _rel_err

TOL = 1e-4
EVENT = (4, 3)
DIM = 12


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _j(a: np.ndarray):
    return jnp.asarray(np.array(a, dtype=np.float32))


# solvers


def _operators(symmetric: bool, seed: int):
    r"""A batch of 3 well-conditioned 16 x 16 operators (eigenvalues in
    [1, 8]; non-symmetric ones a rotation of those), in both packages."""

    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((3, 16, 16)))[0]
    L = rng.uniform(1.0, 8.0, (3, 16))
    M = Q * L[:, None, :] @ np.swapaxes(Q, -1, -2)
    if not symmetric:
        M = M + 0.5 * rng.standard_normal((3, 16, 16))
    M = M.astype(np.float32)

    def jA(v):
        return jnp.einsum("...ij,...j->...i", jnp.asarray(M), v)

    def tA(v):
        return torch.einsum("...ij,...j->...i", torch.from_numpy(M), v)

    return jA, tA, M


@pytest.mark.parametrize("solver", ["cg", "gmres"])
@pytest.mark.parametrize("iterations", [1, 3, 8])
@pytest.mark.parametrize("warm", [False, True])
def test_solvers_match_jax(solver, iterations, warm):
    jA, tA, M = _operators(symmetric=solver == "cg", seed=iterations)
    rng = np.random.default_rng(10 + iterations)
    b = rng.standard_normal((3, 16)).astype(np.float32)
    x0 = rng.standard_normal((3, 16)).astype(np.float32) if warm else None

    want = getattr(jsolve, solver)(jA, _j(b), x0=None if x0 is None else _j(x0), iterations=iterations)
    got = getattr(tsolve, solver)(tA, _t(b), x0=None if x0 is None else _t(x0), iterations=iterations)

    assert got.dtype == torch.float32 and got.shape == (3, 16)
    assert _rel_err(got, want) <= TOL

    if iterations == 8 and solver == "cg":  # the solve converges (condition number 8)
        exact = np.linalg.solve(M.astype(np.float64), b[..., None].astype(np.float64))[..., 0]
        assert _rel_err(got, exact) <= 1e-2


def test_solvers_keep_the_callers_dtype():
    # the operator sees the caller's dtype, the recurrence runs in float32
    _, tA, _ = _operators(symmetric=True, seed=3)
    seen = []

    def A(v):
        seen.append(v.dtype)
        return tA(v.float()).to(v.dtype)

    b = torch.randn(3, 16).to(torch.bfloat16)
    for solver in (tsolve.cg, tsolve.gmres):
        x = solver(A, b, iterations=3)
        assert x.dtype == torch.bfloat16

    assert set(seen) == {torch.bfloat16}


# covariances from factors


def _orthonormal(n: int, rng) -> np.ndarray:
    return np.linalg.qr(rng.standard_normal((n, n)))[0]


def _factors(kind: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    if kind == "isotropic":
        return {"lmbda": np.float32(1.7)}
    if kind == "diagonal":
        return {"D": rng.uniform(0.5, 2.0, EVENT)}
    if kind == "full":
        return {"Q": _orthonormal(DIM, rng).reshape(*EVENT, DIM), "L": np.linspace(0.3, 3.0, DIM)}
    if kind == "dplr":
        return {"D": rng.uniform(0.5, 2.0, EVENT), "V": 0.7 * rng.standard_normal((*EVENT, 2))}
    if kind == "dmlr":
        return {"D": rng.uniform(2.0, 3.0, EVENT), "V": 0.3 * rng.standard_normal((*EVENT, 2))}
    if kind == "kronecker":
        return {"Qs": [_orthonormal(4, rng), _orthonormal(3, rng)], "D": rng.uniform(0.5, 2.0, EVENT)}
    raise ValueError(kind)


def _build(module, kind: str, f: dict, array):
    if kind == "isotropic":
        return module.IsotropicCovariance(array(f["lmbda"]))
    if kind == "diagonal":
        return module.DiagonalCovariance(array(f["D"]))
    if kind == "full":
        return module.FullCovariance(array(f["Q"]), array(f["L"]))
    if kind == "dplr":
        return module.DPLRCovariance(array(f["D"]), array(f["V"]))
    if kind == "dmlr":
        return module.DMLRCovariance(array(f["D"]), array(f["V"]))
    if kind == "kronecker":
        return module.KroneckerCovariance([array(Q) for Q in f["Qs"]], module.DiagonalCovariance(array(f["D"])))
    raise ValueError(kind)


KINDS = ["isotropic", "diagonal", "full", "dplr", "dmlr", "kronecker"]


def _pair(kind: str, seed: int = 0):
    f = _factors(kind, seed)
    return _build(jcov, kind, f, _j), _build(tcov, kind, f, _t)


def _xs(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((5, *EVENT)).astype(np.float32)


def _compare(jc, tc, x: np.ndarray, logdet: bool = True) -> None:
    assert _rel_err(tc @ _t(x), jc @ _j(x)) <= TOL
    assert _rel_err(tc(_t(x)), jc(_j(x))) <= TOL
    assert _rel_err(tc.inv @ _t(x), jc.inv @ _j(x)) <= TOL
    if logdet:
        assert _rel_err(tc.logdet(), jc.logdet()) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_covariance_actions_match_jax(kind):
    jc, tc = _pair(kind)
    x = _xs()

    _compare(jc, tc, x, logdet=kind != "isotropic")
    assert _rel_err(tc.color(_t(x)), jc.color(_j(x))) <= TOL

    if kind == "isotropic":
        with pytest.raises(NotImplementedError):
            tc.logdet()
        with pytest.raises(NotImplementedError):
            tc.shape
    else:
        assert tuple(tc.shape) == tuple(jc.shape) == EVENT


@pytest.mark.parametrize("kind", KINDS)
def test_covariance_algebra_matches_jax(kind):
    jc, tc = _pair(kind)
    x = _xs(2)

    # sums and products with isotropic terms, from either side
    _compare(jc + jcov.IsotropicCovariance(0.3), tc + tcov.IsotropicCovariance(0.3), x, kind != "isotropic")
    _compare(jcov.IsotropicCovariance(0.3) + jc, tcov.IsotropicCovariance(0.3) + tc, x, kind != "isotropic")
    _compare(jc * jcov.IsotropicCovariance(2.5), tc * tcov.IsotropicCovariance(2.5), x, kind != "isotropic")
    _compare(
        jcov.IsotropicCovariance(_j(2.5)) * jc, tcov.IsotropicCovariance(_t(2.5)) * tc, x, kind != "isotropic"
    )

    # the inverse of an inverse, and of a sum (JFPS's (C^-1 + I/r)^-1)
    _compare(jc.inv.inv, tc.inv.inv, x, kind != "isotropic")
    _compare(
        (jc.inv + jcov.IsotropicCovariance(0.5)).inv,
        (tc.inv + tcov.IsotropicCovariance(0.5)).inv,
        x,
        kind != "isotropic",
    )


@pytest.mark.parametrize(
    "left, right",
    [("diagonal", "diagonal"), ("dplr", "diagonal"), ("dplr", "dplr"), ("dmlr", "diagonal"), ("dmlr", "dmlr")],
)
def test_structured_sums_match_jax(left, right):
    jl, tl = _pair(left, seed=3)
    jr, tr = _pair(right, seed=4)
    if right == "dmlr":  # keep D - V V^T positive
        jr, tr = _pair("dmlr", seed=5)

    _compare(jl + jr, tl + tr, _xs(3))


def test_covariances_run_in_the_factors_dtype():
    f = _factors("dplr")
    c = _build(tcov, "dplr", f, lambda a: torch.from_numpy(np.array(a, dtype=np.float64)))
    y = c.inv @ torch.randn(5, *EVENT, dtype=torch.float64)

    assert y.dtype == torch.float64 and c.logdet().dtype == torch.float64


# covariances from data


def _data(count: int, seed: int) -> np.ndarray:
    r"""Samples of N(0.5, Q diag(s) Q^T) with distinct variances s in [0.5, 3]."""

    rng = np.random.default_rng(seed)
    mix = np.sqrt(np.linspace(0.5, 3.0, DIM))[:, None] * _orthonormal(DIM, rng).T
    return (rng.standard_normal((count, DIM)) @ mix + 0.5).reshape(count, *EVENT).astype(np.float32)


def _gram(c, module, array) -> np.ndarray:
    r""":math:`M^\top M` for the colored identity :math:`M`: the covariance,
    whatever signs `eigh` chose."""

    eye = array(np.eye(DIM).reshape(DIM, *EVENT))
    M = np.asarray(c.color(eye) if module is jcov else c.color(eye).numpy(), np.float64).reshape(DIM, DIM)
    return M.T @ M


FROM_DATA = {
    "isotropic": lambda m, X: m.IsotropicCovariance.from_data(X),
    "diagonal": lambda m, X: m.DiagonalCovariance.from_data(X),
    "full": lambda m, X: m.FullCovariance.from_data(X),
    "dplr": lambda m, X: m.DPLRCovariance.from_data(X, rank=2),
    "dplr_em": lambda m, X: m.DPLRCovariance.from_data(X, rank=2, iterations=3),
    "kronecker": lambda m, X: m.KroneckerCovariance.from_data(X),
    "kronecker_dplr": lambda m, X: m.KroneckerCovariance.from_data(X, rank=2, iterations=2),
}


@pytest.mark.parametrize(
    "name, count",
    # 64 samples and 8, fewer than the 12 features (DPLR's sample-space
    # branch), where a full-rank estimate cannot be made
    [(name, count) for name in FROM_DATA for count in (64, 8) if not (name == "full" and count < DIM)],
)
def test_from_data_matches_jax(name, count):
    X = _data(count, seed=count)
    jc = FROM_DATA[name](jcov, _j(X))
    tc = FROM_DATA[name](tcov, _t(X))
    assert type(tc).__name__ == type(jc).__name__

    _compare(jc, tc, _xs(4), logdet=name != "isotropic")

    if name != "isotropic":
        assert _rel_err(_gram(tc, tcov, _t), _gram(jc, jcov, _j)) <= TOL
        # and the Gram matrix is the covariance itself
        C = tc @ _t(np.eye(DIM).reshape(DIM, *EVENT))
        assert _rel_err(C.reshape(DIM, DIM), _gram(tc, tcov, _t)) <= TOL


# GaussianDenoiser


@pytest.mark.parametrize("kind", ["isotropic", "diagonal", "full", "dplr", "kronecker"])
def test_gaussian_denoiser_matches_jax(kind):
    jc, tc = _pair(kind)
    mean = np.random.default_rng(6).standard_normal(EVENT)
    jd = jdenoise.GaussianDenoiser(_j(mean), jc, jnoise.VPSchedule())
    td = tdenoise.GaussianDenoiser(_t(mean), tc, tnoise.VPSchedule())

    x = _xs(7)
    for t in (0.05, 0.5, 0.95):
        want = jd(_j(x), jnp.float32(t)).mean
        got = td(_t(x), torch.tensor(t)).mean

        assert got.dtype == torch.float32 and got.shape == x.shape
        assert _rel_err(got, want) <= TOL
