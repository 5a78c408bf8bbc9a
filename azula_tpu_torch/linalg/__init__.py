r"""Linear algebra: structured covariances and batched iterative solvers.

Port of :mod:`azula_tpu.linalg`: the :class:`~azula_tpu_torch.linalg.covariance.Covariance`
family and the fixed-iteration :func:`~azula_tpu_torch.linalg.solve.cg` and
:func:`~azula_tpu_torch.linalg.solve.gmres` solvers, on tensors.
"""

from . import covariance, solve  # noqa: F401
from .covariance import (  # noqa: F401
    Covariance,
    DiagonalCovariance,
    DMLRCovariance,
    DPLRCovariance,
    FullCovariance,
    IsotropicCovariance,
    KroneckerCovariance,
)
from .solve import cg, gmres  # noqa: F401
