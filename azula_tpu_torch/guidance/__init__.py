r"""Guidance and posterior sampling.

Port of :mod:`azula_tpu.guidance`. Two patterns:

- **denoiser wrappers** that transform the posterior mean (CFG, DiffPIR,
  JFPS, MMPS, TMPD) and forward the inner schedule;
- **sampler subclasses** that modify the reverse step (DPS, PGDM, RePaint,
  TDS).

Where the JAX package takes `jax.vjp` or `jax.value_and_grad` through the
denoiser (MMPS, DPS, PGDM, TMPD, TDS), the port opens a `torch.enable_grad()`
island around a detached `x_t` that requires grad, so a sampler may run
under `torch.no_grad()`; under `torch.inference_mode()`, where autograd
cannot run, these methods raise. Products through the forward operator `A`
alone are `torch.autograd.grad` (its transpose) and `torch.func.jvp`.
"""

from .cfg import CFGDenoiser  # noqa: F401
from .diffpir import DiffPIRDenoiser  # noqa: F401
from .dps import DPSSampler  # noqa: F401
from .jfps import JFPSDenoiser  # noqa: F401
from .mmps import MMPSDenoiser  # noqa: F401
from .pgdm import PGDMSampler  # noqa: F401
from .repaint import RePaintSampler  # noqa: F401
from .tds import TDSSampler  # noqa: F401
from .tmpd import TMPDenoiser  # noqa: F401
