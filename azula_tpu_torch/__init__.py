r"""Azula-TPU ported to PyTorch and CUDA for the NVIDIA H100.

The counterpart of :mod:`azula_tpu`, slice by slice: noise schedules,
denoisers and their training losses, samplers, structured covariances and
Krylov solvers, guidance, training utilities, the ADM model family, the
UNet and the DiT / ViT and Flux transformer backbones, with the Pallas
kernels of the JAX package replaced by hand-written CUDA kernels (`csrc/`). Images are
channels-last (B, H, W, C) and attention is (B, H, L, D), as in the JAX
package. Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from . import (  # noqa: F401
    debug,
    denoise,
    guidance,
    hub,
    linalg,
    nn,
    noise,
    ops,
    parallel,
    sample,
    train,
)
