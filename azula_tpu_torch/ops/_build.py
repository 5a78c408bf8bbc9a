r"""Build and load of the hand-written CUDA kernels.

The sources under `azula_tpu_torch/csrc/` have a plain C interface. On first
use they are compiled for Hopper (`sm_90a`) with `nvcc`, one process per source
started together, and linked into one shared library under `build/` beside
the package. The library is named by a hash of the sources and flags, so an
edit rebuilds it. It is loaded with `ctypes`. What `ptxas -v` said of each
kernel (registers, spills, shared memory) is kept beside it
(:func:`ptxas_log`).

A missing `nvcc`, a failed build or a failed launch raises: no caller falls
back to a plain version. Two pairs of forward and backward kernels form
autograd functions with their own backward (`ops/attention.py`):
`_flash_blhd` (`flash_blhd_fwd.cu`, `flash_blhd_bwd.cu`) and `_flash`
(`attention_fwd.cu`'s LSE entry, `attention_bwd.cu`). `group_norm`,
`group_stats` and `conv3x3` are autograd functions whose backward is plain
PyTorch (the analytic GroupNorm and statistics gradients, the library
convolution's gradient), as the JAX package's custom vjps are XLA. The
wrappers of the kernels without a backward kernel are forward-only: called
directly, `forward_only` makes a backward through their launch raise.
"""

from __future__ import annotations

__all__ = [
    "LAUNCHES",
    "NVCC_FLAGS",
    "check",
    "forward_only",
    "library",
    "ptxas_log",
    "stream",
]

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import torch

from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Kernel launches by kernel name. Each wrapper adds one where it launches its
# kernel and nowhere else; `chip_smoke.py` clears this before the main path
# and reads it after. A backward entry counts once per call: `flash_blhd_bwd`
# and `attention_bwd` launch three kernels in bf16 (delta, the one-pass
# backward, dq's rounding) and two in float32 (dq, then dk/dv). The attention entries
# count each form under its own name: `attention_fwd_lse`,
# `attention_fwd_lse_bias`, `attention_fwd_lse_dropout`,
# `attention_fwd_lse_bias_dropout`, and so on. `conv3x3` also counts the
# launches of its tensor-core form under `conv3x3_tc`.
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_SIGNATURES = {
    # x, P, Q, y, partial, ab, B, HW, C, G, rows, eps, silu, dtype, stream
    "azula_group_norm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # x, partial, out, B, HW, C, G, rows, dtype, stream
    "azula_group_stats": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, w, y, B, H, W, C, K, dtype, stream
    "azula_conv3x3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # C, K, dtype: 1 where a call takes the tensor-core form
    "azula_conv3x3_tensor_cores": [_I, _I, _I],
    # the tensor-core form's shared memory per block
    "azula_conv3x3_tc_shared_bytes": [],
    # q, k, v, o, BH, L, D, scale, dtype, stream, then the mask arguments
    # bias, bias_div, bias_mod, seed, threshold, retain
    "azula_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _I, _I, _P, _I, _F],
    "azula_attention_fwd_max_free": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # q, k, v, o, lse, BH, L, D, scale, dtype, stream, mask arguments
    "azula_attention_fwd_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _I, _I, _P, _I, _F],
    # D, consumer warpgroups: the bf16 tensor-core forward's shared memory per block
    "azula_attention_fwd_tc_shared_bytes": [_I, _I],
    # q, k, v, o, g, lse, dq, dk, dv, delta, dq_acc, BH, L, D, scale, dtype,
    # stream, mask arguments
    "azula_attention_bwd": [_P] * 11 + [_I, _I, _I, _F, _I, _P, _P, _I, _I, _P, _I, _F],
    # D: the bf16 tensor-core backward's shared memory per block
    "azula_attention_bwd_tc_shared_bytes": [_I],
    # qkv, cos2, sin2, o, B, L, H, D, eps, has_eps, scale, dtype, stream
    "azula_fused_msa": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _I, _P],
    # D: the bf16 tensor-core form's shared memory per block
    "azula_fused_msa_tc_shared_bytes": [_I],
    # q, k, v, o, lse, B, L, H, D, scale, dtype, stream
    "azula_flash_blhd_fwd": [_P] * 5 + [_I, _I, _I, _I, _F, _I, _P],
    # D, consumer warpgroups: the bf16 tensor-core form's shared memory per block
    "azula_flash_blhd_fwd_tc_shared_bytes": [_I, _I],
    # q, k, v, o, g, lse, dq, dk, dv, delta, dq_acc, B, L, H, D, scale, dtype, stream
    "azula_flash_blhd_bwd": [_P] * 11 + [_I, _I, _I, _I, _F, _I, _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    nvcc = _nvcc()
    work = out.with_suffix(f".{os.getpid()}.tmp")
    work.mkdir(parents=True, exist_ok=True)
    try:
        _compile_and_link(nvcc, work, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _compile_and_link(nvcc: str, work: Path, out: Path) -> None:
    # one nvcc per source, all started together, then one link
    objects, procs = [], []
    for src in _sources():
        obj = work / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        objects.append(str(obj))

    errors, logs = [], []
    for src, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        logs.append(f"== {src.name}\n{log}")
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    _log_path(out).write_text("\n".join(logs))

    tmp = work / out.name
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *objects, "-o", str(tmp)],
        capture_output=True,
        text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed\n{link.stdout}{link.stderr}")

    os.replace(tmp, out)


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.log")


def _library_path() -> Path:
    return BUILD / f"libazula_kernels_{_digest()}.so"


def ptxas_log() -> str:
    r"""What `ptxas -v` printed while the kernel library was built, source by
    source (each kernel's registers, spill bytes and static shared memory)."""

    library()
    return _log_path(_library_path()).read_text()


def library() -> ctypes.CDLL:
    r"""Returns the kernel library, building it first if its sources changed."""

    global _lib

    with _lock:
        if _lib is None:
            out = _library_path()
            if not out.exists():
                BUILD.mkdir(parents=True, exist_ok=True)
                _build(out)

            lib = ctypes.CDLL(str(out))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.azula_error_string.argtypes = [ctypes.c_int]
            lib.azula_error_string.restype = ctypes.c_char_p
            _lib = lib

    return _lib


def check(status: int, name: str) -> None:
    r"""Raises if a kernel's C entry point returned a CUDA error."""

    if status != 0:
        msg = library().azula_error_string(status).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {status} ({msg})")


def stream(device: torch.device) -> int:
    r"""The handle of PyTorch's current CUDA stream on `device`."""

    return torch.cuda.current_stream(device).cuda_stream


class _ForwardOnly(torch.autograd.Function):
    r"""A kernel launch as a node of the autograd graph whose backward raises.

    The kernels write into fresh tensors through `ctypes`, which autograd
    does not see: without this node, a backward through a launch would run
    and give the kernel's inputs no gradient at all."""

    @staticmethod
    def forward(ctx, name, todo, launch, *args):
        ctx.name, ctx.todo = name, todo
        return launch(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"the {ctx.name} kernel has no backward yet ({ctx.todo}); "
            "call it under torch.no_grad() or torch.inference_mode()"
        )


def forward_only(name: str, todo: str):
    r"""Decorates a kernel wrapper, called with positional arguments only, so
    that a backward through its output raises `NotImplementedError` naming
    the ROADMAP item `todo`, instead of dropping its inputs' gradients."""

    def decorator(launch):
        @functools.wraps(launch)
        def wrapper(*args):
            return _ForwardOnly.apply(name, todo, launch, *args)

        return wrapper

    return decorator
