#!/usr/bin/env python3
r"""Smoke test of the PyTorch port (`azula_tpu_torch`) on one NVIDIA card.

Run from the root of the repository, on a machine with an H100:

    python3 chip_smoke.py [--steps 64]

Phases, each of which raises on failure:

1. device: require CUDA; print the card's name and power limit; turn TF32 off
   for the float32 checks.
2. build: compile the CUDA kernels from `azula_tpu_torch/csrc` and load them.
3. kernels: record the kernel calls of one full-width forward (ADM
   `imagenet_256x256`, bf16, batch 8), then hold each kernel against its plain
   PyTorch version on the card at every recorded shape, in bf16 and float32,
   and time kernel, plain version, library call and bound.
4. slice: the tiny ADM of the CPU tests, same random weights, on the CPU
   (plain versions) and on the card (kernels), float32: the denoiser's output
   and a 4-step DDIM trajectory.
5. full width: DDIM-64 (eta = 0) from `sampler.init` noise at batch 8 through
   the full-width model; the result must be finite and the kernel launch
   counts exact. Prints images/s, peak memory and a profile of one step.
6. the kernels line `{"kernels": [...]}`, then the result line.

The last line of standard output is the JSON result
`{"ok": true, "device": {...}}`; nothing is printed there unless every phase
passed.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from azula_tpu_torch.models import adm
from azula_tpu_torch.models.utils import load_cards
from azula_tpu_torch.ops import _build, attention, norm
from azula_tpu_torch.sample import DDIMSampler

# H100 SXM peaks (NVIDIA data sheet, dense): device memory, bf16 tensor cores,
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

BATCH = 8
GROUPS = 32

# per forward of imagenet_256x256 (42 ResBlocks, 16 attention blocks): two
# fused GroupNorm + SiLU per ResBlock (the skip concatenation runs as one
# GroupNorm), one GroupNorm before each attention block and the final
# `out_norm`, whose SiLU runs after it, unfused, as in the JAX package
CALLS_PER_FORWARD = {"group_norm_silu": 84, "group_norm": 17, "attention_fwd": 16}

# tolerances, as max |kernel - plain| / max |plain|
TOL_GN = {
    # same float32 arithmetic, summed in another order
    torch.float32: 1e-5,
    # plus one rounding of the bf16 output (2^-8) where a value lies on the edge
    torch.bfloat16: 1e-2,
}
TOL_ATTN = {
    torch.float32: 1e-5,
    # the plain version rounds the exp-weights to bf16 before the value product
    # (as the JAX package does); the kernel keeps them in float32
    torch.bfloat16: 2e-2,
}
# |mean| / std = 1e4 in float32: the rounding of x itself (ulp(1e4) ~ 1e-3)
# passes through x * A + B on both sides; absolute, on outputs of order 1
TOL_GN_LARGE_MEAN = 5e-3
# the tiny slice, card against CPU, float32: conv and matmul sums in other
# orders through a few dozen layers
TOL_SLICE = 1e-4
# a trajectory carries those differences through c_out = -sigma / alpha
# (100 at t = 1) before the clip
TOL_TRAJECTORY = 5e-4

TINY = dict(  # noqa: C408  the tiny ADM of tests/test_torch_adm.py, with the card's flags
    image_size=32,
    num_channels=32,
    num_res_blocks=1,
    channel_mult=(1, 2),
    attention_resolutions=(16, 8),
    num_head_channels=32,
    resblock_updown=True,
    use_scale_shift_norm=True,
)


def log(*args) -> None:
    print(*args, flush=True)


def elapsed_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    r"""Median time of `fn` on the card over `reps` runs, by CUDA events."""

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()

    return statistics.median(s.elapsed_time(e) for s, e in events)


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    r"""(max abs error, max abs error / max |want|), in float64."""

    if not bool(torch.isfinite(got).all()):
        raise AssertionError("the kernel's output is not finite")
    diff = (got.double() - want.double()).abs().max().item()
    return diff, diff / max(want.double().abs().max().item(), 1e-30)


def bound_ms(nbytes: float, ops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def recording():
    r"""Records the kernel calls (shape, dtype, flags and one set of affine
    inputs per distinct call) that the main path makes while it is active."""

    calls = collections.Counter()
    affine = {}
    modulated = [False]
    compose, gn_kernel, attn_kernel = norm._compose_affine, norm._group_norm_kernel, attention._attention_kernel

    def compose_affine(x, groups, scale, bias, mod_scale, mod_shift):
        # every GroupNorm call composes its affine just before the kernel
        modulated[0] = mod_scale is not None or mod_shift is not None
        return compose(x, groups, scale, bias, mod_scale, mod_shift)

    def gn(x, P, Q, groups, eps, silu):
        key = ("gn", tuple(x.shape), x.dtype, groups, silu, modulated[0])
        calls[key] += 1
        affine.setdefault(key, (P.clone(), Q.clone(), eps))
        return gn_kernel(x, P, Q, groups, eps, silu)

    def attn(q, k, v, scale):
        calls[("attn", tuple(q.shape), q.dtype, scale)] += 1
        return attn_kernel(q, k, v, scale)

    norm._compose_affine, norm._group_norm_kernel, attention._attention_kernel = compose_affine, gn, attn
    try:
        yield calls, affine
    finally:
        norm._compose_affine, norm._group_norm_kernel, attention._attention_kernel = compose, gn_kernel, attn_kernel


def full_width_model(generator: torch.Generator):
    r"""The imagenet_256x256 ADM denoiser with random bf16 weights: every
    layer that the backbone zero-initializes is drawn like the others."""

    card = load_cards(adm)["imagenet_256x256"]
    denoiser = adm.make_model(**card.config, device="cuda", generator=generator)

    backbone = denoiser.backbone
    zeroed = [backbone.out_conv]
    for module in backbone.modules():
        if isinstance(module, adm.backbone.ADMResBlock):
            zeroed.append(module.out_conv)
        elif isinstance(module, adm.backbone.ADMAttentionBlock):
            zeroed.append(module.proj)

    with torch.no_grad():
        for layer in zeroed:
            bound = 1 / math.sqrt(layer.weight[0].numel())
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)

    backbone.to(torch.bfloat16)

    return denoiser


def check_group_norm(calls, affine, generator) -> dict:
    r"""Each recorded GroupNorm call against the plain version, in bf16 (the
    main path's dtype, timed) and float32; plus a large-mean input."""

    per_kernel = {
        name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0, max_err=0.0,
                   bound_by=collections.Counter())
        for name in ("group_norm_silu", "group_norm")
    }

    keys = sorted((k for k in calls if k[0] == "gn"), key=lambda k: (k[4], k[5], k[1]))
    for key in keys:
        _, shape, dtype, groups, silu, modulated = key
        P, Q, eps = affine[key]
        name = "group_norm_silu" if silu else "group_norm"
        entry = per_kernel[name]
        count = calls[key]

        for check_dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=generator, device="cuda") * 2 + 0.5).to(check_dtype)
            got = norm._group_norm_kernel(x, P, Q, groups, eps, silu)
            want = norm._group_norm_plain(x, P, Q, groups, eps, silu)
            abs_err, rel_err = errors(got, want)
            if rel_err > TOL_GN[check_dtype]:
                raise AssertionError(f"group norm {shape} {check_dtype} silu={silu}: {rel_err} > {TOL_GN[check_dtype]}")

            line = (
                f"  group_norm {shape} {str(check_dtype)[6:]} silu={silu} mod={modulated} x{count}/fwd: "
                f"max abs err {abs_err:.3e}, rel {rel_err:.3e} (tol {TOL_GN[check_dtype]})"
            )

            if check_dtype == dtype:  # the main path's dtype: time it
                ms = elapsed_ms(lambda: norm._group_norm_kernel(x, P, Q, groups, eps, silu))
                plain = elapsed_ms(lambda: norm._group_norm_plain(x, P, Q, groups, eps, silu))
                nbytes = 2 * x.numel() * x.element_size() + 2 * P.numel() * 4
                ops = x.numel() * (5 + (4 if silu else 0))
                bound, by = bound_ms(nbytes, ops, dtype)
                entry["bound_by"][by] += count * bound

                library = None
                if not silu and not modulated:
                    x_nchw = x.transpose(1, 2).contiguous()  # the library's own layout
                    library = elapsed_ms(
                        lambda: F.group_norm(x_nchw, groups, P[0].to(dtype), Q[0].to(dtype), eps)
                    )
                    entry["library_ms"] += count * library

                entry["ms"] += count * ms
                entry["plain_ms"] += count * plain
                entry["bound_ms"] += count * bound
                entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
                entry["max_err"] = max(entry["max_err"], rel_err)
                line += f"; {ms:.4f} ms, plain {plain:.4f} ms, library {library} ms, bound {bound:.4f} ms ({by})"

            log(line)

    # off the main path: modulation without SiLU, and |mean| / std = 1e4
    B, C = 8, 512
    s = torch.randn(B, C, generator=generator, device="cuda") * 0.3
    P, Q = (1 + s).contiguous(), (0.5 * s).contiguous()
    x = torch.randn((B, 1024, C), generator=generator, device="cuda").to(torch.bfloat16)
    abs_err, rel_err = errors(norm._group_norm_kernel(x, P, Q, GROUPS, 1e-5, False), norm._group_norm_plain(x, P, Q, GROUPS, 1e-5, False))
    if rel_err > TOL_GN[torch.bfloat16]:
        raise AssertionError(f"group norm, modulation without SiLU: {rel_err}")
    log(f"  group_norm (8, 1024, 512) bfloat16 silu=False mod=True: rel err {rel_err:.3e} (tol {TOL_GN[torch.bfloat16]})")

    for silu in (False, True):
        x = torch.randn((B, 4096, C), generator=generator, device="cuda") + 1e4
        got = norm._group_norm_kernel(x, P, Q, GROUPS, 1e-5, silu)
        want = norm._group_norm_plain(x, P, Q, GROUPS, 1e-5, silu)
        abs_err, _ = errors(got, want)
        if abs_err > TOL_GN_LARGE_MEAN or want.abs().max().item() < 0.5:
            raise AssertionError(f"group norm at |mean|/std = 1e4: abs err {abs_err}")
        log(f"  group_norm |mean|/std=1e4 float32 silu={silu}: max abs err {abs_err:.3e} (tol {TOL_GN_LARGE_MEAN})")

    return per_kernel


def check_attention(calls, generator) -> dict:
    r"""The attention kernel against the plain version at the recorded shapes
    (timed, with SDPA as the library yardstick) and at a ragged length and
    the other head dims, in bf16 and float32."""

    entry = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0, max_err=0.0,
                 bound_by=collections.Counter())

    recorded = {k[1]: (calls[k], k[3]) for k in calls if k[0] == "attn"}
    extra = {(8, 16, 100, 64): (0, 0.125), (4, 8, 256, 32): (0, 32**-0.5), (2, 4, 200, 128): (0, 128**-0.5)}

    for shape, (count, scale) in sorted({**recorded, **extra}.items()):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=generator, device="cuda").to(dtype) for _ in range(3))
            got = attention._attention_kernel(q, k, v, scale)
            want = attention._attention_plain(q, k, v, scale=scale)
            abs_err, rel_err = errors(got, want)
            if rel_err > TOL_ATTN[dtype]:
                raise AssertionError(f"attention {shape} {dtype}: {rel_err} > {TOL_ATTN[dtype]}")

            line = f"  attention {shape} {str(dtype)[6:]} x{count}/fwd: max abs err {abs_err:.3e}, rel {rel_err:.3e} (tol {TOL_ATTN[dtype]})"

            if count and dtype == torch.bfloat16:
                ms = elapsed_ms(lambda: attention._attention_kernel(q, k, v, scale))
                plain = elapsed_ms(lambda: attention._attention_plain(q, k, v, scale=scale))
                library = elapsed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
                B, H, L, D = shape
                bound, by = bound_ms(4 * q.numel() * q.element_size(), 4 * B * H * L * L * D, dtype)
                entry["bound_by"][by] += count * bound

                entry["ms"] += count * ms
                entry["plain_ms"] += count * plain
                entry["library_ms"] += count * library
                entry["bound_ms"] += count * bound
                entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
                entry["max_err"] = max(entry["max_err"], rel_err)
                line += f"; {ms:.4f} ms, plain {plain:.4f} ms, SDPA {library:.4f} ms, bound {bound:.4f} ms ({by})"

            log(line)

    return entry


def check_slice() -> None:
    r"""The tiny ADM on the CPU (plain versions) and on the card (kernels),
    with the same random weights, in float32."""

    rng = np.random.default_rng(0)
    cpu = adm.make_model(**TINY, device="cpu")
    state = {}
    for key, value in cpu.backbone.state_dict().items():
        if key.endswith("norm.weight"):
            array = 1 + 0.2 * rng.standard_normal(value.shape)
        elif value.ndim == 1:
            array = 0.2 * rng.standard_normal(value.shape)
        else:
            array = rng.standard_normal(value.shape) / math.sqrt(value[0].numel())
        state[key] = torch.from_numpy(array.astype(np.float32))
    cpu.backbone.load_state_dict(state)

    card = adm.make_model(**TINY, device="cuda")
    card.backbone.load_state_dict(state)

    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))

    _build.LAUNCHES.clear()
    with torch.inference_mode():
        for t in (0.3, 0.9):
            before = dict(_build.LAUNCHES)
            want = cpu(x, torch.tensor(t))
            if dict(_build.LAUNCHES) != before:
                raise AssertionError("a kernel ran on the CPU path")
            got = card(x.cuda(), torch.tensor(t, device="cuda"))

            alpha, sigma = cpu.schedule(torch.tensor(t))
            _, mean_err = errors(got.mean.cpu(), want.mean)
            _, var_err = errors(got.var.cpu(), want.var)
            # the mean amplifies the backbone's difference by sigma / alpha
            tol = TOL_SLICE * max(1.0, float(sigma / alpha))
            log(f"  denoiser t={t}: mean rel err {mean_err:.3e} (tol {tol:.1e}), var rel err {var_err:.3e} (tol {TOL_SLICE})")
            if mean_err > tol or var_err > TOL_SLICE:
                raise AssertionError("the tiny denoiser on the card disagrees with the CPU")

        want = DDIMSampler(cpu, steps=4)(x)
        got = DDIMSampler(card, steps=4)(x.cuda())
        _, err = errors(got.cpu(), want)
        log(f"  DDIM-4 trajectory: rel err {err:.3e} (tol {TOL_TRAJECTORY})")
        if err > TOL_TRAJECTORY:
            raise AssertionError("the tiny DDIM trajectory on the card disagrees with the CPU")

    launched = dict(_build.LAUNCHES)
    log(f"  kernel launches on the card: {launched}")
    if set(launched) != set(CALLS_PER_FORWARD) or min(launched.values()) == 0:
        raise AssertionError("the card path did not run every kernel")


def profile_step(sampler, x, t, s) -> None:
    r"""Device time of one full-width DDIM step by kind of kernel, and the
    share of the step's wall time in which the card ran no kernel."""

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.step(x, t, s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kinds, top = collections.Counter(), collections.Counter()
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0)
        if not us or event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = event.key
        top[name] += us / 1e3
        if "gn_partial_kernel" in name or "gn_fold_kernel" in name or "gn_apply_kernel" in name:
            kind = "group_norm (ours)"
        elif "attention_fwd_kernel" in name:
            kind = "attention (ours)"
        elif "conv" in name.lower() or "xmma" in name or "implicit" in name or "nhwc" in name.lower():
            kind = "convolution (cuDNN)"
        elif "gemm" in name.lower() or "cutlass" in name.lower():
            kind = "matmul (cuBLAS)"
        else:
            kind = "other (elementwise, copies, reductions)"
        kinds[kind] += us / 1e3

    busy = sum(kinds.values())
    if not busy:
        log("profile: the profiler saw no device time (not measured)")
        return
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in kinds.most_common())
    log(f"profile of one step: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}); {parts}")
    for name, ms in top.most_common(12):
        log(f"  {ms:9.3f} ms  {name[:150]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=64, help="DDIM steps of the full-width run")
    args = parser.parse_args()

    log("== 1. device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 2. build")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    log("== 3. kernels against their plain versions at the main path's shapes")
    generator = torch.Generator(device="cuda").manual_seed(0)
    denoiser = full_width_model(generator)
    sampler = DDIMSampler(denoiser, eta=0.0, steps=args.steps)
    x = sampler.init((BATCH, 256, 256, 3), generator=generator)

    with torch.inference_mode(), recording() as (calls, affine):
        denoiser(x, sampler.timesteps[0].cuda())
    recorded = collections.Counter()
    for key, count in calls.items():
        recorded["attention_fwd" if key[0] == "attn" else "group_norm_silu" if key[4] else "group_norm"] += count
    log(f"calls in one full-width forward: {dict(recorded)}")
    if dict(recorded) != CALLS_PER_FORWARD:
        raise AssertionError(f"expected {CALLS_PER_FORWARD} calls per forward")

    with torch.inference_mode():
        gn = check_group_norm(calls, affine, generator)
        at = check_attention(calls, generator)

    log("== 4. the tiny slice: CPU plain versions against the card's kernels, float32")
    check_slice()

    log(f"== 5. full width: imagenet_256x256, bf16, batch {BATCH}, DDIM-{args.steps}")
    if args.steps != 64:
        log(f"steps cut from 64 to {args.steps}")
    with torch.inference_mode():
        time_grid = sampler.timesteps.cuda()
        sampler.step(x, time_grid[0], time_grid[1])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        y = sampler(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)

    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(y).all()) or y.shape != x.shape:
        raise AssertionError("the full-width trajectory is not finite")
    expected = {name: n * args.steps for name, n in CALLS_PER_FORWARD.items()}
    log(f"launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError("the main path's launch counts are not exact")
    log(f"trajectory {seconds:.3f} s, {BATCH / seconds:.4f} images/s, {seconds / args.steps * 1e3:.2f} ms/step, "
        f"peak memory {peak / 2**30:.2f} GiB; sample mean {y.float().mean().item():.4f}, std {y.float().std().item():.4f}")
    with torch.inference_mode():
        profile_step(sampler, x, time_grid[0], time_grid[1])

    log("== 6. result")
    kernels = []
    for name, entry in (
        ("group_norm_silu", gn["group_norm_silu"]),
        ("group_norm", gn["group_norm"]),
        ("attention_fwd", at),
    ):
        source = "azula_tpu_torch/csrc/attention_fwd.cu" if name == "attention_fwd" else "azula_tpu_torch/csrc/group_norm.cu"
        replaces = (
            "azula_tpu/ops/attention.py:92 (_pallas_attention), azula_tpu/ops/attention.py:566 (_pallas_attention_batched)"
            if name == "attention_fwd"
            else "azula_tpu/ops/norm.py:463 (_gn_fused_tpu)"
        )
        tol = TOL_ATTN[torch.bfloat16] if name == "attention_fwd" else TOL_GN[torch.bfloat16]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": entry["max_abs_err"],
            "max_err": entry["max_err"],
            "tol": tol,
            # times of the calls of one forward, summed over their shapes
            "ms": entry["ms"],
            "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"],
            # what bounds the larger share of bound_ms
            "bound_by": entry["bound_by"].most_common(1)[0][0],
            "library_ms": entry["library_ms"] if name != "group_norm_silu" else None,
            "calls_per_forward": CALLS_PER_FORWARD[name],
        })

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
