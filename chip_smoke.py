#!/usr/bin/env python3
r"""Smoke test of the PyTorch port (`azula_tpu_torch`) on one NVIDIA card.

Run from the root of the repository, on a machine with an H100:

    python3 chip_smoke.py [--steps 64]

Phases, each of which raises on failure:

1. device: require CUDA; print the card's name and power limit; turn TF32 off
   for the float32 checks.
2. build: compile the CUDA kernels from `azula_tpu_torch/csrc` and load them;
   print what `ptxas -v` said of the bf16 tensor-core attention forward and
   backward (registers and spills of each form, shared memory per block,
   per D), of the backward's delta and dq-rounding kernels, of the bf16
   tensor-core forms of fused MSA (per D) and conv3x3, and of the bf16
   `_flash_blhd` pair (the forward per D and warpgroups, the backward per
   D with its delta and dq-rounding kernels).
3. kernels: record the kernel calls of one full-width forward (ADM
   `imagenet_256x256`, bf16, batch 8), then hold each kernel against its plain
   PyTorch version on the card at every recorded shape, in bf16 and float32,
   and time kernel, plain version, library call and bound. The bf16
   attention calls (the tensor-core forward) are also held against
   `_attention_tiled_plain`, their own rounding points, at `TOL_TC`, and
   print TFLOP/s and their share of the bound.
4. slice: the tiny ADM of the CPU tests, same random weights, on the CPU
   (plain versions) and on the card (kernels), float32: the denoiser's output
   and a 4-step DDIM trajectory.
5. full width: DDIM-64 (eta = 0) from `sampler.init` noise at batch 8 through
   the full-width model; the result must be finite and the kernel launch
   counts exact. Prints images/s, peak memory and a profile of one step.
6. dit32 kernels: record the fused MSA calls of one full-width dit32 forward
   (`Modulated(ViT)` under `KarrasDenoiser(VPSchedule())`, bf16, batch 128,
   random weights), which must be exactly 12 with no other kernel, then hold
   the kernel against its plain version at that shape in bf16 (the
   tensor-core form) and float32 (the CUDA-core form), also with RoPE,
   without the QK-norm and at scale 1, at heads of 128, 192 and 256 and at a
   ragged length; each bf16 case also against `_fused_msa_tiled_plain`, its
   own rounding points, at `TOL_TC`; and time kernel, plain version, SDPA on
   the attention core and bound, with TFLOP/s and the share of the bound,
   and the kernel without the preparation (eps=None).
   Under grad, a
   backward through `fused_msa_attention` must succeed (it takes the flash
   route of phase 9), and so must one through `dot_product_attention`, with
   and without `max_free` (the LSE forward and backward kernels of phase
   16), and one through `group_norm` and `group_norm_silu` (the GroupNorm
   and statistics kernels, the analytic backward of phase 23), while one
   through the GroupNorm, attention or max-free attention kernel called
   directly, or through the serving fused MSA kernel called directly, must
   raise.
7. dit32 slices: the tiny ViT denoiser of the CPU tests (8 x 8 images, which
   takes the unfused route) and one of 32 x 32 images (256 tokens, two heads
   of 64, the fused route), each with the same random weights on the CPU
   (plain versions) and on the card (kernels), float32, with RoPE on and off:
   the denoiser's output and a 4-step DDIM trajectory.
8. dit32 full width: DDIM-64 (eta = 0) from `sampler.init` noise at batch
   128 in bf16; the result must be finite and the launch count exactly
   12 per step. Prints images/s, peak memory and a profile of one step.
9. flash kernels: the `_flash_blhd` forward and backward kernels against
   their plain versions at the dit32 training shape ((128, 256, 384), 6 heads
   of 64, scale 1/8) in bf16 and float32 (o, and dq, dk, dv for a random
   cotangent), and at ragged L, L <= 64 and the other head dims; in bf16
   (the tensor-core forward and one-pass backward on the heads in place)
   also o and lse against `_flash_blhd_tiled_plain` at `TOL_TC` and dq, dk,
   dv against `_flash_blhd_bwd_tiled_plain`'s float32 sums at `TOL_BWD_TC`;
   timed against the plain versions, SDPA (forward, and its autograd
   backward) and the bound, with TFLOP/s and the share of the bound.
10. composition gradient: the gradient of `fused_msa_attention` at the dit32
   shape with RoPE, bf16, through the flash route's kernels, against the
   gradient through the plain version (the JAX package's gate, rel < 3e-2).
11. training slice: the 32 x 32 ViT of phase 7 on the CPU (plain versions)
   and on the card (the flash kernels), float32, same weights and injected
   noise: the loss and every parameter's gradient of one step, then the
   parameters after three AdamW steps.
12. dit32 training at full width: `bench.py`'s dit32_train (bf16 model, batch
   128, fixed x and t, fresh noise every step, AdamW with optax's settings)
   through `TrainState.step`: warm-up steps, then timed steps with finite
   losses and exactly 12 + 12 flash launches per step and no other kernel.
   Prints train images/s, ms/step, peak memory and a profile of one step.
13. max-free attention: the max-free flash kernel against its plain version
   at the FLUX.1 shapes (1, 24, 4608, 128), row 5's route, and
   (1, 24, 1536, 128), row 3's, in bf16 (also against
   `_attention_tiled_plain` at `TOL_TC`); in float32; at a ragged L called
   directly; and with logits above the clamp at 80. Timed against the plain
   version, SDPA (the exact softmax, which equals the max-free function while
   the logits stay under 80) and the bound, with TFLOP/s and the share of
   the bound.
14. the tiny Flux slice: a small `FluxTransformer` (2 heads of 64, 24 x 24
   latents and 64 text tokens: L = 640, the max-free route) under
   `FluxDenoiser`, same random weights on the CPU (plain versions) and on the
   card, float32: the denoiser's output, a 4-step DDIM trajectory and exact
   launch counts.
15. FLUX.1-dev at full width and depth: bf16 weights drawn on the card from a
   seeded generator, 1024 x 1024 (the packed latent (1, 64, 64, 64)), 512
   random T5 tokens and a random CLIP pooled prompt, guidance 4: one recorded
   warm-up step (57 max-free calls at (1, 24, 4608, 128) and nothing else),
   then a timed DDIM-4 trajectory with exactly 57 max-free launches per step.
   Prints ms/step, images/s, peak memory and a profile of one step.
16. attention training kernels: the LSE forward (`attention_fwd.cu`'s third
   entry) and the backward (`attention_bwd.cu`: in bf16 the one-pass
   tensor-core kernel between its delta and dq-rounding kernels, in float32
   dq then dk/dv) against their plain versions at dit64's shape
   (128, 6, 1024, 64), at L = 512 and 256 (the batched TPU kernels'
   lengths), at ragged L and at D = 32 and 128, in bf16 and float32 (o, lse,
   and dq, dk, dv for a random cotangent; in bf16 also o and lse against
   `_attention_tiled_plain` at `TOL_TC`, and dq, dk, dv against
   `_attention_bwd_plain`'s float32 sums at `TOL_BWD_TC`); timed against the
   plain versions, SDPA (forward, and its autograd backward) and the bound,
   with TFLOP/s and the share of the bound.
17. the 64 x 64 training slice: the ViT of phase 11 on 64 x 64 images (1024
   tokens, past the fused gate: the unfused route through
   `dot_product_attention`) on the CPU and on the card, float32, same
   weights and injected noise, RoPE off and on: the loss and every
   parameter's gradient of one step, the parameters after three AdamW steps,
   and exactly 2 LSE forwards and 2 backward launches per step.
18. dit64 training at full width: the dit32 model on 64 x 64 images (1024
   tokens), bf16, batch 128, AdamW, as phase 12: exactly 12 LSE forwards and
   12 backward launches per step and no other kernel. Prints train images/s,
   ms/step, peak memory and a profile of one step.
19. attention masks and dropout: the exact, LSE and backward kernels with a
   bias (a boolean mask in the "full", "batch", "head" and "one" modes) or
   dropout or both, against their plain versions in bf16 and float32: masks
   in each mode at L = 1024, 512 and 256, a mask at (1, 24, 4608, 128),
   dropout 0.1 at dit64's (128, 6, 1024, 64) with and without a key-padding
   mask, D = 192 and 256 and ragged L. The keep mask is read out bit for bit
   (q = k = 0, v = I) from the forward and the backward and held against
   `dropout_keep_mask` on the card and on the CPU. In bf16 the forward forms
   are also held against `_attention_tiled_plain` at `TOL_TC`, and the
   backward forms against `_attention_bwd_plain`'s float32 sums at
   `TOL_BWD_TC`. Each form is timed at dit64's shape beside its unmasked,
   dropout-free form, SDPA with the same mask and dropout, the plain version
   and the bound, with TFLOP/s and the share of the bound.
20. routes: cross-attention (77 keys, heads of 40), heads of 80 and a float
   mask on CUDA tensors through `dot_product_attention` take the plain
   version with finite gradients; D = 192 and 256 and 70,000 (batch, head)
   pairs take the kernels.
21. the dropout and mask slices: the 64 x 64 ViT of phase 17 with dropout
   0.1 on the CPU and on the card with injected seed words and FFN masks
   (loss and gradients, exactly 2 dropout forwards and backwards per step);
   `checkpointing=True` against `False` on the card; a masked
   `MultiheadSelfAttention` at L = 1024, CPU against card, through each
   biased and dropout form.
22. dit64 training with dropout 0.1 at full width, as phase 18: exactly 12
   dropout forwards and 12 dropout backwards per step and no other kernel;
   prints train images/s, ms/step, peak memory and a profile beside phase
   18's numbers.
23. group statistics: the statistics kernel (`csrc/group_stats.cu`) against
   its plain version on 100 + 3 N inputs in bf16 and float32, at unet32's
   three GroupNorm shapes (batch 256, 16 groups) and the JAX package's
   production shapes, (8, 66049, 256) and (2, 4096, 192) included, and
   against the exact statistics in float64; timed beside the plain version,
   `torch.var_mean` and the bound. Then `group_stats`' gradient on the card
   against the plain route's, and `group_norm` / `group_norm_silu` forward
   and backward on the card against autograd through the plain version, at
   unet32's and ADM's shapes, with exact launches.
24. conv3x3: the kernel (`csrc/conv3x3.cu`) against its plain version in
   bf16 and float32 at unet32's admitted shapes, the JAX package's test
   shapes and two ragged shapes (K = 72 on the bf16 tensor-core form, K = 70
   on the CUDA-core form), printing each case's form; the tensor-core cases
   also against the float32 sums of the same bf16 values at `TOL_CONV_TC`;
   timed beside the plain version, `F.conv2d` and the bound, with TFLOP/s
   and the share of the bound; its gradient against `F.conv2d`'s; then the
   entry point at the 25 convolutions of a unet32 forward that
   `can_use_conv3x3` admits, on their own inputs and weights, against the
   layers' outputs (exactly 25 launches, all 25 on the tensor-core form).
25. the tiny UNet slice: `Modulated(UNet(3, 3, mod_features=16,
   hid_channels=(16, 32), hid_blocks=(1, 1)))` on 32 x 32 images, batch 4,
   with norm="group" and norm="layer", on the CPU (plain versions) and on the
   card, float32, same weights and injected noise: the denoiser's output, a
   4-step DDIM trajectory, the loss and every gradient, the parameters after
   three AdamW steps, `checkpointing=True` against False, exact launches.
26. unet32 at full width as `bench.py` builds it (norm="layer"): DDIM-64
   from `sampler.init` noise at batch 256 in bf16, finite, with no launch of
   our kernels; prints images/s, ms/step, peak memory and a profile.
27. unet32 training at full width (`bench.py`'s `_train32` recipe: bf16,
   batch 256, fixed x and t, fresh noise every step, AdamW) with
   norm="group": exactly 18 `group_norm` + 18 `group_stats` launches per
   step and no other kernel; then bench's norm="layer": none. Prints train
   images/s, ms/step, peak memory and a profile of one step of each.
28. the kernels line `{"kernels": [...]}`, then the result line.

The last line of standard output is the JSON result
`{"ok": true, "device": {...}}`; nothing is printed there unless every phase
passed.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from azula_tpu_torch import train
from azula_tpu_torch.denoise import KarrasDenoiser
from azula_tpu_torch.models import adm
from azula_tpu_torch.models.flux import FluxDenoiser, FluxTransformer
from azula_tpu_torch.models.utils import load_cards
from azula_tpu_torch.nn.attention import MultiheadSelfAttention
from azula_tpu_torch.nn.embedding import Modulated
from azula_tpu_torch.nn.layers import Conv
from azula_tpu_torch.nn.unet import UNet, UNetBlock
from azula_tpu_torch.nn.vit import ViT
from azula_tpu_torch.noise import DecaySchedule, VPSchedule
from azula_tpu_torch.ops import _build, attention, conv, fused_msa, norm
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

# dit32 (bench.py's `_dit32`): DiT-S-class ViT, 32 x 32 x 3 images, patch 2
# (L = 256 tokens), 384 channels in 6 heads of 64, 12 blocks; one fused MSA
# call per block
DIT32 = dict(mod_features=64, hid_channels=384, hid_blocks=12, patch_size=2, attention_heads=6)  # noqa: C408
DIT_BATCH = 128
DIT_STEPS = 64
DIT_CALLS_PER_FORWARD = {"fused_msa": 12}

# the dit32 slices of phase 7, as (ViT config, image side): the CPU tests'
# tiny ViT (8 x 8 images, 16 tokens, heads of 32) lies below the fused gate
# (128 <= L, D % 64 == 0) and takes the unfused route through the attention
# kernel; 32 x 32 images with patch 2 and two heads of 64 take the fused route
DIT_SLICES = (
    (dict(mod_features=16, hid_channels=64, hid_blocks=2, patch_size=2, attention_heads=2), 8),  # noqa: C408
    (dict(mod_features=16, hid_channels=128, hid_blocks=2, patch_size=2, attention_heads=2), 32),  # noqa: C408
)

# dit32 training (bench.py's `_dit32_train`): one `_flash_blhd` forward and
# backward per block and step; warm-up and timed steps of phases 12 and 18
DIT_TRAIN_CALLS_PER_STEP = {"flash_blhd_fwd": 12, "flash_blhd_bwd": 12}
DIT_TRAIN_WARMUP = 3
DIT_TRAIN_STEPS = 20

# dit64: the dit32 model on 64 x 64 x 3 images (the ViT takes its positions
# from coordinates), 1024 tokens per image, past the fused gate (L <= 512):
# under grad each block's attention goes through `_flash`, one LSE forward
# and one backward (its kernels counted once) per block and step
DIT64_SIDE = 64
DIT64_TRAIN_CALLS_PER_STEP = {"attention_fwd_lse": 12, "attention_bwd": 12}
DIT64_SHAPE = (
    DIT_BATCH,
    DIT32["attention_heads"],
    (DIT64_SIDE // DIT32["patch_size"]) ** 2,
    DIT32["hid_channels"] // DIT32["attention_heads"],
)

# attention masks and dropout (phases 19-22): DiT's training dropout rate; the
# nine forms of the attention kernels with a bias (a boolean mask), dropout or
# both, each counted under its own name; dit64 training with dropout: one
# dropout LSE forward and one dropout backward per block and step; the seed
# words injected where the CPU and the card must drop the same weights
DROPOUT = 0.1
MASKED_FORMS = tuple(
    f"{entry}{form}"
    for entry in ("attention_fwd", "attention_fwd_lse", "attention_bwd")
    for form in ("_bias", "_dropout", "_bias_dropout")
)
DIT64_DROPOUT_CALLS_PER_STEP = {"attention_fwd_lse_dropout": 12, "attention_bwd_dropout": 12}
SEED_WORDS = (-1640531527, 1013904223)

# FLUX.1-dev (the `FluxTransformer` defaults, 19 dual-stream and 38
# single-stream blocks, 24 heads of 128) at 1024 x 1024: a (1, 64, 64, 64)
# packed latent and 512 T5 tokens, L = 4608; one max-free attention per block.
# Cut: 4 DDIM steps where users run 28-50 (the time per step does not depend
# on their number)
FLUX_BATCH = 1
FLUX_SIDE = 64
FLUX_TEXT = 512
FLUX_STEPS = 4
FLUX_GUIDANCE = 4.0
FLUX_SHAPE = (FLUX_BATCH, 24, FLUX_TEXT + FLUX_SIDE**2, 128)
FLUX_CALLS_PER_FORWARD = {"attention_fwd_max_free": 19 + 38}

# the tiny Flux of phase 14: heads of a kernel head dim, 24 x 24 latents and
# 64 text tokens (L = 640 > 512, L % 128 = 0: the max-free route)
TINY_FLUX = dict(  # noqa: C408
    in_channels=16,
    num_layers=2,
    num_single_layers=2,
    attention_head_dim=64,
    num_attention_heads=2,
    joint_attention_dim=32,
    pooled_projection_dim=20,
    axes_dims_rope=(16, 24, 24),
)
TINY_FLUX_SIDE = 24
TINY_FLUX_TEXT = 64

# unet32 (bench.py's `_unet32`): `Modulated(UNet(3, 3, mod_features=64,
# hid_channels=(64, 128, 256), hid_blocks=(3, 3, 3)), 64)` under
# `KarrasDenoiser(VPSchedule())`, bf16, batch 256 of 32 x 32 x 3, DDIM-64.
# As the bench builds it (norm="layer") it runs no kernel of ours. Trained
# with norm="group", each of its 18 blocks runs one GroupNorm (16 groups),
# 6 each at (256, 1024, 64), (256, 256, 128) and (256, 64, 256), and under
# grad one group_stats for the backward
UNET32 = dict(mod_features=64, hid_channels=(64, 128, 256), hid_blocks=(3, 3, 3))  # noqa: C408
UNET_BATCH = 256
UNET_STEPS = 64
UNET_GROUPS = 16
UNET_GN_SHAPES = ((UNET_BATCH, 1024, 64), (UNET_BATCH, 256, 128), (UNET_BATCH, 64, 256))
UNET_TRAIN_CALLS_PER_STEP = {"group_norm": 18, "group_stats": 18}
# the 3x3 convolutions of one unet32 forward that `can_use_conv3x3` admits:
# 12 at (256, 16, 16, 128 -> 128), 12 at (256, 8, 8, 256 -> 256), 1 at
# (256, 16, 16, 384 -> 128)
UNET_CONV3X3_CALLS = {"conv3x3": 25, "conv3x3_tc": 25}  # every admitted call on the tensor-core form
# the tiny UNet slice: two depths of 16 and 32 channels, one block each (4
# GroupNorms per forward with norm="group"), batch 4 of 32 x 32 x 3
TINY_UNET = dict(mod_features=16, hid_channels=(16, 32), hid_blocks=(1, 1))  # noqa: C408
TINY_UNET_NORMS = 4

# tolerances, as max |kernel - plain| / max |plain|
TOL_GN = {
    # same float32 arithmetic, summed in another order
    torch.float32: 1e-5,
    # plus one rounding of the bf16 output (2^-8) where a value lies on the edge
    torch.bfloat16: 1e-2,
}
TOL_ATTN = {
    torch.float32: 1e-5,
    # the attention kernels round the exp-weights to bf16 against a running
    # max (the tensor-core forward, fused MSA's and _flash_blhd's included,
    # over 128-key tiles, 64 at D = 192 and 256), the plain
    # versions (`_attention_plain`, `_attention_lse_plain`, ...) against the
    # row's final max, as the JAX package's single-block kernels do; and each
    # side rounds o to bf16
    torch.bfloat16: 2e-2,
}
# the bf16 tensor-core forward against `_attention_tiled_plain`, its own
# rounding points, which returns o unrounded in float32: the kernel's final
# rounding of o to bf16 (half an ulp, at most 2^-8 = 3.9e-3 of max |o|) plus
# float32 score sums in another order and exp2 against exp (~1e-6)
TOL_TC = 5e-3
# the bf16 tensor-core backward against `_attention_bwd_plain`'s float32 sums
# before their last rounding (`rounded=False`): the same rounding points, so
# what differs is the kernel's one rounding of dq, dk, dv to bf16 (half an
# ulp, at most 2^-8 = 3.9e-3 of max |d.|), float32 sums in another order
# (dq's in an order that changes from run to run) and a ds or p~ that rounds
# to bf16 either way where the rebuilt scores differ in their last bits
TOL_BWD_TC = 5e-3
# group statistics, kernel against plain version on the same inputs: both
# center every tile exactly in float32 and sum in other orders; the var
# elementwise relative. bf16 inputs are exact in float32, so the 1e-4 on
# their var only leaves room for sums over 2^24 and more rows
TOL_STATS = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# conv3x3: float32 sums of 9 C products in another order (TF32 off); bf16
# adds the output's rounding (2^-8) on each side
TOL_CONV = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# conv3x3's tensor-core form against the float32 sums of the same bf16
# values (`_conv3x3_plain(x.float(), w.float())`, before any rounding): the
# kernel's one rounding of y to bf16 (half an ulp, at most 2^-9 = 2.0e-3 of
# max |y|) plus float32 sums in another order
TOL_CONV_TC = 5e-3
# fused MSA's extra shapes (phase 6) at dit32's batch and length: heads of
# 128, 192 and 256 (label, heads, D); and a ragged length
MSA_HEAD_DIMS = (("D = 128", 3, 128), ("D = 192", 2, 192), ("D = 256", 2, 256))
MSA_RAGGED_L = 200
# the GroupNorm backward on the card (kernel forward, statistics kernel,
# analytic backward) against autograd through the plain version: float32
# sums in other orders; bf16 rounds x's gradient to 8 bits
TOL_GN_GRAD = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# |mean| / std = 1e4 in float32: the rounding of x itself (ulp(1e4) ~ 1e-3)
# passes through x * A + B on both sides; absolute, on outputs of order 1
TOL_GN_LARGE_MEAN = 5e-3
# the tiny slice, card against CPU, float32: conv and matmul sums in other
# orders through a few dozen layers
TOL_SLICE = 1e-4
# a trajectory carries those differences through c_out = -sigma / alpha
# (100 at t = 1) before the clip
TOL_TRAJECTORY = 5e-4
# fused MSA's gradient through the flash route (mixed-precision norm and
# rope, bf16) against the plain version's (float32 statistics): the JAX
# package's own gate, tests/test_ops_tpu.py::test_fused_msa_training_vjp_production_shape
TOL_COMPOSITION = 3e-2
# the training slice's parameters after three AdamW steps, absolute: a step
# moves each parameter by at most ~lr = 1e-4 (Adam's normalized update), and
# the gradients agree to ~1e-6 relative, so the updates agree far inside a
# tenth of one step
TOL_TRAIN_PARAMS = 1e-5

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


def device_ms(fn, reps: int = 20) -> float:
    r"""Device time of `fn` per call, by the profiler: the time of the
    kernels it launches, summed over `reps` calls after a warm-up call, with
    the host's gaps between them left out (CUDA events around a short call
    also count the time in which the card waits for the host)."""

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA or getattr(event, "is_user_annotation", False):
            continue
        us = getattr(event, "self_device_time_total", None)
        total += getattr(event, "self_cuda_time_total", 0) if us is None else us
    if not total:
        raise AssertionError("the profiler saw no device time")
    return total / 1e3 / reps


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


def speed(ops: float, ms: float, bound: float) -> str:
    r"""A timed call's TFLOP/s and share of its bound, as a phase line prints
    them."""

    return f"{ops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.3f} of the bound"


def check_tiled(got: torch.Tensor, want: torch.Tensor, label: str, lse=None, want_lse=None) -> float:
    r"""The bf16 tensor-core forward's o (and LSE) against
    `_attention_tiled_plain` at `TOL_TC`; returns the relative error of o."""

    _, rel_err = errors(got, want)
    if rel_err > TOL_TC:
        raise AssertionError(f"{label}: {rel_err} > {TOL_TC} against its rounding points")
    if lse is not None:
        _, lse_err = errors(lse, want_lse)
        if lse_err > TOL_ATTN[torch.float32]:
            raise AssertionError(f"{label}: LSE {lse_err} > {TOL_ATTN[torch.float32]} against its rounding points")
    return rel_err


def check_bwd_tc(grads, want, label: str) -> dict:
    r"""The bf16 tensor-core backward's dq, dk, dv against
    `_attention_bwd_plain(..., rounded=False)` at `TOL_BWD_TC`; returns the
    relative errors by output."""

    rel = {name: errors(a, b)[1] for name, a, b in zip(("dq", "dk", "dv"), grads, want)}
    bad = {name: err for name, err in rel.items() if err > TOL_BWD_TC}
    if bad:
        raise AssertionError(f"{label}: {bad} > {TOL_BWD_TC} against its rounding points")
    return rel


def ptxas_entries(source: str) -> list:
    r"""[mangled kernel name, registers, spill store bytes] of each kernel
    that `ptxas -v` reported while compiling `source`."""

    log = _build.ptxas_log().split(f"== {source}")[1].split("\n== ")[0]
    entries = []
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            entries.append([found.group(1), 0, 0])
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        used = re.search(r"Used (\d+) registers", line)
        if entries and spill:
            entries[-1][2] = int(spill.group(1))
        if entries and used:
            entries[-1][1] = int(used.group(1))
    return entries


def ptxas_summary(entries: list, pattern: str, form_of, shared) -> str:
    r"""The `ptxas_entries` whose names match `pattern` (the head dim, then
    flags that `form_of` names), per head dim: registers and spill stores of
    each form, and `shared(D)`, the dynamic shared memory of their launches."""

    forms = collections.defaultdict(list)
    for name, regs, spill in entries:
        found = re.search(pattern, name)
        if found:
            D, *flags = (int(x) for x in found.groups())
            forms[D].append((form_of(*flags), regs, spill))
    return "; ".join(
        f"D = {D}: " + ", ".join(f"{form} {regs} regs {spill} B spilled" for form, regs, spill in forms[D])
        + f"; shared memory per block {shared(D)}"
        for D in sorted(forms)
    )


def masked_form(bias: int, dropout: int, unmasked: str = "plain") -> str:
    return "+".join(f for f, on in (("bias", bias), ("dropout", dropout)) if on) or unmasked


def backward_ptxas_summary(source: str) -> str:
    r"""`ptxas_summary` of the bf16 tensor-core attention backward of
    `csrc/attention_bwd_tc.cuh` as `source` instantiates it
    (`backward_kernel<D, bias, dropout, rows>`), then its delta pre-kernel
    per D and its dq rounding post-kernel, whose dropout flag only names
    them."""

    lib = _build.library()
    entries = ptxas_entries(source)
    summary = ptxas_summary(
        entries, r"backward_kernelILi(\d+)ELb(\d)ELb(\d)E", masked_form,
        lambda D: f"{lib.azula_attention_bwd_tc_shared_bytes(D):,} B",
    )
    for kind, pattern in (("delta pre-kernel", r"delta_kernelILi(\d+)ELb0E"),
                          ("dq rounding post-kernel", r"dq_round_kernelILb0E")):
        found = [(re.search(pattern, name), regs, spill) for name, regs, spill in entries]
        summary += f"; {kind} " + ", ".join(
            (f"D = {m.group(1)} " if m.groups() else "") + f"{regs} regs {spill} B spilled"
            for m, regs, spill in found if m)
    return summary


def tc_ptxas_summaries() -> tuple[str, str]:
    r"""`ptxas_summary` of the bf16 tensor-core attention forward
    (`tc::attention_fwd_tc_kernel<D, NW, max-free, bias, dropout>` of
    `csrc/attention_fwd.cu`) and backward (`csrc/attention_bwd.cu`'s
    instantiations, `backward_ptxas_summary`)."""

    lib = _build.library()
    forward = ptxas_summary(
        ptxas_entries("attention_fwd.cu"), r"attention_fwd_tc_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)ELb(\d)E",
        lambda nw, max_free, bias, dropout: ("max-free" if max_free else masked_form(bias, dropout, "exact"))
        + f"/{nw}wg",
        lambda D: ", ".join(f"{lib.azula_attention_fwd_tc_shared_bytes(D, nw):,} B ({nw}wg)" for nw in (2, 1)
                            if lib.azula_attention_fwd_tc_shared_bytes(D, nw)),
    )
    return forward, backward_ptxas_summary("attention_bwd.cu")


def flash_ptxas_summaries() -> tuple[str, str]:
    r"""`ptxas -v` of the bf16 tensor-core `_flash_blhd` pair: the forward
    (`tc::flash_blhd_fwd_tc_kernel<D, NW>` of `csrc/flash_blhd_fwd.cu`, the
    attention forward's block with two Q buffers) and the backward
    (`csrc/flash_blhd_bwd.cu`'s instantiations on the heads in place)."""

    lib = _build.library()
    forward = ptxas_summary(
        ptxas_entries("flash_blhd_fwd.cu"), r"flash_blhd_fwd_tc_kernelILi(\d+)ELi(\d+)E", lambda nw: f"{nw}wg",
        lambda D: ", ".join(f"{lib.azula_flash_blhd_fwd_tc_shared_bytes(D, nw):,} B ({nw}wg)" for nw in (2, 1)
                            if lib.azula_flash_blhd_fwd_tc_shared_bytes(D, nw)),
    )
    return forward, backward_ptxas_summary("flash_blhd_bwd.cu")


def redesign_ptxas_summaries() -> tuple[str, str]:
    r"""`ptxas -v` of the bf16 tensor-core forms of the fused MSA kernel
    (`tc::fused_msa_tc_kernel<D>` of `csrc/fused_msa.cu`) and of conv3x3
    (`tc::conv3x3_tc_kernel` of `csrc/conv3x3.cu`): registers, spill stores
    and the dynamic shared memory of a block."""

    lib = _build.library()
    msa = ptxas_summary(
        ptxas_entries("fused_msa.cu"), r"fused_msa_tc_kernelILi(\d+)E", lambda: "bf16",
        lambda D: f"{lib.azula_fused_msa_tc_shared_bytes(D):,} B",
    )
    conv3x3 = ", ".join(
        f"{regs} regs {spill} B spilled; shared memory per block {lib.azula_conv3x3_tc_shared_bytes():,} B"
        for name, regs, spill in ptxas_entries("conv3x3.cu") if "conv3x3_tc_kernel" in name
    )
    return msa, conv3x3


def new_entry() -> dict:
    r"""A kernel's entry of the kernels line, before its timings."""

    return dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0, max_err=0.0,  # noqa: C408
                bound_by=collections.Counter())


def add_timing(entry: dict, count: int, ms: float, plain: float, library: float, bound: float, by: str,
               abs_err: float, rel_err: float, ops: float = 0.0) -> None:
    r"""Adds `count` calls of one timed shape, of `ops` float operations each
    where counted, to a kernel's entry."""

    entry["ops"] = entry.get("ops", 0.0) + count * ops
    entry["ms"] += count * ms
    entry["plain_ms"] += count * plain
    entry["library_ms"] += count * library
    entry["bound_ms"] += count * bound
    entry["bound_by"][by] += count * bound
    entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
    entry["max_err"] = max(entry["max_err"], rel_err)


@contextlib.contextmanager
def recording():
    r"""Records the kernel calls (shape, dtype, flags and one set of affine
    inputs per distinct call) that the main path makes while it is active."""

    calls = collections.Counter()
    affine = {}
    modulated = [False]
    compose, gn_kernel, attn_kernel = norm._compose_affine, norm._group_norm_kernel, attention._attention_kernel
    msa_kernel, max_free_kernel = fused_msa._fused_msa_kernel, attention._attention_max_free_kernel

    def compose_affine(x, groups, scale, bias, mod_scale, mod_shift):
        # every GroupNorm call composes its affine just before the kernel
        modulated[0] = mod_scale is not None or mod_shift is not None
        return compose(x, groups, scale, bias, mod_scale, mod_shift)

    def gn(x, P, Q, groups, eps, silu):
        key = ("gn", tuple(x.shape), x.dtype, groups, silu, modulated[0])
        calls[key] += 1
        affine.setdefault(key, (P.clone(), Q.clone(), eps))
        return gn_kernel(x, P, Q, groups, eps, silu)

    def attn(q, k, v, scale, *masked):
        calls[("attn", tuple(q.shape), q.dtype, scale)] += 1
        return attn_kernel(q, k, v, scale, *masked)

    def msa(qkv, cos2, sin2, heads, eps, scale):
        calls[("msa", tuple(qkv.shape), qkv.dtype, heads, eps, scale, cos2 is not None)] += 1
        return msa_kernel(qkv, cos2, sin2, heads, eps, scale)

    def max_free(q, k, v, scale):
        calls[("max_free", tuple(q.shape), q.dtype, scale)] += 1
        return max_free_kernel(q, k, v, scale)

    norm._compose_affine, norm._group_norm_kernel, attention._attention_kernel = compose_affine, gn, attn
    fused_msa._fused_msa_kernel, attention._attention_max_free_kernel = msa, max_free
    try:
        yield calls, affine
    finally:
        norm._compose_affine, norm._group_norm_kernel, attention._attention_kernel = compose, gn_kernel, attn_kernel
        fused_msa._fused_msa_kernel, attention._attention_max_free_kernel = msa_kernel, max_free_kernel


def kernel_name(key) -> str:
    r"""The kernel of a recorded call."""

    if key[0] == "gn":
        return "group_norm_silu" if key[4] else "group_norm"
    return {"attn": "attention_fwd", "msa": "fused_msa", "max_free": "attention_fwd_max_free"}[key[0]]


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
        name: new_entry()
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

    entry = new_entry()

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
            if dtype == torch.bfloat16:
                tiled = check_tiled(got, attention._attention_tiled_plain(q, k, v, scale)[0], f"attention {shape}")
                line += f"; against its rounding points rel {tiled:.3e} (tol {TOL_TC})"

            if count and dtype == torch.bfloat16:
                ms = elapsed_ms(lambda: attention._attention_kernel(q, k, v, scale))
                plain = elapsed_ms(lambda: attention._attention_tiled_plain(q, k, v, scale))
                library = elapsed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
                B, H, L, D = shape
                ops = 4 * B * H * L * L * D
                bound, by = bound_ms(4 * q.numel() * q.element_size(), ops, dtype)
                add_timing(entry, count, ms, plain, library, bound, by, abs_err, rel_err, ops)
                line += (f"; {ms:.4f} ms ({speed(ops, ms, bound)}), plain {plain:.4f} ms, SDPA {library:.4f} ms, "
                         f"bound {bound:.4f} ms ({by})")

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


def dit32_model(generator: torch.Generator, **kwargs) -> KarrasDenoiser:
    r"""bench.py's dit32 denoiser, with the modules' own initialization drawn
    from `generator`, cast to bf16 as a whole; `kwargs` go to the blocks
    (`dropout`)."""

    vit = ViT(3, 3, **DIT32, device="cuda", generator=generator, **kwargs)
    backbone = Modulated(vit, DIT32["mod_features"], device="cuda", generator=generator)

    return KarrasDenoiser(backbone.to(torch.bfloat16), VPSchedule())


def check_fused_msa(calls, generator) -> dict:
    r"""The fused MSA kernel against its plain version at the recorded dit32
    call (timed in bf16, with SDPA on the attention core as the library
    yardstick), in bf16 and float32; at the same shape with RoPE, without
    the QK-norm, and at scale 1 with the QK-norm; at heads of 128, 192 and
    256 and at a ragged length, with and without RoPE. Each bf16 case (the
    tensor-core form) is also held against `_fused_msa_tiled_plain`, its own
    rounding points, at `TOL_TC`."""

    entry = new_entry()

    (key,) = [k for k in calls if k[0] == "msa"]
    _, shape, dtype, heads, eps, scale, _ = key
    count = calls[key]
    B, L, C3 = shape
    C = C3 // 3
    D = C // heads

    # the angles of a rope=True MSA over the ViT's 2-d token positions
    side = math.isqrt(L)
    grid = torch.meshgrid(*(torch.arange(side, device="cuda", dtype=torch.float32),) * 2, indexing="ij")
    pos = torch.stack(grid, dim=-1).reshape(-1, 2)
    msa = MultiheadSelfAttention(C, pos_channels=2, attention_heads=heads, rope=True, device="cuda", generator=generator)
    tables = fused_msa.rope_tables(msa.theta_proj(pos), heads)

    def random_tables(length, width, n_heads):
        theta = torch.randn((length, width // 2), generator=generator, device="cuda")
        return fused_msa.rope_tables(theta, n_heads)

    cases = [
        ("main path", shape, heads, (None, None), eps, scale),
        ("rope", shape, heads, tables, eps, scale),
        ("eps=None", shape, heads, (None, None), None, scale),
        ("scale=1", shape, heads, (None, None), eps, 1.0),
    ]
    for label, n_heads, d in MSA_HEAD_DIMS:
        extra = (B, L, 3 * n_heads * d)
        cases.append((label, extra, n_heads, (None, None), eps, 1 / math.sqrt(d)))
        cases.append((f"{label} rope", extra, n_heads, random_tables(L, n_heads * d, n_heads), eps, 1 / math.sqrt(d)))
    ragged = (B, MSA_RAGGED_L, C3)
    cases.append((f"ragged L = {MSA_RAGGED_L}", ragged, heads, (None, None), eps, scale))
    cases.append((f"ragged L = {MSA_RAGGED_L} rope", ragged, heads, random_tables(MSA_RAGGED_L, C, heads), eps, scale))

    for label, case_shape, case_heads, (cos2, sin2), case_eps, case_scale in cases:
        for check_dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(case_shape, generator=generator, device="cuda").to(check_dtype)
            got = fused_msa._fused_msa_kernel(qkv, cos2, sin2, case_heads, case_eps, case_scale)
            want = fused_msa._fused_msa_plain(qkv, cos2, sin2, case_heads, case_eps, case_scale)
            abs_err, rel_err = errors(got, want)
            case = f"fused MSA {case_shape} heads={case_heads} {check_dtype} {label}"
            if rel_err > TOL_ATTN[check_dtype]:
                raise AssertionError(f"{case}: {rel_err} > {TOL_ATTN[check_dtype]}")

            form = "tensor cores" if check_dtype == torch.bfloat16 else "CUDA cores"
            line = (
                f"  fused_msa {case_shape} heads={case_heads} {str(check_dtype)[6:]} {label} ({form}; "
                f"eps={case_eps}, scale={case_scale:.4g}): max abs err {abs_err:.3e}, rel {rel_err:.3e} "
                f"(tol {TOL_ATTN[check_dtype]})"
            )
            if check_dtype == torch.bfloat16:
                tiled = fused_msa._fused_msa_tiled_plain(qkv, cos2, sin2, case_heads, case_eps, case_scale)
                line += f"; against its rounding points {check_tiled(got, tiled, case):.3e} (tol {TOL_TC})"

            if label == "main path" and check_dtype == dtype:
                # the library's attention on the core alone: q and k
                # normalized and rounded beforehand, heads already split
                x5 = qkv.view(B, L, 3, heads, D)

                def rms(z):
                    z = z.float()
                    return (z * torch.rsqrt(torch.mean(torch.square(z), dim=-1, keepdim=True) + eps)).to(dtype)

                q = rms(x5[:, :, 0]).transpose(1, 2).contiguous()
                k = rms(x5[:, :, 1]).transpose(1, 2).contiguous()
                v = x5[:, :, 2].transpose(1, 2).contiguous()

                ms = elapsed_ms(lambda: fused_msa._fused_msa_kernel(qkv, None, None, heads, eps, scale))
                plain = elapsed_ms(lambda: fused_msa._fused_msa_plain(qkv, None, None, heads, eps, scale))
                library = elapsed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
                # read q, k, v once and write the output once
                ops = 4 * B * heads * L * L * D
                bound, by = bound_ms(4 * B * L * C * qkv.element_size(), ops, dtype)
                add_timing(entry, count, ms, plain, library, bound, by, 0.0, 0.0, ops)
                line += (f"; {ms:.4f} ms ({speed(ops, ms, bound)}), plain {plain:.4f} ms, SDPA on the normalized "
                         f"core {library:.4f} ms, bound {bound:.4f} ms ({by})")

            if label == "eps=None" and check_dtype == dtype:
                # no norm and no rope: the tiles go to the products as they
                # arrive, so the difference from the main path's time is the
                # preparation's
                ms = elapsed_ms(lambda: fused_msa._fused_msa_kernel(qkv, None, None, heads, None, scale))
                line += f"; {ms:.4f} ms without the preparation"

            if check_dtype == dtype:
                entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
                entry["max_err"] = max(entry["max_err"], rel_err)
            log(line)
            del qkv, got, want

    return entry


def check_forward_only(generator) -> None:
    r"""Under grad, a backward through `fused_msa_attention` runs the flash
    route's two kernels, one through `dot_product_attention` (with and
    without `max_free`, which the training route ignores) runs the LSE
    forward and backward kernels, and one through `group_norm` or
    `group_norm_silu` runs the GroupNorm and statistics kernels forward and
    the analytic backward, each giving its inputs finite gradients; one
    through each forward-only kernel (the GroupNorm, attention and max-free
    attention kernels and the serving fused MSA kernel, each called
    directly) must raise rather than give its inputs no gradient."""

    def rand(*shape):
        return torch.randn(shape, generator=generator, device="cuda", requires_grad=True)

    runs = {
        "fused_msa_attention": (
            lambda *a: fused_msa.fused_msa_attention(*a, heads=2), [(1, 128, 384)],
            {"flash_blhd_fwd": 1, "flash_blhd_bwd": 1},
        ),
        "dot_product_attention": (
            attention.dot_product_attention, [(1, 2, 64, 32)] * 3,
            {"attention_fwd_lse": 1, "attention_bwd": 1},
        ),
        "dot_product_attention, max_free": (
            lambda *a: attention.dot_product_attention(*a, max_free=True), [(1, 2, 640, 64)] * 3,
            {"attention_fwd_lse": 1, "attention_bwd": 1},
        ),
        "group_norm_silu": (
            lambda x, s, t: norm.group_norm_silu(x, GROUPS, mod_scale=s, mod_shift=t), [(2, 64, 64), (2, 64), (2, 64)],
            {"group_norm_silu": 1, "group_stats": 1},
        ),
        "group_norm": (
            lambda x: norm.group_norm(x, GROUPS), [(2, 64, 64)],
            {"group_norm": 1, "group_stats": 1},
        ),
    }
    for name, (call, shapes, expected) in runs.items():
        inputs = [rand(*shape) for shape in shapes]
        before = collections.Counter(_build.LAUNCHES)
        call(*inputs).float().sum().backward()
        launched = dict(collections.Counter(_build.LAUNCHES) - before)
        if any(t.grad is None or not bool(torch.isfinite(t.grad).all()) for t in inputs):
            raise AssertionError(f"the backward through {name} gave its inputs no finite gradient")
        if launched != expected:
            raise AssertionError(f"the backward through {name} launched {launched}, expected {expected}")
        log(f"  {name} under grad: the backward runs, launches {launched}")

    cases = {
        "group_norm (called directly)": lambda: norm._group_norm_kernel(
            rand(2, 64, 64), torch.ones(2, 64, device="cuda"), torch.zeros(2, 64, device="cuda"), GROUPS, 1e-5, True
        ),
        "attention_fwd (called directly)": lambda: attention._attention_kernel(
            *(rand(1, 2, 64, 32) for _ in range(3)), 32**-0.5
        ),
        "attention_fwd_max_free (called directly)": lambda: attention._attention_max_free_kernel(
            *(rand(1, 2, 640, 64) for _ in range(3)), 0.125
        ),
        "fused_msa (the serving kernel, called directly)": lambda: fused_msa._fused_msa_kernel(
            rand(1, 128, 384), None, None, 2, 1e-5, 0.125
        ),
    }
    for name, call in cases.items():
        y = call()
        try:
            y.float().sum().backward()
        except NotImplementedError as e:
            log(f"  {name} under grad: the backward raises ({e})")
        else:
            raise AssertionError(f"a backward through the {name} kernel did not raise")


def check_dit_slice() -> None:
    r"""Small ViT denoisers on the CPU (plain versions) and on the card
    (kernels), with the same random weights, in float32, RoPE off and on."""

    rng = np.random.default_rng(0)

    _build.LAUNCHES.clear()
    for (config, side), rope in itertools.product(DIT_SLICES, (False, True)):
        def make(device):
            vit = ViT(3, 3, rope=rope, **config, device=device)
            return KarrasDenoiser(Modulated(vit, config["mod_features"], device=device), VPSchedule())

        cpu, card = make("cpu"), make("cuda")
        state = {}
        for key, value in cpu.backbone.state_dict().items():
            if key.endswith("bias"):
                array = 0.2 * rng.standard_normal(value.shape)
            else:  # (out, in) linear: 1 / sqrt(fan in)
                array = rng.standard_normal(value.shape) / math.sqrt(value.shape[-1])
            state[key] = torch.from_numpy(array.astype(np.float32))
        cpu.backbone.load_state_dict(state)
        card.backbone.load_state_dict(state)

        x = torch.from_numpy(rng.standard_normal((2, side, side, 3)).astype(np.float32))
        label = f"{side}x{side} hid={config['hid_channels']} rope={rope}"

        with torch.inference_mode():
            for t in (0.3, 0.9):
                before = dict(_build.LAUNCHES)
                want = cpu(x, torch.tensor(t)).mean
                if dict(_build.LAUNCHES) != before:
                    raise AssertionError("a kernel ran on the CPU path")
                got = card(x.cuda(), torch.tensor(t, device="cuda")).mean

                _, err = errors(got.cpu(), want)
                log(f"  dit denoiser {label} t={t}: rel err {err:.3e} (tol {TOL_SLICE})")
                if err > TOL_SLICE:
                    raise AssertionError("the dit slice's denoiser on the card disagrees with the CPU")

            want = DDIMSampler(cpu, steps=4)(x)
            got = DDIMSampler(card, steps=4)(x.cuda())
            _, err = errors(got.cpu(), want)
            log(f"  dit DDIM-4 trajectory {label}: rel err {err:.3e} (tol {TOL_TRAJECTORY})")
            if err > TOL_TRAJECTORY:
                raise AssertionError("the dit slice's DDIM trajectory on the card disagrees with the CPU")

    launched = dict(_build.LAUNCHES)
    log(f"  kernel launches on the card: {launched}")
    if set(launched) != {"attention_fwd", "fused_msa"} or min(launched.values()) == 0:
        raise AssertionError("the dit slices on the card did not run the attention and fused MSA kernels")


def profile_step(step) -> None:
    r"""Device time of one full-width step (`step()`, a DDIM or train step) by
    kind of kernel, and the share of the step's wall time in which the card
    ran no kernel."""

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kinds, top, ours, calls = collections.Counter(), collections.Counter(), collections.Counter(), collections.Counter()
    launched = 0
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0)
        if not us or event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(event, "is_user_annotation", False):
            continue  # a range such as `Optimizer.step#AdamW.step` spans kernels counted already
        name = event.key
        top[name] += us / 1e3
        launched += event.count
        if "gn_partial_kernel" in name or "gn_fold_kernel" in name or "gn_apply_kernel" in name:
            kind = "group_norm (ours)"
        elif "gs_partial_kernel" in name or "gs_fold_kernel" in name:
            kind = "group_stats (ours)"
        elif "conv3x3_kernel" in name or "conv3x3_tc_kernel" in name:
            kind = "conv3x3 (ours)"
        elif "flash_blhd_fwd_" in name:
            kind = "flash_blhd forward (ours)"
        elif "HeadsLayout" in name or "flash_blhd_dq_kernel" in name or "flash_blhd_dkv_kernel" in name:
            # the backward on (B, L, H D): bf16, the tensor-core kernel
            # between its delta and dq-rounding kernels; float32, dq, dk/dv
            kind = "flash_blhd backward (ours)"
        elif "attention_fwd_tc_kernel<" in name or "attention_fwd_kernel<" in name:
            # the attention forward: <D, warpgroups, max-free, bias, dropout>
            # in bf16 (tc), <D, max-free, dropout> in float32
            flags = name.split("_kernel<")[1].split(">")[0].split(", ")
            max_free, dropout = flags[-3 if "_tc_" in name else -2], flags[-1]
            kind = {"true": "max-free attention (ours)"}.get(max_free) or {
                "true": "attention dropout forward (ours)"}.get(dropout, "attention forward (ours)")
        elif "attention_bwd_" in name:
            # the attention backward's kernels (bf16: delta, the tensor-core
            # kernel, dq's rounding; float32: dq, dk/dv), whose last flag is
            # the dropout flag
            dropout = re.findall(r"\b(true|false)\b", name.split("_kernel<")[1])[-1] == "true"
            kind = "attention dropout backward (ours)" if dropout else "attention backward (ours)"
        elif "fused_msa_kernel" in name or "fused_msa_tc_kernel" in name:
            kind = "fused MSA (ours)"
        elif "multi_tensor_apply" in name:
            kind = "optimizer (AdamW, foreach)"
        elif "conv" in name.lower() or "fprop" in name or "implicit" in name or "nhwc" in name.lower():
            kind = "convolution (cuDNN)"
        elif any(word in name.lower() for word in ("gemm", "cutlass", "xmma", "nvjet")):
            kind = "matmul (cuBLAS)"
        elif "copy" in name.lower():
            kind = "copies (casts, layout)"
        else:
            kind = "other (norms, elementwise, reductions)"
        kinds[kind] += us / 1e3
        if kind.endswith("(ours)"):
            ours[name] += us / 1e3
            calls[name] += event.count

    busy = sum(kinds.values())
    if not busy:
        log("profile: the profiler saw no device time (not measured)")
        return
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in kinds.most_common())
    log(f"profile of one step: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}), {launched} kernels; {parts}")
    for name, ms in top.most_common(12):
        log(f"  {ms:9.3f} ms  {name[:150]}")
    # every kernel of ours by name, the launches of a multi-kernel entry apart
    for name, ms in ours.most_common():
        log(f"  ours: {ms:9.3f} ms in {calls[name]} launches  {name[:150]}")


def check_flash_blhd(generator) -> dict:
    r"""The `_flash_blhd` forward and backward kernels against their plain
    versions at the dit32 training shape (timed in bf16, with SDPA on the
    (B, H, L, D) views of the same tensors as the library yardstick) and at a
    ragged L and the other head dims, in bf16 and float32; each bf16 call
    also against its own rounding points (`_flash_blhd_tiled_plain` at
    `TOL_TC`, `_flash_blhd_bwd_tiled_plain` at `TOL_BWD_TC`). The plain
    backward takes the kernel's own o and log-sum-exp, as autograd hands
    them to it."""

    entries = {
        name: new_entry()
        for name in DIT_TRAIN_CALLS_PER_STEP
    }

    heads = DIT32["attention_heads"]
    main_shape = (DIT_BATCH, 256, heads, DIT32["hid_channels"] // heads)
    shapes = [main_shape, (4, 200, 2, 64), (2, 256, 2, 128), (2, 160, 2, 192), (2, 512, 1, 256), (2, 40, 2, 64)]

    for shape in shapes:
        B, L, H, D = shape
        scale = 1 / math.sqrt(D)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g = (torch.randn((B, L, H * D), generator=generator, device="cuda").to(dtype) for _ in range(4))

            o, lse = attention._flash_blhd_fwd_kernel(q, k, v, H, scale)
            grads = attention._flash_blhd_bwd_kernel(q, k, v, o, g, lse, H, scale)
            want_o = attention._flash_blhd_fwd_plain(q, k, v, H, scale)
            want_grads = attention._flash_blhd_bwd_plain(q, k, v, o, g, H, scale)

            errs = {"o": errors(o, want_o)}
            errs.update({name: errors(a, b) for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads)})
            del want_grads
            tol = TOL_ATTN[dtype]
            bad = {name: rel for name, (_, rel) in errs.items() if rel > tol}
            if bad:
                raise AssertionError(f"flash_blhd {shape} {dtype}: {bad} > {tol}")

            line = f"  flash_blhd (B, L, H, D) = {shape} {str(dtype)[6:]}: rel err " + ", ".join(
                f"{name} {rel:.3e}" for name, (_, rel) in errs.items()
            ) + f" (tol {tol})"
            if dtype == torch.bfloat16:
                tiled_o, tiled_lse = attention._flash_blhd_tiled_plain(q, k, v, H, scale)
                tiled = check_tiled(o, tiled_o, f"flash_blhd_fwd {shape}", lse, tiled_lse)
                line += f"; o against its rounding points rel {tiled:.3e} (tol {TOL_TC})"
                del tiled_o, tiled_lse
                unrounded = attention._flash_blhd_bwd_tiled_plain(q, k, v, o, g, lse, H, scale)
                rel = check_bwd_tc(grads, unrounded, f"flash_blhd_bwd {shape}")
                line += "; dq, dk, dv against their rounding points " + ", ".join(
                    f"{name} {err:.3e}" for name, err in rel.items()) + f" (tol {TOL_BWD_TC})"
                del unrounded

            if shape == main_shape and dtype == torch.bfloat16:
                count = DIT_TRAIN_CALLS_PER_STEP["flash_blhd_fwd"]
                views = [t.view(B, L, H, D).transpose(1, 2) for t in (q, k, v)]
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                out = F.scaled_dot_product_attention(*(t.view(B, L, H, D).transpose(1, 2) for t in leaves), scale=scale)
                g4 = g.view(B, L, H, D).transpose(1, 2)
                n, elt = q.numel(), q.element_size()
                ops = {"flash_blhd_fwd": 4 * B * H * L * L * D, "flash_blhd_bwd": 10 * B * H * L * L * D}

                times = {
                    "flash_blhd_fwd": (
                        elapsed_ms(lambda: attention._flash_blhd_fwd_kernel(q, k, v, H, scale)),
                        elapsed_ms(lambda: attention._flash_blhd_fwd_plain(q, k, v, H, scale)),
                        elapsed_ms(lambda: F.scaled_dot_product_attention(*views, scale=scale)),
                        # q, k, v read and o and the float32 lse written once
                        bound_ms(4 * n * elt + lse.numel() * 4, ops["flash_blhd_fwd"], dtype),
                        errs["o"],
                    ),
                    "flash_blhd_bwd": (
                        elapsed_ms(lambda: attention._flash_blhd_bwd_kernel(q, k, v, o, g, lse, H, scale)),
                        elapsed_ms(lambda: attention._flash_blhd_bwd_plain(q, k, v, o, g, H, scale)),
                        elapsed_ms(lambda: torch.autograd.grad(out, leaves, g4, retain_graph=True)),
                        # q, k, v, o, g and the lse read and dq, dk, dv written once
                        bound_ms(8 * n * elt + lse.numel() * 4, ops["flash_blhd_bwd"], dtype),
                        max((errs[name] for name in ("dq", "dk", "dv")), key=lambda e: e[1]),
                    ),
                }
                for name, (ms, plain, library, (bound, by), (abs_err, rel_err)) in times.items():
                    entry = entries[name]
                    add_timing(entry, count, ms, plain, library, bound, by, abs_err, rel_err, ops[name])
                    line += (f"\n    {name}: {ms:.4f} ms ({speed(ops[name], ms, bound)}), plain {plain:.4f} ms, "
                             f"SDPA {library:.4f} ms, bound {bound:.4f} ms ({by})")
                # device times, the host's gaps left out: the forward, the
                # backward's three launches, SDPA's kernels
                line += (
                    f"\n    device time: flash_blhd_fwd "
                    f"{device_ms(lambda: attention._flash_blhd_fwd_kernel(q, k, v, H, scale)):.4f} ms"
                )
                line += (
                    f", flash_blhd_bwd {device_ms(lambda: attention._flash_blhd_bwd_kernel(q, k, v, o, g, lse, H, scale)):.4f}"
                    f" ms; SDPA forward {device_ms(lambda: F.scaled_dot_product_attention(*views, scale=scale)):.4f} ms, "
                    f"backward {device_ms(lambda: torch.autograd.grad(out, leaves, g4, retain_graph=True)):.4f} ms"
                )
                del out, leaves

            log(line)
            del q, k, v, g, o, lse, grads, want_o
        torch.cuda.empty_cache()

    return entries


def check_composition_grad(generator) -> None:
    r"""The gradient of fused MSA at the dit32 shape with RoPE in bf16, through
    the flash route's kernels, against the gradient through the plain
    version, as the JAX package's gate holds `_fused` against `_reference`;
    and against the same mixed-precision route on the plain `_flash_blhd`,
    which isolates the kernels from the route's own rounding."""

    heads = DIT32["attention_heads"]
    B, L, C = DIT_BATCH, 256, DIT32["hid_channels"]
    eps, scale = 1e-5, 1 / 8
    qkv = torch.randn((B, L, 3 * C), generator=generator, device="cuda").to(torch.bfloat16)
    theta = torch.randn((L, C // 2), generator=generator, device="cuda")
    g = torch.randn((B, L, C), generator=generator, device="cuda")
    cos2, sin2 = fused_msa.rope_tables(theta, heads)

    def grad(fn):
        a = qkv.detach().requires_grad_()
        (fn(a).float() * g).sum().backward()
        return a.grad

    before = collections.Counter(_build.LAUNCHES)
    got = grad(lambda a: fused_msa.fused_msa_attention(a, heads, theta, eps=eps, scale=scale))
    launched = dict(collections.Counter(_build.LAUNCHES) - before)
    if launched != {"flash_blhd_fwd": 1, "flash_blhd_bwd": 1}:
        raise AssertionError(f"the gradient did not go through the flash kernels: {launched}")

    want = grad(lambda a: fused_msa.fused_msa_attention(a, heads, theta, eps=eps, scale=scale, implementation="plain"))
    same_route = grad(
        lambda a: fused_msa._reference_core_flash(a, cos2, sin2, heads, eps, scale, implementation="plain")
    )

    for label, reference, tol in (
        ("the plain version (the JAX gate)", want, TOL_COMPOSITION),
        ("the same route on the plain _flash_blhd", same_route, TOL_ATTN[torch.bfloat16]),
    ):
        abs_err, rel_err = errors(got, reference)
        log(f"  grad of fused_msa_attention (B, L, 3C) = {tuple(qkv.shape)}, RoPE, bf16, flash kernels, against "
            f"{label}: max abs err {abs_err:.3e}, rel {rel_err:.3e} (tol {tol})")
        if rel_err > tol:
            raise AssertionError(f"fused MSA's gradient through the flash kernels disagrees with {label}")


def check_train_slice(side: int, calls_per_step: dict) -> None:
    r"""The ViT denoiser of phase 7's second slice on `side` x `side` images,
    on the CPU (plain versions) and on the card (the kernels of its training
    route, `calls_per_step` launches per step), same weights and injected
    noise, float32, RoPE off and on: the loss and every parameter's gradient
    of one step, then the parameters after three AdamW steps."""

    config, _ = DIT_SLICES[1]
    rng = np.random.default_rng(1)
    steps = 0

    _build.LAUNCHES.clear()
    for rope in (False, True):
        def make(device):
            vit = ViT(3, 3, rope=rope, **config, device=device)
            return KarrasDenoiser(Modulated(vit, config["mod_features"], device=device), VPSchedule())

        cpu, card = make("cpu"), make("cuda")
        state = {}
        for key, value in cpu.backbone.state_dict().items():
            scale = 0.2 if key.endswith("bias") else 1 / math.sqrt(value.shape[-1])
            state[key] = torch.from_numpy((scale * rng.standard_normal(value.shape)).astype(np.float32))
        cpu.backbone.load_state_dict(state)
        card.backbone.load_state_dict(state)

        optimizers = [torch.optim.AdamW(d.parameters(), **train.OPTAX_ADAMW) for d in (cpu, card)]
        x = torch.from_numpy(rng.standard_normal((4, side, side, 3)).astype(np.float32))
        t = torch.from_numpy(rng.uniform(0.05, 0.95, 4).astype(np.float32))

        for i in range(3):
            z = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
            losses = {}
            for device, denoiser in (("cpu", cpu), ("cuda", card)):
                before = dict(_build.LAUNCHES)
                loss = denoiser._loss(x.to(device), t.to(device), z.to(device))
                loss.backward()
                if device == "cpu" and dict(_build.LAUNCHES) != before:
                    raise AssertionError("a kernel ran on the CPU path")
                losses[device] = loss.item()
            steps += 1

            if i == 0:
                loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
                worst, worst_name = 0.0, ""
                for (name, a), (_, b) in zip(cpu.named_parameters(), card.named_parameters()):
                    _, err = errors(b.grad.cpu(), a.grad)
                    worst, worst_name = max((worst, worst_name), (err, name))
                log(f"  train slice {side}x{side} rope={rope}: loss {losses['cpu']:.6f}, rel err {loss_err:.3e}; "
                    f"worst parameter gradient rel err {worst:.3e} ({worst_name}) (tol {TOL_SLICE})")
                if loss_err > TOL_SLICE or worst > TOL_SLICE:
                    raise AssertionError("the training slice's loss or gradients on the card disagree with the CPU")

            for optimizer in optimizers:
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)

        diff = max((b.detach().cpu() - a.detach()).abs().max().item()
                   for a, b in zip(cpu.parameters(), card.parameters()))
        log(f"  train slice {side}x{side} rope={rope}: parameters after three AdamW steps, max abs diff {diff:.3e} "
            f"(tol {TOL_TRAIN_PARAMS})")
        if diff > TOL_TRAIN_PARAMS:
            raise AssertionError("the training slice's parameters on the card disagree with the CPU")

    launched = dict(_build.LAUNCHES)
    expected = {name: n * steps for name, n in calls_per_step.items()}
    log(f"  kernel launches on the card: {launched}, expected {expected}")
    if launched != expected:
        raise AssertionError("the training slice on the card did not run exactly its route's kernels")


def train_full_width(denoiser, batch: int, side: int, calls_per_step: dict, generator, dropout: bool = False) -> dict:
    r"""`bench.py`'s train recipe for `denoiser` (bf16) on `side` x `side`
    images: batch `batch`, fixed x and t, fresh noise every step, AdamW with
    optax's settings, through `TrainState.step`: warm-up steps, then timed
    steps with finite losses and exactly `calls_per_step` launches per step
    and no other kernel. With `dropout`, the blocks drop at their rate,
    drawn from `generator`: JAX's `loss` spends its key on the noise, so the
    step hands the generator to the denoiser and takes the weighted loss
    itself (`_loss` on fresh noise). Prints train images/s, ms/step, peak
    memory and a profile of one step; returns the timed steps' launches,
    ms/step, train images/s and peak memory."""

    x_train = torch.randn((batch, side, side, 3), generator=generator, device="cuda")
    t_train = torch.rand((batch,), generator=generator, device="cuda")
    optimizer = torch.optim.AdamW(denoiser.parameters(), **train.OPTAX_ADAMW)

    if not dropout:
        state = train.TrainState(denoiser, optimizer)

        def step():
            return state.step(x_train, t_train, generator)
    else:
        def step():
            z = torch.randn(x_train.shape, generator=generator, device="cuda")
            loss = denoiser._loss(x_train, t_train, z, generator=generator)
            loss.backward()
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            return loss.detach()

    for _ in range(DIT_TRAIN_WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    losses = [step() for _ in range(DIT_TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    train_launches = dict(_build.LAUNCHES)

    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"a training loss at {side}x{side} is not finite: {losses.tolist()}")
    expected = {name: n * DIT_TRAIN_STEPS for name, n in calls_per_step.items()}
    log(f"launches {train_launches}, expected {expected}")
    if train_launches != expected:
        raise AssertionError(f"the {side}x{side} training path's launch counts are not exact")
    result = dict(  # noqa: C408
        launches=train_launches,
        ms=train_seconds / DIT_TRAIN_STEPS * 1e3,
        images_s=batch * DIT_TRAIN_STEPS / train_seconds,
        peak_gib=peak / 2**30,
    )
    log(f"{side}x{side} training{' with dropout' if dropout else ''} {train_seconds:.3f} s for "
        f"{DIT_TRAIN_STEPS} steps: {result['images_s']:.4f} train images/s, {result['ms']:.3f} ms/step, "
        f"peak memory {result['peak_gib']:.2f} GiB; loss first {losses[0].item():.5f}, last {losses[-1].item():.5f}")
    profile_step(step)

    del step, optimizer, denoiser, x_train, t_train
    torch.cuda.empty_cache()

    return result


def check_attention_training(generator) -> dict:
    r"""The LSE forward and the backward kernels against their plain versions
    at dit64's shape and the batched TPU kernels' lengths (timed in bf16,
    with SDPA's forward and its autograd backward on the same tensors as the
    library yardsticks; the entries sum dit64's calls of one step), at
    ragged L and at the other head dims, in bf16 and float32. The plain
    backward takes the kernel's own o and lse, as autograd hands it the
    forward's."""

    entries = {
        name: new_entry()
        for name in DIT64_TRAIN_CALLS_PER_STEP
    }
    count = DIT64_TRAIN_CALLS_PER_STEP["attention_fwd_lse"]

    timed = [DIT64_SHAPE, (8, 6, 512, 64), (8, 6, 256, 64)]
    shapes = [*timed, (4, 3, 1000, 64), (2, 4, 777, 32), (2, 4, 1024, 128), (2, 2, 300, 128)]
    for shape in shapes:
        B, H, L, D = shape
        scale = 1 / math.sqrt(D)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g = (torch.randn(shape, generator=generator, device="cuda").to(dtype) for _ in range(4))

            o, lse = attention._attention_lse_kernel(q, k, v, scale)
            grads = attention._attention_bwd_kernel(q, k, v, o, lse, g, scale)
            want_o, want_lse = attention._attention_lse_plain(q, k, v, scale)
            want_grads = attention._attention_bwd_plain(q, k, v, o, lse, g, scale)

            errs = {"o": errors(o, want_o), "lse": errors(lse, want_lse)}
            errs.update({name: errors(a, b) for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads)})
            del want_grads
            tol = TOL_ATTN[dtype]
            bad = {name: rel for name, (_, rel) in errs.items() if rel > tol}
            if bad:
                raise AssertionError(f"attention training kernels {shape} {dtype}: {bad} > {tol}")

            line = f"  attention_fwd_lse + attention_bwd (B, H, L, D) = {shape} {str(dtype)[6:]}: rel err " + ", ".join(
                f"{name} {rel:.3e}" for name, (_, rel) in errs.items()
            ) + f" (tol {tol})"
            if dtype == torch.bfloat16:
                tiled_o, tiled_lse = attention._attention_tiled_plain(q, k, v, scale)
                tiled = check_tiled(o, tiled_o, f"attention_fwd_lse {shape}", lse, tiled_lse)
                line += f"; o against its rounding points rel {tiled:.3e} (tol {TOL_TC})"
                del tiled_o, tiled_lse
                unrounded = attention._attention_bwd_plain(q, k, v, o, lse, g, scale, rounded=False)
                rel = check_bwd_tc(grads, unrounded, f"attention_bwd {shape}")
                line += "; dq, dk, dv against their rounding points " + ", ".join(
                    f"{name} {err:.3e}" for name, err in rel.items()) + f" (tol {TOL_BWD_TC})"
                del unrounded

            if shape in timed and dtype == torch.bfloat16:
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                out = F.scaled_dot_product_attention(*leaves, scale=scale)
                n, elt = q.numel(), q.element_size()
                ops = {"attention_fwd_lse": 4 * B * H * L * L * D, "attention_bwd": 10 * B * H * L * L * D}

                times = {
                    "attention_fwd_lse": (
                        elapsed_ms(lambda: attention._attention_lse_kernel(q, k, v, scale)),
                        elapsed_ms(lambda: attention._attention_tiled_plain(q, k, v, scale)),
                        elapsed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
                        # q, k, v read and o and the float32 lse written once
                        bound_ms(4 * n * elt + lse.numel() * 4, ops["attention_fwd_lse"], dtype),
                        max((errs[name] for name in ("o", "lse")), key=lambda e: e[1]),
                    ),
                    "attention_bwd": (
                        elapsed_ms(lambda: attention._attention_bwd_kernel(q, k, v, o, lse, g, scale)),
                        elapsed_ms(lambda: attention._attention_bwd_plain(q, k, v, o, lse, g, scale)),
                        elapsed_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)),
                        # q, k, v, o, g and the lse read and dq, dk, dv written once
                        bound_ms(8 * n * elt + lse.numel() * 4, ops["attention_bwd"], dtype),
                        max((errs[name] for name in ("dq", "dk", "dv")), key=lambda e: e[1]),
                    ),
                }
                for name, (ms, plain, library, (bound, by), (abs_err, rel_err)) in times.items():
                    line += (f"\n    {name}: {ms:.4f} ms ({speed(ops[name], ms, bound)}), plain {plain:.4f} ms, "
                             f"SDPA {library:.4f} ms, bound {bound:.4f} ms ({by})")
                    if shape != DIT64_SHAPE:
                        continue
                    entry = entries[name]
                    add_timing(entry, count, ms, plain, library, bound, by, abs_err, rel_err, ops[name])
                del out, leaves

            log(line)
            del q, k, v, g, o, lse, grads, want_o, want_lse
        torch.cuda.empty_cache()

    return entries


def check_max_free(generator) -> dict:
    r"""The max-free attention kernel against its plain version at the
    FLUX.1 shapes (timed in bf16 beside the plain version, SDPA and the
    bound), in float32, at ragged lengths called directly (the dispatch takes
    the kernel only at L % 128 = 0), and with logits above the clamp."""

    entry = new_entry()
    count = FLUX_CALLS_PER_FORWARD["attention_fwd_max_free"]

    cases = [
        # (label, shape, dtype, q scale, timed)
        ("row 5's route: FLUX.1 at 1024 px", FLUX_SHAPE, torch.bfloat16, 1.0, True),
        ("row 3's route: FLUX.1 at 512 px", (1, 24, 1536, 128), torch.bfloat16, 1.0, True),
        ("float32", FLUX_SHAPE, torch.float32, 1.0, False),
        ("float32, D = 64", (2, 4, 1024, 64), torch.float32, 1.0, False),
        ("ragged L", (2, 3, 1000, 128), torch.bfloat16, 1.0, False),
        ("ragged L", (1, 4, 2305, 64), torch.float32, 1.0, False),
        # logits of std 30: a few per row above 80, where the clamp applies
        ("clamp", (1, 2, 2304, 128), torch.bfloat16, 30.0, False),
        ("clamp", (1, 2, 2304, 128), torch.float32, 30.0, False),
    ]
    for label, shape, dtype, q_scale, timed in cases:
        scale = 1 / math.sqrt(shape[-1])
        q, k, v = (torch.randn(shape, generator=generator, device="cuda") for _ in range(3))
        q, k, v = (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)

        got = attention._attention_max_free_kernel(q, k, v, scale)
        want = attention._attention_max_free_plain(q, k, v, scale)
        abs_err, rel_err = errors(got, want)
        tol = TOL_ATTN[dtype]
        if rel_err > tol:
            raise AssertionError(f"max-free attention {shape} {dtype} ({label}): {rel_err} > {tol}")

        line = (f"  attention_fwd_max_free {shape} {str(dtype)[6:]} ({label}): "
                f"max abs err {abs_err:.3e}, rel {rel_err:.3e} (tol {tol})")
        if dtype == torch.bfloat16:
            tiled_o = attention._attention_tiled_plain(q, k, v, scale, max_free=True)[0]
            tiled = check_tiled(got, tiled_o, f"max-free attention {shape} ({label})")
            line += f"; against its rounding points rel {tiled:.3e} (tol {TOL_TC})"
            del tiled_o

        if q_scale > 1:
            _, exact_err = errors(want, attention._attention_plain(q, k, v, scale=scale))
            if exact_err < 0.1:
                raise AssertionError("the clamp case did not reach the clamp")
            line += f"; the exact softmax differs by rel {exact_err:.3e}"

        if timed:
            ms = elapsed_ms(lambda: attention._attention_max_free_kernel(q, k, v, scale))
            plain = elapsed_ms(lambda: attention._attention_max_free_plain(q, k, v, scale))
            library = elapsed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            B, H, L, D = shape
            # q, k, v read and o written once; 4 L^2 D operations per pair
            ops = 4 * B * H * L * L * D
            bound, by = bound_ms(4 * q.numel() * q.element_size(), ops, dtype)
            line += (f"; {ms:.4f} ms ({speed(ops, ms, bound)}), plain {plain:.4f} ms, SDPA {library:.4f} ms, "
                     f"bound {bound:.4f} ms ({by})")

            if shape == FLUX_SHAPE:
                add_timing(entry, count, ms, plain, library, bound, by, abs_err, rel_err, ops)

        log(line)

    return entry


def check_flux_slice() -> None:
    r"""A small Flux denoiser on the CPU (plain versions) and on the card
    (the max-free kernel), same random weights, float32."""

    rng = np.random.default_rng(2)
    cpu = FluxDenoiser(FluxTransformer(**TINY_FLUX, device="cpu"), DecaySchedule())
    card = FluxDenoiser(FluxTransformer(**TINY_FLUX, device="cuda"), DecaySchedule())

    state = {}
    for key, value in cpu.backbone.state_dict().items():
        if value.ndim == 1 and key.endswith(".weight"):  # the q/k RMSNorm gains
            array = 1 + 0.2 * rng.standard_normal(value.shape)
        elif value.ndim == 1:
            array = 0.2 * rng.standard_normal(value.shape)
        else:  # (out, in) linear: 1 / sqrt(fan in)
            array = rng.standard_normal(value.shape) / math.sqrt(value.shape[-1])
        state[key] = torch.from_numpy(array.astype(np.float32))
    cpu.backbone.load_state_dict(state)
    card.backbone.load_state_dict(state)

    side, channels = TINY_FLUX_SIDE, TINY_FLUX["in_channels"]
    x = torch.from_numpy(rng.standard_normal((2, side, side, channels)).astype(np.float32))
    cond = dict(  # noqa: C408
        prompt_clip=torch.from_numpy(rng.standard_normal((2, TINY_FLUX["pooled_projection_dim"])).astype(np.float32)),
        prompt_t5=torch.from_numpy(
            rng.standard_normal((1, TINY_FLUX_TEXT, TINY_FLUX["joint_attention_dim"])).astype(np.float32)
        ),
    )
    card_cond = {k: v.cuda() for k, v in cond.items()}
    per_forward = TINY_FLUX["num_layers"] + TINY_FLUX["num_single_layers"]

    _build.LAUNCHES.clear()
    with torch.inference_mode():
        for t in (0.3, 0.9):
            before = dict(_build.LAUNCHES)
            want = cpu(x, torch.tensor(t), **cond).mean
            if dict(_build.LAUNCHES) != before:
                raise AssertionError("a kernel ran on the CPU path")
            got = card(x.cuda(), torch.tensor(t, device="cuda"), **card_cond).mean

            _, err = errors(got.cpu(), want)
            log(f"  flux denoiser L={side * side + TINY_FLUX_TEXT} t={t}: rel err {err:.3e} (tol {TOL_SLICE})")
            if err > TOL_SLICE:
                raise AssertionError("the tiny Flux denoiser on the card disagrees with the CPU")

        want = DDIMSampler(cpu, steps=4)(x, **cond)
        got = DDIMSampler(card, steps=4)(x.cuda(), **card_cond)
        _, err = errors(got.cpu(), want)
        log(f"  flux DDIM-4 trajectory: rel err {err:.3e} (tol {TOL_SLICE})")
        if err > TOL_SLICE:
            raise AssertionError("the tiny Flux DDIM trajectory on the card disagrees with the CPU")

    launched = dict(_build.LAUNCHES)
    expected = {"attention_fwd_max_free": per_forward * (2 + 4)}
    log(f"  kernel launches on the card: {launched}, expected {expected}")
    if launched != expected:
        raise AssertionError("the tiny Flux slice's launch counts are not exact")


def mode_mask(mode: str, B: int, H: int, L: int, generator) -> torch.Tensor:
    r"""A random boolean mask of one broadcast mode over (B, H) that keeps
    ~70% of the keys and the first key of every row."""

    shape = {"full": (B, H), "batch": (B, 1), "head": (1, H), "one": (1, 1)}[mode]
    mask = torch.rand((*shape, L, L), generator=generator, device="cuda") < 0.7
    mask[..., 0] = True
    return mask


def padding_mask(B: int, L: int, generator) -> torch.Tensor:
    r"""A (B, 1, L, L) key-padding mask, the "batch" mode: batch row b attends
    to its first n_b keys, n_b uniform in [L / 2, L]."""

    lengths = torch.randint(L // 2, L + 1, (B,), generator=generator, device="cuda")
    keys = torch.arange(L, device="cuda")
    return (keys < lengths[:, None])[:, None, None, :].expand(B, 1, L, L)


def masked_case(shape, dtype, mask, rate, generator, backward=True) -> dict:
    r"""The LSE entry, the exact entry and the backward with the bias of
    `mask` (or none) and dropout at `rate` (seed `SEED_WORDS`) against their
    plain versions; the plain backward takes the kernel's own o and lse.
    Raises past the tolerance; returns the errors by output."""

    B, H, L, D = shape
    scale = 1 / math.sqrt(D)
    q, k, v, g = (torch.randn(shape, generator=generator, device="cuda").to(dtype) for _ in range(4))
    bias, mode = (None, "one") if mask is None else attention._mask_to_bias(mask, q)
    seed = torch.tensor(SEED_WORDS, dtype=torch.int32, device="cuda") if rate > 0 else None
    masked = (bias, mode, seed, rate)

    o, lse = attention._attention_lse_kernel(q, k, v, scale, *masked)
    exact = attention._attention_kernel(q, k, v, scale, *masked)
    want_o, want_lse = attention._attention_lse_plain(q, k, v, scale, *masked)
    errs = {"o": errors(o, want_o), "lse": errors(lse, want_lse)}
    errs["o of the exact entry"] = errors(exact, want_o)
    del want_o, want_lse
    tiled = {}
    if dtype == torch.bfloat16:
        tiled_o, tiled_lse = attention._attention_tiled_plain(q, k, v, scale, *masked)
        tiled["o"] = check_tiled(o, tiled_o, f"attention_fwd_lse {shape} masked", lse, tiled_lse)
        tiled["o of the exact entry"] = check_tiled(exact, tiled_o, f"attention_fwd {shape} masked")
        del tiled_o, tiled_lse
    del exact
    if backward:
        grads = attention._attention_bwd_kernel(q, k, v, o, lse, g, scale, *masked)
        want_grads = attention._attention_bwd_plain(q, k, v, o, lse, g, scale, *masked)
        errs.update({name: errors(a, b) for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads)})
        del want_grads
        if dtype == torch.bfloat16:
            unrounded = attention._attention_bwd_plain(q, k, v, o, lse, g, scale, *masked, rounded=False)
            tiled.update(check_bwd_tc(grads, unrounded, f"attention_bwd {shape} masked"))
            del unrounded
        del grads

    tol = TOL_ATTN[dtype]
    label = f"{'no mask' if mask is None else f'{mode} mask'}{f', dropout {rate}' if rate else ''}"
    log(f"  {shape} {str(dtype)[6:]}, {label}: rel err "
        + ", ".join(f"{name} {rel:.3e}" for name, (_, rel) in errs.items()) + f" (tol {tol})"
        + "".join(f"; {name} against its rounding points {rel:.3e} "
                  f"(tol {TOL_BWD_TC if name in ('dq', 'dk', 'dv') else TOL_TC})" for name, rel in tiled.items()))
    bad = {name: rel for name, (_, rel) in errs.items() if rel > tol}
    if bad:
        raise AssertionError(f"masked attention kernels {shape} {dtype} {label}: {bad} > {tol}")

    del q, k, v, g, o, lse, bias
    torch.cuda.empty_cache()
    return errs


def check_keep_readout() -> None:
    r"""The kernels' dropout keep mask read out bit for bit: at q = k = 0 and
    v = I (L = D = 128) every weight is 1 / L, so the forward's output is
    M / (L (1 - r)); with the cotangent g = I the backward's dv is its
    transpose, the mask that the dk/dv kernel regenerated. Both must equal
    `dropout_keep_mask` of the same seed words, on the card and on the CPU."""

    B, H, L = 2, 3, 128
    seed = torch.tensor(SEED_WORDS, dtype=torch.int32, device="cuda")
    want = attention.dropout_keep_mask(B, H, L, seed, DROPOUT)
    want_cpu = attention.dropout_keep_mask(B, H, L, seed.cpu(), DROPOUT)
    if not torch.equal(want.cpu(), want_cpu):
        raise AssertionError("dropout_keep_mask differs between the card and the CPU")

    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((B, H, L, L), dtype=dtype, device="cuda")
        eye = torch.eye(L, dtype=dtype, device="cuda").expand(B, H, L, L).contiguous()
        masked = (None, "one", seed, DROPOUT)

        o, lse = attention._attention_lse_kernel(q, q, eye, 1.0, *masked)
        exact = attention._attention_kernel(q, q, eye, 1.0, *masked)
        _, _, dv = attention._attention_bwd_kernel(q, q, eye, o, lse, eye, 1.0, *masked)
        reads = {"LSE entry": o > 0, "exact entry": exact > 0, "backward": dv.transpose(-1, -2) > 0}

        for name, keep in reads.items():
            if not torch.equal(keep, want):
                raise AssertionError(f"the {name}'s keep mask ({str(dtype)[6:]}) differs from dropout_keep_mask "
                                     f"in {int((keep != want).sum())} of {want.numel()} weights")
        kept = o[want].float()
        log(f"  keep mask read out bit for bit ({str(dtype)[6:]}): LSE entry, exact entry and backward equal "
            f"dropout_keep_mask on the card and on the CPU, {want.float().mean().item():.4f} kept "
            f"(rate {DROPOUT}); kept outputs {kept.min().item():.6g} to {kept.max().item():.6g}, "
            f"1 / (L (1 - r)) = {1 / (L * (1 - DROPOUT)):.6g}")


def check_masked_kernels(generator) -> dict:
    r"""Phase 19: the nine masked and dropout forms of the attention kernels
    against their plain versions, in bf16 and float32: masks in the four
    modes at L = 1024, 512 and 256; a mask at FLUX.1's (1, 24, 4608, 128),
    the blocked TPU kernel's length; dropout at dit64's shape with and
    without a padding mask; D = 192 and 256; ragged L; the keep mask read
    out bit for bit. Then each form, timed at dit64's shape in bf16 beside
    its unmasked, dropout-free form, SDPA with the same mask and dropout,
    the plain version and the bound."""

    for L in (1024, 512, 256):
        for mode in ("full", "batch", "head", "one"):
            for dtype in (torch.bfloat16, torch.float32):
                masked_case((4, 6, L, 64), dtype, mode_mask(mode, 4, 6, L, generator), 0.0, generator)
    errs = {}  # by form, at dit64's shape in bf16
    for dtype in (torch.bfloat16, torch.float32):
        masked_case(FLUX_SHAPE, dtype, mode_mask("one", *FLUX_SHAPE[:3], generator), 0.0, generator)
        pad = padding_mask(DIT_BATCH, DIT64_SHAPE[2], generator)
        for form, (mask, rate) in {"_bias": (pad, 0.0), "_dropout": (None, DROPOUT), "_bias_dropout": (pad, DROPOUT)}.items():
            case = masked_case(DIT64_SHAPE, dtype, mask, rate, generator)
            if dtype == torch.bfloat16:
                errs[form] = case
        for D in (192, 256):
            masked_case((2, 4, 512, D), dtype, mode_mask("head", 2, 4, 512, generator), DROPOUT, generator)
        masked_case((2, 3, 1000, 64), dtype, mode_mask("full", 2, 3, 1000, generator), DROPOUT, generator)
        masked_case((2, 4, 777, 32), dtype, None, DROPOUT, generator)
    check_keep_readout()

    # the timed forms at dit64's shape, bf16, with a key-padding mask
    B, H, L, D = DIT64_SHAPE
    dtype, scale = torch.bfloat16, 1 / math.sqrt(D)
    q, k, v, g = (torch.randn(DIT64_SHAPE, generator=generator, device="cuda").to(dtype) for _ in range(4))
    pad = padding_mask(B, L, generator)
    bias, mode = attention._mask_to_bias(pad, q)
    seed = torch.tensor(SEED_WORDS, dtype=torch.int32, device="cuda")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    n, elt = q.numel(), q.element_size()
    ops = {"fwd": 4 * B * H * L * L * D, "bwd": 10 * B * H * L * L * D}

    entries = {}
    baseline = {}
    for form, (b, s, rate) in {
        "": (None, None, 0.0),
        "_bias": (bias, None, 0.0),
        "_dropout": (None, seed, DROPOUT),
        "_bias_dropout": (bias, seed, DROPOUT),
    }.items():
        masked = (b, mode, s, rate)
        sdpa = dict(attn_mask=None if b is None else pad, dropout_p=rate, scale=scale)  # noqa: C408
        o, lse = attention._attention_lse_kernel(q, k, v, scale, *masked)
        out = F.scaled_dot_product_attention(*leaves, **sdpa)
        # q, k, v read and o written once (the lse too, where written); a
        # bias read once; the seed's 8 bytes; the hash's integer work is not
        # counted (the peak table has no int32 rate)
        extra = (0 if b is None else b.numel() * elt) + (0 if s is None else 8)

        timings = {
            "attention_fwd": (
                elapsed_ms(lambda: attention._attention_kernel(q, k, v, scale, *masked)),
                elapsed_ms(lambda: attention._attention_tiled_plain(q, k, v, scale, *masked), reps=3, warmup=1),
                elapsed_ms(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa)),
                bound_ms(4 * n * elt + extra, ops["fwd"], dtype),
            ),
            "attention_fwd_lse": (
                elapsed_ms(lambda: attention._attention_lse_kernel(q, k, v, scale, *masked)),
                elapsed_ms(lambda: attention._attention_tiled_plain(q, k, v, scale, *masked), reps=3, warmup=1),
                elapsed_ms(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa)),
                bound_ms(4 * n * elt + lse.numel() * 4 + extra, ops["fwd"], dtype),
            ),
            "attention_bwd": (
                elapsed_ms(lambda: attention._attention_bwd_kernel(q, k, v, o, lse, g, scale, *masked)),
                elapsed_ms(lambda: attention._attention_bwd_plain(q, k, v, o, lse, g, scale, *masked),
                           reps=3, warmup=1),
                elapsed_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)),
                bound_ms(8 * n * elt + lse.numel() * 4 + extra, ops["bwd"], dtype),
            ),
        }
        del out
        for entry, (ms, plain, library, (bound, by)) in timings.items():
            kind = "bwd" if entry == "attention_bwd" else "fwd"
            name = entry + form
            line = (f"  {name} at {DIT64_SHAPE} bf16{'' if b is None else ' (batch padding mask)'}: {ms:.4f} ms "
                    f"({speed(ops[kind], ms, bound)}), plain {plain:.4f} ms, SDPA {library:.4f} ms, "
                    f"bound {bound:.4f} ms ({by})")
            if not form:
                baseline[entry] = ms
                log(line)
                continue
            log(line + f"; {ms / baseline[entry]:.3f}x the unmasked, dropout-free form's {baseline[entry]:.4f} ms")
            # per call, but for the dit64 dropout path's forms: per train step
            calls = DIT64_DROPOUT_CALLS_PER_STEP.get(name, 1)
            entries[name] = dict(ms=calls * ms, plain_ms=calls * plain, library_ms=calls * library,  # noqa: C408
                                 bound_ms=calls * bound, bound_by=collections.Counter({by: calls * bound}),
                                 ops=calls * ops[kind])
        del o, lse

    # each form's errors at dit64's shape in bf16
    outputs = {"attention_fwd": ("o of the exact entry",), "attention_fwd_lse": ("o", "lse"),
               "attention_bwd": ("dq", "dk", "dv")}
    for name, entry in entries.items():
        kernel, form = next((k, name[len(k):]) for k in ("attention_fwd_lse", "attention_bwd", "attention_fwd")
                            if name.startswith(k))
        abs_err, rel_err = max((errs[form][output] for output in outputs[kernel]), key=lambda e: e[1])
        entry.update(max_abs_err=abs_err, max_err=rel_err)

    del q, k, v, g, leaves, bias, pad
    torch.cuda.empty_cache()
    return entries


def check_routes(generator) -> None:
    r"""Phase 20: calls that the JAX package computes, on CUDA tensors
    through `dot_product_attention`, each on the route `_use_pallas` gives:
    SD's cross-attention (77 text tokens, heads of 40), JiT-H's heads of 80
    and a float (additive) mask take the plain version, with finite
    gradients (the mask's too); D = 192 and 256 and 70,000 (batch, head)
    pairs take the kernels and agree with the plain version."""

    def run(name, q, k, v, expected, mask=None, grad=True):
        leaves = [t.requires_grad_(grad) for t in (q, k, v)] + ([mask] if mask is not None and grad else [])
        before = collections.Counter(_build.LAUNCHES)
        with torch.set_grad_enabled(grad):
            y = attention.dot_product_attention(q, k, v, mask=mask)
            grads = torch.autograd.grad(y.float().square().sum(), [t for t in leaves if t.requires_grad]) if grad else ()
        launched = dict(collections.Counter(_build.LAUNCHES) - before)
        if launched != expected:
            raise AssertionError(f"{name}: launches {launched}, expected {expected}")
        want = attention._attention_plain(q.detach(), k.detach(), v.detach(), mask=mask, scale=1 / math.sqrt(q.shape[-1]))
        _, rel_err = errors(y.detach(), want)
        finite = all(bool(torch.isfinite(t).all()) for t in grads)
        tol = TOL_ATTN[q.dtype]
        log(f"  {name}: q {tuple(q.shape)}, k {tuple(k.shape)} {str(q.dtype)[6:]}, launches {launched or 'none'}, "
            f"rel err {rel_err:.3e} against the plain version (tol {tol}), {len(grads)} finite gradients: {finite}")
        if rel_err > tol or not finite:
            raise AssertionError(f"{name}: the attention or its gradients disagree")

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=generator, device="cuda").to(dtype)

    run("SD cross-attention", randn(2, 8, 1024, 40), randn(2, 8, 77, 40), randn(2, 8, 77, 40), {})
    run("JiT-H heads of 80", randn(2, 16, 256, 80), randn(2, 16, 256, 80), randn(2, 16, 256, 80), {})
    mask = (2 * torch.randn((512, 512), generator=generator, device="cuda")).requires_grad_()
    run("float mask", randn(2, 3, 512, 64), randn(2, 3, 512, 64), randn(2, 3, 512, 64), {}, mask=mask)
    for D in (192, 256):
        x = [randn(2, 4, 512, D) for _ in range(3)]
        run(f"D = {D}, training", *x, {"attention_fwd_lse": 1, "attention_bwd": 1})
        run(f"D = {D}, inference", *(t.detach() for t in x), {"attention_fwd": 1}, grad=False)
    run("70,000 (batch, head) pairs", *(randn(35000, 2, 64, 32) for _ in range(3)), {"attention_fwd": 1}, grad=False)


class InjectedDropout(torch.nn.Module):
    r"""The FFN's `Dropout` with its keep masks drawn on the CPU from a numpy
    generator shared by the CPU and card models, call by call, so that both
    drop the same activations (as the attention's seed words are injected)."""

    def __init__(self, rate: float, rng: np.random.Generator) -> None:
        super().__init__()
        self.rate, self.rng = rate, rng

    def forward(self, x, generator=None):
        keep = torch.from_numpy(self.rng.random(tuple(x.shape)) >= self.rate).to(x.device)
        return torch.where(keep, x / (1 - self.rate), 0.0).to(x.dtype)


def check_masked_slice(generator) -> dict:
    r"""Phase 21: the ViT of phase 17 (64 x 64 images, 1024 tokens) with
    attention and FFN dropout 0.1, on the CPU and on the card, float32, same
    weights, noise and injected seed words and FFN masks: the loss and every
    parameter's gradient of two steps, with exactly 2 dropout forwards and 2
    dropout backwards per step; then `checkpointing=True` against `False` on
    the card for one generator state. Then a `MultiheadSelfAttention` at
    L = 1024 with a key-padding mask, CPU against card: with and without
    dropout under grad (the biased forms' forward and backward), and the
    three inference forms. Returns the launches of the slice's run."""

    config, _ = DIT_SLICES[1]
    rng = np.random.default_rng(2)
    words = torch.tensor(SEED_WORDS, dtype=torch.int32)
    _build.LAUNCHES.clear()
    injected = attention._dropout_seed
    attention._dropout_seed = lambda generator, device: words.to(device)
    try:
        def make(device, masks):
            vit = ViT(3, 3, **config, dropout=DROPOUT, device=device)
            for block in vit.blocks:
                block.drop = InjectedDropout(DROPOUT, masks)
            return KarrasDenoiser(Modulated(vit, config["mod_features"], device=device), VPSchedule())

        cpu, card = make("cpu", np.random.default_rng(3)), make("cuda", np.random.default_rng(3))
        state = {}
        for key, value in cpu.backbone.state_dict().items():
            scale = 0.2 if key.endswith("bias") else 1 / math.sqrt(value.shape[-1])
            state[key] = torch.from_numpy((scale * rng.standard_normal(value.shape)).astype(np.float32))
        cpu.backbone.load_state_dict(state)
        card.backbone.load_state_dict(state)
        x = torch.from_numpy(rng.standard_normal((4, DIT64_SIDE, DIT64_SIDE, 3)).astype(np.float32))
        t = torch.from_numpy(rng.uniform(0.05, 0.95, 4).astype(np.float32))

        for i in range(2):
            z = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
            losses = {}
            for device, denoiser in (("cpu", cpu), ("cuda", card)):
                denoiser.zero_grad(set_to_none=True)
                generator_ = torch.Generator(device=device)
                loss = denoiser._loss(x.to(device), t.to(device), z.to(device), generator=generator_)
                loss.backward()
                losses[device] = loss.item()
            loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
            worst, worst_name = 0.0, ""
            for (name, a), (_, b) in zip(cpu.named_parameters(), card.named_parameters()):
                _, err = errors(b.grad.cpu(), a.grad)
                worst, worst_name = max((worst, worst_name), (err, name))
            log(f"  dropout slice {DIT64_SIDE}x{DIT64_SIDE}, step {i}: loss {losses['cpu']:.6f}, rel err {loss_err:.3e}; "
                f"worst parameter gradient rel err {worst:.3e} ({worst_name}) (tol {TOL_SLICE})")
            if loss_err > TOL_SLICE or worst > TOL_SLICE:
                raise AssertionError("the dropout slice's loss or gradients on the card disagree with the CPU")
        expected = {name: 2 * n for name, n in {"attention_fwd_lse_dropout": 2, "attention_bwd_dropout": 2}.items()}
        if dict(_build.LAUNCHES) != expected:
            raise AssertionError(f"the dropout slice launched {dict(_build.LAUNCHES)}, expected {expected}")
        log(f"  kernel launches of the dropout slice on the card: {dict(_build.LAUNCHES)}, expected {expected}")
    finally:
        attention._dropout_seed = injected

    # checkpointing on the card: the recompute drops what the forward dropped
    grads = []
    for checkpointing in (False, True):
        torch.manual_seed(0)
        vit = ViT(3, 3, **config, dropout=DROPOUT, checkpointing=checkpointing, device="cuda")
        denoiser = KarrasDenoiser(Modulated(vit, config["mod_features"], device="cuda"), VPSchedule())
        denoiser.backbone.load_state_dict(state)
        loss = denoiser._loss(x.cuda(), t.cuda(), z.cuda(), generator=torch.Generator(device="cuda").manual_seed(7))
        loss.backward()
        grads.append([p.grad for p in denoiser.parameters()])
    worst = max(errors(b, a)[1] for a, b in zip(*grads))
    log(f"  checkpointing=True against False on the card, dropout {DROPOUT}: worst gradient rel err {worst:.3e} "
        f"(tol {TOL_ATTN[torch.float32]})")
    if worst > TOL_ATTN[torch.float32]:
        raise AssertionError("the gradients under checkpointing differ: the recompute dropped other weights")

    # a masked MSA layer at L = 1024: the biased forms under grad and the
    # inference forms, CPU against card, injected seed words
    before = collections.Counter(_build.LAUNCHES)
    attention._dropout_seed = lambda generator, device: words.to(device)
    try:
        msa = {d: MultiheadSelfAttention(128, attention_heads=2, dropout=DROPOUT, device=d) for d in ("cpu", "cuda")}
        msa["cuda"].load_state_dict(msa["cpu"].state_dict())
        xs = torch.from_numpy(rng.standard_normal((4, 1024, 128)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((4, 1024, 128)).astype(np.float32))
        pad = padding_mask(4, 1024, torch.Generator(device="cuda").manual_seed(1))
        for label, masked, dropped, grad, launched in (
            ("mask, grad", True, False, True, {"attention_fwd_lse_bias": 1, "attention_bwd_bias": 1}),
            ("mask and dropout, grad", True, True, True,
             {"attention_fwd_lse_bias_dropout": 1, "attention_bwd_bias_dropout": 1}),
            ("mask, inference", True, False, False, {"attention_fwd_bias": 1}),
            ("mask and dropout, inference", True, True, False, {"attention_fwd_bias_dropout": 1}),
            ("dropout, inference", False, True, False, {"attention_fwd_dropout": 1}),
        ):
            outs = {}
            for device, layer in msa.items():
                layer.zero_grad(set_to_none=True)
                xd = xs.detach().to(device).requires_grad_(grad)
                mask = pad.to(device) if masked else None
                generator_ = torch.Generator(device=device) if dropped else None
                start = collections.Counter(_build.LAUNCHES)
                with torch.set_grad_enabled(grad):
                    y = layer(xd, mask=mask, generator=generator_)
                    if grad:
                        (y * w.to(device)).sum().backward()
                if device == "cpu" and collections.Counter(_build.LAUNCHES) != start:
                    raise AssertionError("a kernel ran on the CPU path")
                if device == "cuda" and dict(collections.Counter(_build.LAUNCHES) - start) != launched:
                    raise AssertionError(f"masked MSA ({label}) launched "
                                         f"{dict(collections.Counter(_build.LAUNCHES) - start)}, expected {launched}")
                outs[device] = [y.detach().cpu()] + ([xd.grad.cpu()] + [p.grad.cpu() for p in layer.parameters()]
                                                     if grad else [])
            worst = max(errors(b, a)[1] for a, b in zip(outs["cpu"], outs["cuda"]))
            log(f"  masked MSA (4, 1024, 128), batch padding mask, {label}: worst rel err of the output"
                f"{' and gradients' if grad else ''} {worst:.3e} (tol {TOL_SLICE}); launches {launched}")
            if worst > TOL_SLICE:
                raise AssertionError(f"masked MSA ({label}) on the card disagrees with the CPU")
    finally:
        attention._dropout_seed = injected

    launches = dict(collections.Counter(_build.LAUNCHES) - before)
    return launches


def unet32_model(generator: torch.Generator, norm: str) -> KarrasDenoiser:
    r"""bench.py's unet32 denoiser with `norm`, the modules' own
    initialization drawn from `generator`, cast to bf16 as a whole."""

    unet = UNet(3, 3, **UNET32, norm=norm, device="cuda", generator=generator)
    backbone = Modulated(unet, UNET32["mod_features"], device="cuda", generator=generator)

    return KarrasDenoiser(backbone.to(torch.bfloat16), VPSchedule())


def check_group_stats(generator) -> dict:
    r"""The statistics kernel against its plain version on 100 + 3 N inputs
    (|mean| / std ~ 33), in bf16 and float32, at unet32's three GroupNorm
    shapes (timed in bf16 beside the plain version, `torch.var_mean` and the
    bound; the entry sums the 18 calls of one train step) and at the JAX
    package's production shapes (tests/test_ops_tpu.py), and both against
    the exact statistics in float64."""

    entry = new_entry()
    count = UNET_TRAIN_CALLS_PER_STEP["group_stats"] // len(UNET_GN_SHAPES)

    cases = [(shape, UNET_GROUPS, True) for shape in UNET_GN_SHAPES] + [
        ((8, 65536, 256), 32, False),
        ((8, 16384, 512), 32, False),
        ((2, 4096, 1024), 32, False),
        ((4, 9216, 384), 32, False),
        ((8, 66049, 256), 32, False),
        ((2, 4096, 192), 24, False),
    ]
    for shape, groups, timed in cases:
        B, HW, C = shape
        for dtype in (torch.bfloat16, torch.float32):
            x = (100 + 3 * torch.randn(shape, generator=generator, device="cuda")).to(dtype)
            rows = norm._stats_rows(B, HW, C, x.element_size())
            mean, var = norm._stats_kernel(x, groups)
            want_mean, want_var = norm._stats_kernel_plain(x, groups, rows)
            exact_var, exact_mean = torch.var_mean(x.double().view(B, HW, groups, -1), dim=(1, 3), correction=0)

            mean_abs, mean_rel = errors(mean, want_mean)
            var_rel = ((var.double() - want_var.double()).abs() / want_var.double()).max().item()
            exact_rel = ((var.double() - exact_var).abs() / exact_var).max().item()
            exact_mean_rel = errors(mean, exact_mean)[1]
            tol = TOL_STATS[dtype]
            line = (f"  group_stats {shape} G={groups} {str(dtype)[6:]} ({math.ceil(HW / rows)} tiles of {rows} rows; "
                    f"JAX's TPU kernel {'covers' if norm.stats_kernel_eligible(shape) else 'does not cover'} it): "
                    f"mean rel {mean_rel:.3e}, var rel {var_rel:.3e}; against float64 mean {exact_mean_rel:.3e}, "
                    f"var {exact_rel:.3e} (tol {tol})")
            if max(mean_rel, var_rel, exact_rel, exact_mean_rel) > tol:
                raise AssertionError(line)

            if timed and dtype == torch.bfloat16:
                xv = x.view(B, HW, groups, C // groups)
                ms = elapsed_ms(lambda: norm._stats_kernel(x, groups))
                plain = elapsed_ms(lambda: norm._stats_kernel_plain(x, groups, rows))
                library = elapsed_ms(lambda: torch.var_mean(xv, dim=(1, 3), correction=0))
                # x read once and (mean, var) written once; a subtraction, a
                # square and two sums per element, float32 on the CUDA cores
                bound, by = bound_ms(x.numel() * x.element_size() + 2 * B * groups * 4, 4 * x.numel(), torch.float32)
                add_timing(entry, count, ms, plain, library, bound, by, mean_abs, max(mean_rel, var_rel))
                line += (f"; {ms:.4f} ms ({x.numel() * x.element_size() / ms / 1e6:.1f} GB/s), plain {plain:.4f} ms, "
                         f"torch.var_mean {library:.4f} ms, bound {bound:.4f} ms ({by})")
            log(line)
            del x
        torch.cuda.empty_cache()

    return entry


def check_group_norm_training(generator) -> None:
    r"""`group_stats`'s gradient on the card (the kernel's statistics)
    against the plain route's, and `group_norm` / `group_norm_silu` forward
    and backward on the card (the GroupNorm and statistics kernels, the
    analytic backward) against autograd through the plain version, at
    unet32's and ADM's shapes, float32 and bf16, with exact launches."""

    B, HW, C = UNET_GN_SHAPES[0]
    x = (100 + 3 * torch.randn((B, HW, C), generator=generator, device="cuda")).requires_grad_()
    gm, gv = (torch.randn((B, UNET_GROUPS), generator=generator, device="cuda") for _ in range(2))
    grads = []
    for implementation in (None, "plain"):
        before = collections.Counter(_build.LAUNCHES)
        mean, var = norm.group_stats(x, UNET_GROUPS, implementation)
        (grad,) = torch.autograd.grad((mean, var), x, (gm, gv))
        grads.append(grad)
        launched = dict(collections.Counter(_build.LAUNCHES) - before)
        if launched != ({"group_stats": 1} if implementation is None else {}):
            raise AssertionError(f"group_stats({implementation}) launched {launched}")
    _, err = errors(*grads)
    log(f"  group_stats gradient {(B, HW, C)} G={UNET_GROUPS}, kernel route against plain: rel err {err:.3e} "
        f"(tol {TOL_GN_GRAD[torch.float32]})")
    if err > TOL_GN_GRAD[torch.float32]:
        raise AssertionError("group_stats' gradient on the card disagrees with the plain route")
    del x, grads

    # (shape, groups, silu, modulated): unet32's three, ADM's ResBlock
    # prologue (SiLU, scale-shift) and attention pre-norm
    cases = [(shape, UNET_GROUPS, False, False) for shape in UNET_GN_SHAPES] + [
        ((8, 4096, 256), 32, True, True),
        ((8, 1024, 512), 32, False, False),
    ]
    for (B, HW, C), groups, silu, modulated in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((B, HW, C), generator=generator, device="cuda") * 2 + 0.5).to(dtype)
            g = torch.randn((B, HW, C), generator=generator, device="cuda").to(dtype)
            scale = 1 + 0.5 * torch.randn(C, generator=generator, device="cuda")
            bias = 0.5 * torch.randn(C, generator=generator, device="cuda")
            mods = [0.3 * torch.randn((B, C), generator=generator, device="cuda") for _ in range(2)] if modulated else [None, None]

            leaves = [t.detach().clone().requires_grad_() for t in (x, scale, bias, *(m for m in mods if m is not None))]
            ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]

            def inputs(ts):
                ms = ts[3:] if modulated else (None, None)
                return dict(scale=ts[1], bias=ts[2], mod_scale=ms[0], mod_shift=ms[1])

            before = collections.Counter(_build.LAUNCHES)
            fn = norm.group_norm_silu if silu else norm.group_norm
            y = fn(leaves[0], groups, **inputs(leaves))
            y.backward(g)
            launched = dict(collections.Counter(_build.LAUNCHES) - before)
            expected = {"group_norm_silu" if silu else "group_norm": 1, "group_stats": 1}
            if launched != expected:
                raise AssertionError(f"group_norm under grad launched {launched}, expected {expected}")

            # autograd through the plain version, no custom backward
            xf, P, Q = norm._compose_affine(ref_leaves[0], groups, *inputs(ref_leaves).values())
            want = norm._group_norm_plain(xf, P, Q, groups, 1e-5, silu).reshape(x.shape)
            want.backward(g)

            tol = TOL_GN_GRAD[dtype]
            errs = {"y": errors(y, want)[1]}
            errs.update({name: errors(a.grad, b.grad)[1] for name, a, b in
                         zip(("x", "scale", "bias", "mod_scale", "mod_shift"), leaves, ref_leaves)})
            line = (f"  group_norm{'_silu' if silu else ''} {(B, HW, C)} G={groups} mod={modulated} {str(dtype)[6:]} "
                    f"forward and backward on the card against autograd through the plain version: "
                    + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {tol}; y {TOL_GN[dtype]})")
            if errs.pop("y") > TOL_GN[dtype] or max(errs.values()) > tol:
                raise AssertionError(line)
            log(line)
            del x, g, y, want, leaves, ref_leaves
        torch.cuda.empty_cache()


def unet32_conv_calls(generator) -> list:
    r"""The convolutions of one full-width unet32 forward (bf16, batch 256)
    that `can_use_conv3x3` admits: (layer, input, the layer's output)."""

    denoiser = unet32_model(generator, "layer")
    calls = []
    hooks = [
        m.register_forward_hook(lambda m, args, out: calls.append((m, args[0], out)))
        for m in denoiser.modules() if isinstance(m, Conv)
    ]
    x = torch.randn((UNET_BATCH, 32, 32, 3), generator=generator, device="cuda")
    with torch.inference_mode():
        denoiser(x, torch.full((UNET_BATCH,), 0.5, device="cuda"))
    for hook in hooks:
        hook.remove()

    admitted = [
        (m, h, out) for m, h, out in calls
        if conv.can_use_conv3x3(tuple(h.shape), (*m.weight.shape[2:], *m.weight.shape[1::-1]), m.stride, m.padding,
                                m.periodic)
    ]
    shapes = collections.Counter((tuple(h.shape), m.weight.shape[0]) for m, h, _ in admitted)
    log(f"  {len(calls)} convolutions per unet32 forward, {len(admitted)} admitted by can_use_conv3x3: {dict(shapes)}")
    if len(admitted) != UNET_CONV3X3_CALLS["conv3x3"]:
        raise AssertionError(f"expected {UNET_CONV3X3_CALLS} admitted convolutions per unet32 forward")

    return admitted


def check_conv3x3(generator) -> tuple[dict, dict]:
    r"""The conv3x3 kernel against its plain version at unet32's admitted
    shapes (timed in bf16 beside the plain version, `F.conv2d` on
    `channels_last` and the bound; the entry sums one forward's 25 calls),
    at the JAX package's test shapes and at two ragged shapes, one on each
    bf16 form, in bf16 and float32, each case's form as the C entry
    chooses it and `conv._conv3x3_form` mirrors it; the tensor-core cases
    also against the float32 sums of the same bf16 values at `TOL_CONV_TC`;
    its autograd gradient against `F.conv2d`'s; then the entry point driven
    at the 25 admitted calls of one unet32 forward, on their own inputs and
    weights, against the layers' cuDNN outputs, every call on the
    tensor-core form. Returns the entry and that run's launches."""

    entry = new_entry()
    admitted = unet32_conv_calls(generator)
    counts = collections.Counter((tuple(h.shape), m.weight.shape[0]) for m, h, _ in admitted)
    lib = _build.library()

    cases = [(*x_shape, K) for x_shape, K in counts] + [
        (2, 32, 32, 256, 256), (1, 64, 64, 128, 128), (3, 13, 11, 40, 72), (3, 13, 11, 40, 70)
    ]
    for B, H, W, C, K in cases:
        count = counts.get(((B, H, W, C), K), 0)
        for dtype in (torch.bfloat16, torch.float32):
            form = conv._conv3x3_form((B, H, W, C), K, dtype)
            chosen = "tensor_cores" if lib.azula_conv3x3_tensor_cores(C, K, conv._DTYPES[dtype]) else "cuda_cores"
            if form != chosen:
                raise AssertionError(f"conv3x3 {(B, H, W, C, K)} {dtype}: the C entry takes {chosen}, "
                                     f"_conv3x3_form says {form}")
            x = torch.randn((B, H, W, C), generator=generator, device="cuda").to(dtype)
            w = (torch.randn((3, 3, C, K), generator=generator, device="cuda") / math.sqrt(9 * C)).to(dtype)
            got = conv._conv3x3_kernel(x, w)
            want = conv._conv3x3_plain(x, w)
            abs_err, rel_err = errors(got, want)
            tol = TOL_CONV[dtype]
            line = (f"  conv3x3 (B, H, W, C, K) = {(B, H, W, C, K)} {str(dtype)[6:]} x{count}/fwd, {form}: "
                    f"max abs err {abs_err:.3e}, rel {rel_err:.3e} (tol {tol})")
            if rel_err > tol:
                raise AssertionError(line)
            if form == "tensor_cores":
                _, sums_err = errors(got, conv._conv3x3_plain(x.float(), w.float()))
                line += f"; against the float32 sums {sums_err:.3e} (tol {TOL_CONV_TC})"
                if sums_err > TOL_CONV_TC:
                    raise AssertionError(line)

            if count and dtype == torch.bfloat16:
                xc = x.permute(0, 3, 1, 2)  # channels_last memory, cuDNN's NHWC
                wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                ops = 2 * B * H * W * C * K * 9
                ms = elapsed_ms(lambda: conv._conv3x3_kernel(x, w))
                plain = elapsed_ms(lambda: conv._conv3x3_plain(x, w))
                library = elapsed_ms(lambda: F.conv2d(xc, wc, padding=1))
                bound, by = bound_ms((x.numel() + w.numel() + got.numel()) * x.element_size(), ops, dtype)
                add_timing(entry, count, ms, plain, library, bound, by, abs_err, rel_err, ops)
                line += (f"; {ms:.4f} ms ({speed(ops, ms, bound)}), plain {plain:.4f} ms, "
                         f"F.conv2d {library:.4f} ms, bound {bound:.4f} ms ({by})")
            log(line)
            del x, w, got, want

    # the gradient: the library convolution's, as JAX's custom vjp
    x = torch.randn((2, 16, 16, 128), generator=generator, device="cuda", requires_grad=True)
    w = (torch.randn((3, 3, 128, 128), generator=generator, device="cuda") / 34).requires_grad_()
    g = torch.randn((2, 16, 16, 128), generator=generator, device="cuda")
    got = torch.autograd.grad(conv.conv3x3(x, w), (x, w), g)
    want = torch.autograd.grad(
        F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1), (x, w), g
    )
    errs = [errors(a, b)[1] for a, b in zip(got, want)]
    log(f"  conv3x3 gradient (2, 16, 16, 128 -> 128) float32 against F.conv2d's: dx {errs[0]:.3e}, "
        f"dw {errs[1]:.3e} (tol {TOL_CONV[torch.float32]})")
    if max(errs) > TOL_CONV[torch.float32]:
        raise AssertionError("conv3x3's gradient disagrees with F.conv2d's")

    # the entry point at unet32's admitted calls: the main path of the kernel
    with torch.inference_mode():
        _build.LAUNCHES.clear()
        worst = 0.0
        for m, h, out in admitted:
            y = conv.conv3x3(h, m.weight.permute(2, 3, 1, 0).contiguous()) + m.bias
            worst = max(worst, errors(y, out)[1])
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    log(f"  conv3x3 at the {len(admitted)} admitted calls of a unet32 forward, plus the layer's bias, against its "
        f"cuDNN output: worst rel err {worst:.3e} (tol {TOL_CONV[torch.bfloat16]}); launches {launches}")
    if worst > TOL_CONV[torch.bfloat16] or launches != UNET_CONV3X3_CALLS:
        raise AssertionError("conv3x3 at unet32's calls disagrees with the layers, or its launches are not exact")
    del admitted
    torch.cuda.empty_cache()

    return entry, launches


def check_unet_slice() -> None:
    r"""The tiny UNet denoiser on the CPU (plain versions) and on the card
    (kernels), same random weights and injected noise, float32, with
    norm="group" and norm="layer": the denoiser's output and a 4-step DDIM
    trajectory; the loss and every parameter's gradient of one step, the
    parameters after three AdamW steps; `checkpointing=True` against False
    on the card; exact launch counts."""

    rng = np.random.default_rng(2)

    for norm_kind in ("group", "layer"):
        def make(device):
            unet = UNet(3, 3, norm=norm_kind, **TINY_UNET, device=device)
            return KarrasDenoiser(Modulated(unet, TINY_UNET["mod_features"], device=device), VPSchedule())

        cpu, card = make("cpu"), make("cuda")
        state = {}
        for key, value in cpu.backbone.state_dict().items():
            scale = 0.2 if key.endswith("bias") else 1 / math.sqrt(value[0].numel())
            state[key] = torch.from_numpy((scale * rng.standard_normal(value.shape)).astype(np.float32))
        cpu.backbone.load_state_dict(state)
        card.backbone.load_state_dict(state)

        norms = TINY_UNET_NORMS if norm_kind == "group" else 0
        x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32))
        t = torch.from_numpy(rng.uniform(0.05, 0.95, 4).astype(np.float32))

        _build.LAUNCHES.clear()
        with torch.inference_mode():
            for tt in (0.3, 0.9):
                before = dict(_build.LAUNCHES)
                want = cpu(x, torch.tensor(tt)).mean
                if dict(_build.LAUNCHES) != before:
                    raise AssertionError("a kernel ran on the CPU path")
                got = card(x.cuda(), torch.tensor(tt, device="cuda")).mean
                _, err = errors(got.cpu(), want)
                log(f"  unet denoiser norm={norm_kind} t={tt}: rel err {err:.3e} (tol {TOL_SLICE})")
                if err > TOL_SLICE:
                    raise AssertionError("the tiny UNet denoiser on the card disagrees with the CPU")

            want = DDIMSampler(cpu, steps=4)(x)
            got = DDIMSampler(card, steps=4)(x.cuda())
            _, err = errors(got.cpu(), want)
            log(f"  unet DDIM-4 trajectory norm={norm_kind}: rel err {err:.3e} (tol {TOL_TRAJECTORY})")
            if err > TOL_TRAJECTORY:
                raise AssertionError("the tiny UNet DDIM trajectory on the card disagrees with the CPU")
        expected = {"group_norm": norms * 6} if norms else {}
        log(f"  kernel launches of the inference slice: {dict(_build.LAUNCHES)}, expected {expected}")
        if dict(_build.LAUNCHES) != expected:
            raise AssertionError("the tiny UNet's inference launches are not exact")

        optimizers = [torch.optim.AdamW(d.parameters(), **train.OPTAX_ADAMW) for d in (cpu, card)]
        _build.LAUNCHES.clear()
        for i in range(3):
            z = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
            losses = {}
            for device, denoiser in (("cpu", cpu), ("cuda", card)):
                before = dict(_build.LAUNCHES)
                loss = denoiser._loss(x.to(device), t.to(device), z.to(device))
                loss.backward()
                if device == "cpu" and dict(_build.LAUNCHES) != before:
                    raise AssertionError("a kernel ran on the CPU path")
                losses[device] = loss.item()

            if i == 0:
                loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
                worst, worst_name = 0.0, ""
                for (name, a), (_, b) in zip(cpu.named_parameters(), card.named_parameters()):
                    _, err = errors(b.grad.cpu(), a.grad)
                    worst, worst_name = max((worst, worst_name), (err, name))
                log(f"  unet train slice norm={norm_kind}: loss {losses['cpu']:.6f}, rel err {loss_err:.3e}; "
                    f"worst parameter gradient rel err {worst:.3e} ({worst_name}) (tol {TOL_SLICE})")
                if loss_err > TOL_SLICE or worst > TOL_SLICE:
                    raise AssertionError("the tiny UNet's loss or gradients on the card disagree with the CPU")

            for optimizer in optimizers:
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)

        diff = max((b.detach().cpu() - a.detach()).abs().max().item()
                   for a, b in zip(cpu.parameters(), card.parameters()))
        log(f"  unet train slice norm={norm_kind}: parameters after three AdamW steps, max abs diff {diff:.3e} "
            f"(tol {TOL_TRAIN_PARAMS})")
        if diff > TOL_TRAIN_PARAMS:
            raise AssertionError("the tiny UNet's parameters on the card disagree with the CPU")

        # checkpointing on the card: the blocks recompute in the backward,
        # running their GroupNorm and its statistics again
        grads = []
        for checkpointing in (False, True):
            for module in card.modules():
                if isinstance(module, UNetBlock):
                    module.checkpointing = checkpointing
            card._loss(x.cuda(), t.cuda(), z.cuda()).backward()
            grads.append([p.grad.clone() for p in card.parameters()])
            card.zero_grad(set_to_none=True)
        worst = max(errors(b, a)[1] for a, b in zip(*grads))
        log(f"  unet checkpointing=True against False on the card, norm={norm_kind}: worst gradient rel err "
            f"{worst:.3e} (tol {TOL_GN_GRAD[torch.float32]})")
        if worst > TOL_GN_GRAD[torch.float32]:
            raise AssertionError("the tiny UNet's gradients under checkpointing differ")

        # 3 steps and the plain run under grad: one GroupNorm and one
        # statistics launch per norm; the checkpointed run: twice each
        expected = {"group_norm": norms * 6, "group_stats": norms * 6} if norms else {}
        log(f"  kernel launches of the training slice: {dict(_build.LAUNCHES)}, expected {expected}")
        if dict(_build.LAUNCHES) != expected:
            raise AssertionError("the tiny UNet's training launches are not exact")


def unet32_sampling(generator) -> dict:
    r"""unet32 DDIM-64 at full width as `bench.py` builds it (norm="layer"),
    bf16, batch 256, from `sampler.init` noise: finite, with no launch of our
    kernels. Prints images/s, ms/step, peak memory and a profile of one
    step."""

    denoiser = unet32_model(generator, "layer")
    n_params = sum(p.numel() for p in denoiser.parameters())
    sampler = DDIMSampler(denoiser, eta=0.0, steps=UNET_STEPS)
    x = sampler.init((UNET_BATCH, 32, 32, 3), generator=generator)
    log(f"unet32: {n_params:,} parameters")

    with torch.inference_mode():
        grid = sampler.timesteps.cuda()
        sampler.step(x, grid[0], grid[1])  # warm-up
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
        raise AssertionError("the unet32 trajectory is not finite")
    log(f"launches {launches}, expected none (norm='layer' runs no kernel of ours)")
    if launches:
        raise AssertionError("the unet32 sampling path launched a kernel")
    result = dict(images_s=UNET_BATCH / seconds, ms=seconds / UNET_STEPS * 1e3, peak_gib=peak / 2**30)  # noqa: C408
    log(f"unet32 trajectory {seconds:.3f} s, {result['images_s']:.4f} images/s, {result['ms']:.3f} ms/step, "
        f"peak memory {result['peak_gib']:.2f} GiB; sample mean {y.float().mean().item():.4f}, "
        f"std {y.float().std().item():.4f}")
    with torch.inference_mode():
        profile_step(lambda: sampler.step(x, grid[0], grid[1]))
    del denoiser, sampler, x, y
    torch.cuda.empty_cache()

    return result


def masked_source(name: str) -> tuple[str, str]:
    r"""The source and the TPU kernel of a masked or dropout form."""

    entry = name.split("_bias")[0].split("_dropout")[0]
    if entry == "attention_bwd":
        return "attention_bwd.cu", "azula_tpu/ops/attention.py:1102 (_pallas_attention_bwd, bias and dropout)"
    lse = ", with_lse=True" if entry == "attention_fwd_lse" else ""
    if "dropout" in name:
        return "attention_fwd.cu", f"azula_tpu/ops/attention.py:337 (_pallas_attention_blocked, dropout{lse})"
    return "attention_fwd.cu", (f"azula_tpu/ops/attention.py:92 (_pallas_attention, bias{lse}), "
                                f"azula_tpu/ops/attention.py:566 (_pallas_attention_batched, bias{lse})")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=64, help="DDIM steps of the full-width ADM run")
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
    forward, backward = tc_ptxas_summaries()
    log(f"ptxas -v of the bf16 tensor-core attention forward: {forward}")
    log(f"ptxas -v of the bf16 tensor-core attention backward: {backward}")
    msa_ptxas, conv_ptxas = redesign_ptxas_summaries()
    log(f"ptxas -v of the bf16 tensor-core fused MSA: {msa_ptxas}")
    log(f"ptxas -v of the bf16 tensor-core conv3x3: {conv_ptxas}")
    flash_forward, flash_backward = flash_ptxas_summaries()
    log(f"ptxas -v of the bf16 tensor-core flash_blhd forward: {flash_forward}")
    log(f"ptxas -v of the bf16 tensor-core flash_blhd backward: {flash_backward}")
    if not all((forward, backward, msa_ptxas, conv_ptxas, flash_forward, flash_backward)):
        raise AssertionError("ptxas reported no tensor-core attention, fused MSA, conv3x3 or flash_blhd kernel")

    log("== 3. kernels against their plain versions at the main path's shapes")
    generator = torch.Generator(device="cuda").manual_seed(0)
    denoiser = full_width_model(generator)
    sampler = DDIMSampler(denoiser, eta=0.0, steps=args.steps)
    x = sampler.init((BATCH, 256, 256, 3), generator=generator)

    with torch.inference_mode(), recording() as (calls, affine):
        denoiser(x, sampler.timesteps[0].cuda())
    recorded = collections.Counter()
    for key, count in calls.items():
        recorded[kernel_name(key)] += count
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
        profile_step(lambda: sampler.step(x, time_grid[0], time_grid[1]))

    del denoiser, sampler, x, y
    torch.cuda.empty_cache()

    log("== 6. dit32 kernels against their plain versions at the main path's shapes")
    dit = dit32_model(generator)
    dit_sampler = DDIMSampler(dit, eta=0.0, steps=DIT_STEPS)
    xd = dit_sampler.init((DIT_BATCH, 32, 32, 3), generator=generator)

    with torch.inference_mode(), recording() as (calls, _):
        dit(xd, dit_sampler.timesteps[0].cuda())
    recorded = collections.Counter()
    for key, count in calls.items():
        recorded[kernel_name(key)] += count
    log(f"calls in one full-width dit32 forward: {dict(recorded)}; {list(calls)}")
    if dict(recorded) != DIT_CALLS_PER_FORWARD:
        raise AssertionError(f"expected {DIT_CALLS_PER_FORWARD} calls per dit32 forward")

    with torch.inference_mode():
        msa = check_fused_msa(calls, generator)
    check_forward_only(generator)

    log("== 7. the dit32 slices: CPU plain versions against the card's kernels, float32")
    check_dit_slice()

    log(f"== 8. dit32 full width: bf16, batch {DIT_BATCH}, DDIM-{DIT_STEPS}")
    with torch.inference_mode():
        dit_grid = dit_sampler.timesteps.cuda()
        dit_sampler.step(xd, dit_grid[0], dit_grid[1])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        yd = dit_sampler(xd)
        torch.cuda.synchronize()
        dit_seconds = time.perf_counter() - t0
        dit_launches = dict(_build.LAUNCHES)

    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(yd).all()) or yd.shape != xd.shape:
        raise AssertionError("the full-width dit32 trajectory is not finite")
    expected = {name: n * DIT_STEPS for name, n in DIT_CALLS_PER_FORWARD.items()}
    log(f"launches {dit_launches}, expected {expected}")
    if dit_launches != expected:
        raise AssertionError("the dit32 path's launch counts are not exact")
    log(f"dit32 trajectory {dit_seconds:.3f} s, {DIT_BATCH / dit_seconds:.4f} images/s, "
        f"{dit_seconds / DIT_STEPS * 1e3:.3f} ms/step, peak memory {peak / 2**30:.2f} GiB; "
        f"sample mean {yd.float().mean().item():.4f}, std {yd.float().std().item():.4f}")
    with torch.inference_mode():
        profile_step(lambda: dit_sampler.step(xd, dit_grid[0], dit_grid[1]))
    del dit_sampler, xd, yd
    torch.cuda.empty_cache()

    log("== 9. flash kernels against their plain versions at the dit32 training shape")
    flash = check_flash_blhd(generator)

    log("== 10. fused MSA's gradient through the flash route at the dit32 shape")
    check_composition_grad(generator)

    log("== 11. the training slice: CPU plain versions against the card's kernels, float32")
    check_train_slice(32, {name: 2 for name in DIT_TRAIN_CALLS_PER_STEP})

    log(f"== 12. dit32 training at full width: bf16, batch {DIT_BATCH}, AdamW, "
        f"{DIT_TRAIN_WARMUP} warm-up + {DIT_TRAIN_STEPS} timed steps")
    del dit
    train_launches = train_full_width(dit32_model(generator), DIT_BATCH, 32, DIT_TRAIN_CALLS_PER_STEP, generator)["launches"]

    log("== 13. the max-free attention kernel against its plain version at the FLUX.1 shapes")
    with torch.inference_mode():
        mf = check_max_free(generator)

    log("== 14. the tiny Flux slice: CPU plain versions against the card's kernel, float32")
    check_flux_slice()

    log(f"== 15. FLUX.1-dev at full width: bf16, {FLUX_SIDE * 16} px, {FLUX_TEXT} T5 tokens, "
        f"guidance {FLUX_GUIDANCE}, DDIM-{FLUX_STEPS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flux = FluxDenoiser(FluxTransformer(device="cuda", dtype=torch.bfloat16, generator=generator), DecaySchedule())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in flux.parameters())
    log(f"FLUX.1-dev: {n_params:,} bf16 parameters drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    cond = dict(  # noqa: C408  random prompt embeddings: T5 tokens and the CLIP pooled vector
        prompt_t5=torch.randn((FLUX_BATCH, FLUX_TEXT, 4096), generator=generator, device="cuda", dtype=torch.bfloat16),
        prompt_clip=torch.randn((FLUX_BATCH, 768), generator=generator, device="cuda", dtype=torch.bfloat16),
        guidance=FLUX_GUIDANCE,
    )
    flux_sampler = DDIMSampler(flux, eta=0.0, steps=FLUX_STEPS)
    xf = flux_sampler.init((FLUX_BATCH, FLUX_SIDE, FLUX_SIDE, 64), generator=generator)

    with torch.inference_mode():
        flux_grid = flux_sampler.timesteps.cuda()
        with recording() as (calls, _):
            flux_sampler.step(xf, flux_grid[0], flux_grid[1], **cond)  # warm-up
        torch.cuda.synchronize()
        expected_calls = {
            ("max_free", FLUX_SHAPE, torch.bfloat16, 1 / math.sqrt(FLUX_SHAPE[-1])): FLUX_CALLS_PER_FORWARD[
                "attention_fwd_max_free"
            ]
        }
        log(f"calls in one full-width FLUX.1-dev step: {dict(calls)}")
        if dict(calls) != expected_calls:
            raise AssertionError(f"expected {expected_calls} calls per FLUX.1-dev step")
        torch.cuda.reset_peak_memory_stats()

        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        yf = flux_sampler(xf, **cond)
        torch.cuda.synchronize()
        flux_seconds = time.perf_counter() - t0
        flux_launches = dict(_build.LAUNCHES)

    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(yf).all()) or yf.shape != xf.shape:
        raise AssertionError("the FLUX.1-dev trajectory is not finite")
    expected = {name: n * FLUX_STEPS for name, n in FLUX_CALLS_PER_FORWARD.items()}
    log(f"launches {flux_launches}, expected {expected}")
    if flux_launches != expected:
        raise AssertionError("the FLUX.1-dev path's launch counts are not exact")
    log(f"FLUX.1-dev trajectory {flux_seconds:.3f} s, {FLUX_BATCH / flux_seconds:.6f} images/s, "
        f"{flux_seconds / FLUX_STEPS * 1e3:.2f} ms/step, peak memory {peak / 2**30:.2f} GiB; "
        f"sample mean {yf.float().mean().item():.4f}, std {yf.float().std().item():.4f}")
    with torch.inference_mode():
        profile_step(lambda: flux_sampler.step(xf, flux_grid[0], flux_grid[1], **cond))
    del flux, flux_sampler, xf, yf, cond
    torch.cuda.empty_cache()

    log("== 16. attention training kernels against their plain versions at the dit64 shape")
    lse_bwd = check_attention_training(generator)

    log("== 17. the 64x64 training slice: CPU plain versions against the card's kernels, float32")
    check_train_slice(DIT64_SIDE, {name: 2 for name in DIT64_TRAIN_CALLS_PER_STEP})

    log(f"== 18. dit64 training at full width: {DIT64_SIDE}x{DIT64_SIDE} images, bf16, batch {DIT_BATCH}, AdamW, "
        f"{DIT_TRAIN_WARMUP} warm-up + {DIT_TRAIN_STEPS} timed steps")
    dit64 = train_full_width(dit32_model(generator), DIT_BATCH, DIT64_SIDE, DIT64_TRAIN_CALLS_PER_STEP, generator)
    dit64_launches = dit64["launches"]

    log("== 19. attention masks and dropout: the kernel forms against their plain versions")
    masked = check_masked_kernels(generator)

    log("== 20. calls without a kernel form, and D = 192, 256, on the card through dot_product_attention")
    check_routes(generator)

    log("== 21. the dropout and mask slices: CPU plain versions against the card's kernels, float32")
    slice_launches = check_masked_slice(generator)

    log(f"== 22. dit64 training with dropout {DROPOUT} at full width: {DIT64_SIDE}x{DIT64_SIDE} images, bf16, "
        f"batch {DIT_BATCH}, AdamW, {DIT_TRAIN_WARMUP} warm-up + {DIT_TRAIN_STEPS} timed steps")
    dit64_dropout = train_full_width(
        dit32_model(generator, dropout=DROPOUT), DIT_BATCH, DIT64_SIDE, DIT64_DROPOUT_CALLS_PER_STEP, generator,
        dropout=True,
    )
    log(f"dit64 training with dropout {DROPOUT}: {dit64_dropout['ms']:.3f} ms/step, "
        f"{dit64_dropout['images_s']:.4f} train images/s, peak {dit64_dropout['peak_gib']:.2f} GiB; without "
        f"(phase 18, this run): {dit64['ms']:.3f} ms/step, {dit64['images_s']:.4f} train images/s, "
        f"peak {dit64['peak_gib']:.2f} GiB; ratio {dit64_dropout['ms'] / dit64['ms']:.3f}")

    log("== 23. group statistics against their plain version; GroupNorm training on the card")
    stats = check_group_stats(generator)
    check_group_norm_training(generator)

    log("== 24. conv3x3 against its plain version; the entry point at unet32's admitted convolutions")
    conv3x3, conv3x3_launches = check_conv3x3(generator)

    log("== 25. the tiny UNet slice: CPU plain versions against the card's kernels, float32")
    check_unet_slice()

    log(f"== 26. unet32 full width (norm='layer', as bench.py builds it): bf16, batch {UNET_BATCH}, DDIM-{UNET_STEPS}")
    unet32_sampling(generator)

    log(f"== 27. unet32 training at full width: norm='group', then norm='layer', bf16, batch {UNET_BATCH}, AdamW, "
        f"{DIT_TRAIN_WARMUP} warm-up + {DIT_TRAIN_STEPS} timed steps")
    unet_group = train_full_width(unet32_model(generator, "group"), UNET_BATCH, 32, UNET_TRAIN_CALLS_PER_STEP, generator)
    unet_layer = train_full_width(unet32_model(generator, "layer"), UNET_BATCH, 32, {}, generator)
    log(f"unet32 training norm='group': {unet_group['ms']:.3f} ms/step, {unet_group['images_s']:.4f} train images/s, "
        f"peak {unet_group['peak_gib']:.2f} GiB; norm='layer' (bench.py's, this run): {unet_layer['ms']:.3f} ms/step, "
        f"{unet_layer['images_s']:.4f} train images/s, peak {unet_layer['peak_gib']:.2f} GiB")

    log("== 28. result")
    kernels = []
    for name, entry, path_launches, per_forward in (
        ("group_norm_silu", gn["group_norm_silu"], launches, CALLS_PER_FORWARD),
        ("group_norm", gn["group_norm"], launches, CALLS_PER_FORWARD),
        ("attention_fwd", at, launches, CALLS_PER_FORWARD),
        ("fused_msa", msa, dit_launches, DIT_CALLS_PER_FORWARD),
        ("flash_blhd_fwd", flash["flash_blhd_fwd"], train_launches, DIT_TRAIN_CALLS_PER_STEP),
        ("flash_blhd_bwd", flash["flash_blhd_bwd"], train_launches, DIT_TRAIN_CALLS_PER_STEP),
        ("attention_fwd_max_free", mf, flux_launches, FLUX_CALLS_PER_FORWARD),
        ("attention_fwd_lse", lse_bwd["attention_fwd_lse"], dit64_launches, DIT64_TRAIN_CALLS_PER_STEP),
        ("attention_bwd", lse_bwd["attention_bwd"], dit64_launches, DIT64_TRAIN_CALLS_PER_STEP),
        *(
            (name, masked[name], dit64_dropout["launches"], DIT64_DROPOUT_CALLS_PER_STEP)
            if name in DIT64_DROPOUT_CALLS_PER_STEP
            else (name, masked[name], slice_launches, {name: 1})
            for name in MASKED_FORMS
        ),
        ("group_stats", stats, unet_group["launches"], UNET_TRAIN_CALLS_PER_STEP),
        ("conv3x3", conv3x3, conv3x3_launches, UNET_CONV3X3_CALLS),
    ):
        source, replaces = {
            "group_norm_silu": ("group_norm.cu", "azula_tpu/ops/norm.py:463 (_gn_fused_tpu)"),
            "group_norm": ("group_norm.cu", "azula_tpu/ops/norm.py:463 (_gn_fused_tpu)"),
            "attention_fwd": (
                "attention_fwd.cu",
                "azula_tpu/ops/attention.py:92 (_pallas_attention), "
                "azula_tpu/ops/attention.py:566 (_pallas_attention_batched)",
            ),
            "fused_msa": ("fused_msa.cu", "azula_tpu/ops/fused_msa.py:200 (_kernel_call)"),
            "flash_blhd_fwd": (
                "flash_blhd_fwd.cu",
                "azula_tpu/ops/attention.py:798 (_flash_blhd; body _flash_blhd_fwd_kernel at :717)",
            ),
            "flash_blhd_bwd": (
                "flash_blhd_bwd.cu",
                "azula_tpu/ops/attention.py:836 (_flash_blhd_bwd; body _flash_blhd_bwd_kernel at :748)",
            ),
            "attention_fwd_max_free": (
                "attention_fwd.cu",
                "azula_tpu/ops/attention.py:337 (_pallas_attention_blocked), "
                "azula_tpu/ops/attention.py:92 (_pallas_attention, max_free)",
            ),
            "attention_fwd_lse": (
                "attention_fwd.cu",
                "azula_tpu/ops/attention.py:92 (_pallas_attention, with_lse=True), "
                "azula_tpu/ops/attention.py:566 (_pallas_attention_batched, with_lse=True)",
            ),
            "attention_bwd": (
                "attention_bwd.cu",
                "azula_tpu/ops/attention.py:1102 (_pallas_attention_bwd; dq_kernel :1200, dkv_kernel :1275), "
                "azula_tpu/ops/attention.py:966 (_pallas_attention_batched_bwd)",
            ),
            "group_stats": ("group_stats.cu", "azula_tpu/ops/norm.py:281 (_stats_pallas)"),
            "conv3x3": ("conv3x3.cu", "azula_tpu/ops/conv.py:53 (_pallas_conv3x3)"),
        }.get(name) or masked_source(name)
        tol = {"group_stats": TOL_STATS[torch.bfloat16], "conv3x3": TOL_CONV[torch.bfloat16]}.get(
            name, TOL_GN[torch.bfloat16] if name.startswith("group_norm") else TOL_ATTN[torch.bfloat16]
        )
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"azula_tpu_torch/csrc/{source}",
            "replaces": replaces,
            # launches in the run of the kernel's own main path (ADM-256
            # sampling, dit32 sampling, dit32 training, FLUX.1-dev sampling,
            # dit64 training, dit64 training with dropout, unet32 training
            # with norm="group", the conv3x3 entry point at unet32's admitted
            # calls, or for the other masked forms the masked slice of
            # phase 21)
            "launches": path_launches[name],
            "max_abs_err": entry["max_abs_err"],
            "max_err": entry["max_err"],
            "tol": tol,
            # times of the calls of one forward (flash_blhd, attention_fwd_lse,
            # attention_bwd and their dropout forms, group_stats: of one train
            # step), summed over their shapes; the other masked forms: one
            # call at dit64's shape with a key-padding mask
            "ms": entry["ms"],
            "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"],
            # what bounds the larger share of bound_ms
            "bound_by": entry["bound_by"].most_common(1)[0][0],
            # bound_ms / ms; and the float operations of the timed calls over
            # their time, where counted (the attention forms)
            "bound_share": entry["bound_ms"] / entry["ms"],
            "tflops": entry["ops"] / entry["ms"] / 1e9 if entry.get("ops") else None,
            # fused_msa: SDPA on the normalized attention core only (no norm,
            # no layout); flash_blhd, attention_fwd_lse, attention_bwd: SDPA's
            # forward, or its autograd backward; the masked forms: SDPA with
            # the same boolean mask and dropout rate; group_stats:
            # torch.var_mean; conv3x3: F.conv2d on channels_last (cuDNN)
            "library_ms": entry["library_ms"] if name != "group_norm_silu" else None,
            "calls_per_forward": per_forward[name],
        })

    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels launched no time on their main path: {idle}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
