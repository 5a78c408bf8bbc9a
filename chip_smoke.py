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
   tensor-core forms of fused MSA (per D) and conv3x3, of the bf16
   `_flash_blhd` pair (the forward per D and warpgroups, the backward per
   D with its delta and dq-rounding kernels), and of the GroupNorm and
   statistics cluster kernels (registers and spills of each form).
3. kernels: record the kernel calls of one full-width forward (ADM
   `imagenet_256x256`, bf16, batch 8), then hold each kernel against its plain
   PyTorch version on the card at every recorded shape, in bf16 and float32,
   and time kernel, plain version, library call and bound. The bf16
   attention calls (the tensor-core forward) are also held against
   `_attention_tiled_plain`, their own rounding points, at `TOL_TC`, and
   print TFLOP/s and their share of the bound. Each GroupNorm call also
   prints its plan (`norm._gn_plan`, whose shared memory must be the C
   entry's) and its device time (the profiler); then designs (a) and (b)
   of the cluster kernel at (8, 65536, 256); the plan against its
   neighbours (half and twice its band and its cluster, two blocks an SM)
   at every recorded GroupNorm shape and unet32's three, each held against
   the plain version and timed on the device; and the host's time per call
   of ADM's smallest GroupNorm, direct and through the autograd node.
   Then the wide groups of the v-diffusion paths (`WIDE_GN_SHAPES`: one
   group of up to 2048 channels, spanning up to four bands, or of a whole
   256 x 256 image): each against its plain version in bf16 and float32,
   timed beside its bound and `F.group_norm`, and at |mean| / std = 1e4
   against the float64 GroupNorm.
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
   Prints ms/step, images/s, peak memory and a profile of one step. The
   transformer then waits in host memory for phase 36.
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
   production shapes, (8, 66049, 256) and (2, 4096, 192) included, and the
   wide groups of phase 3, and against the exact statistics in float64;
   timed by events and on the device beside the plain version,
   `torch.var_mean` and the bound (the wide groups apart). Then
   `group_stats`' gradient on the card against the plain route's, and
   `group_norm` / `group_norm_silu` forward and backward on the card
   against autograd through the plain version, at unet32's and ADM's
   shapes, with exact launches.
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
28. the eleven samplers (DDPM, DDIM, Euler, Heun, Ito, zAB, vAB, zEAB, xEAB,
   REAB, PC) on the tiny ADM, 8 steps, on the CPU (plain versions) and on the
   card (kernels), float32, the stochastic ones fed the same seeded draws.
29. the tiny CFG slice: a tiny class-conditional ADM under `CFGDenoiser`,
   two-call and batched, CPU against card: the mean at two times, a DDIM-4
   trajectory, exactly twice the forward's launches for two calls and once
   batched.
30. adm256_cfg at full width (`bench.py:103-120, 590-595`):
   imagenet_256x256_cond with random bf16 weights, batch 8, DDIM-64, labels
   arange(8) % 1000 against label 0, guidance 1.5; two-call (exactly
   2 x 84 + 2 x 17 GroupNorm and 2 x 16 attention launches per step) and
   batched (one call at batch 16: 84 + 17 and 16), each from the same noise,
   with images/s, ms/step, peak memory and a profile of one step; every call
   that the two warm-up steps recorded against its plain version at its
   shape and plan (GroupNorm with its recorded affine inputs, at batch 8
   and 16); then the batched mean against the two-call mean at t = 0.5
   (`TOL_CFG_BATCHED`; in float32 `TOL_CFG_FLOAT32`) beside where their
   difference comes from (the denoiser at batch 16 against 8, with the
   kernels and with the plain versions) and three controls that a broken
   batched path would give, which must lie above the limit.
31. the guidance slices: MMPS, TMPD, DiffPIR, JFPS (means at two times),
   DPS, PGDM, RePaint (steps, the same draws) and TDS (4 steps, the same
   draws and ancestors) on the tiny ADM, CPU against card, under
   `torch.no_grad()`: the VJP methods on the training route's kernels;
   TMPD held to the CPU's float64 (`TOL_TMPD_SLICE`).
32. mmps32 at full width (`bench.py:159-186`): unet32 (norm="layer": no
   kernel of ours) under MMPS with gmres-1, left-half inpainting, bf16,
   batch 64, DDIM-64; images/s, ms/step, the network's VJPs per step
   (counted by a backward hook on the untimed warm-up step: exactly 2),
   peak memory and a profile.
33. ADM-256 under the guidance VJP: MMPS (gmres-1) on imagenet_256x256, bf16,
   batch 8, a seeded mask of half the pixels, DDIM cut to 4 steps (not a
   timing path): per step exactly 84 + 17 GroupNorm launches through the
   autograd node, 101 statistics launches, 16 LSE forwards and 32
   backwards (two VJPs; by L: 10 at 1024, 10 at 256, 12 at 64); peak
   memory; every call of one step against its plain version at its shape:
   GroupNorm, the statistics, and the LSE forward with the backward at
   each (B, H, L, D), bf16 (also against their rounding points) and
   float32.
34. ADM's six cards at full width: one bf16 forward at batch 1 of each
   card's `make_model`, finite, with the manifest's parameter count and
   every attention block on the attention kernel (the 128-px card's heads
   of D = 128, 192 and 256 at L = 1024, 256 and 64), every recorded call
   against its plain version.
35. the text-to-image slices: the small modules of the CPU tests on the CPU
   (plain versions) and on the card (kernels), same random weights,
   float32: the VAE (encode and decode, with and without the quant
   convolutions), CLIP, T5, Gemma (a padding mask), Flux's `TextEncoder`
   and `AutoEncoder` (the same injected draws), `SanaTransformer` under
   `SanaDenoiser` (one call, DDIM-4) and the DC-AE (both attention
   branches); exactly 72 GroupNorm launches, each recorded call against its
   plain version.
36. FLUX.1-dev from a prompt to pixels at full width: T5-XXL, CLIP-L and the
   VAE (16 latent channels, no quant convolutions) drawn in bf16 on the card
   beside phase 15's transformer (moved back from host memory), each module against the port's manifest
   (`flux_1_dev.{text_encoder,text_encoder_2,vae,transformer}`); the
   prompt's seeded ids (512 T5, 77 CLIP) through `TextEncoder`, DDIM-4 and
   `AutoEncoder.decode` to a finite (1, 1024, 1024, 3) image with exactly 57
   max-free launches a step and 30 GroupNorm launches in the decode. Prints
   the ms of the text encoders, of a step and of the decode, images/s, peak
   memory, a profile of the decode, and each GroupNorm call of the decode
   against its plain version with its plan, its time by events and on the
   device, its bound and `F.group_norm`'s time.
37. sana1k at full width (`bench.py:49-82, 583-601`): Sana 1.6B (bf16) under
   `SanaDenoiser`, Gemma-2-2B (bf16) through the Sana `TextEncoder` (300
   prompt tokens after the instruction prefix), DDIM-20 at batch 8 from
   `sampler.init` noise, DC-AE (float32) to a finite (8, 1024, 1024, 3);
   each module against the port's manifest
   (`sana_1.6b_1024.{transformer,text_encoder,vae}`). Prints the
   trajectory's images/s under bench.py's metric name, the text encoder's
   and the decode's ms, peak memory of each part and a profile of one
   step; no kernel of ours launches.
38. the SD, EDM and EDM2 slices: the small modules of the CPU tests on the
   CPU (plain versions) and on the card (kernels), same random weights,
   float32: SD's UNet in both projection layouts (one head a level, so the
   attention kernel runs at heads of 32 and 64), `StableDenoiser` with both
   predictions, a batched-CFG DDIM-4 trajectory, the `AutoEncoder` (the
   same injected draws) and the `TextEncoder`; EDM's `SongUNet` (DDPM++
   under VP, NCSN++ under VE, skip, conditional) and `DhariwalUNet`,
   `ElucidatedDenoiser`, Heun-4; EDM2's network with and without labels,
   `ElucidatedLatentDenoiser`, Heun-4, its `AutoEncoder`. Exact launches,
   each recorded call against its plain version.
39. sd2_768 from prompts to pixels: the sd_2 card's UNet, CLIP-H and VAE
   drawn in bf16 on the card, each against the port's manifest; four
   prompts and the empty negative (77 seeded ids each) through
   `TextEncoder`, batched CFG at 6.5 under `StableDenoiser` (velocity),
   DDIM-25 (users run 50) on (4, 96, 96, 4) latents, `AutoEncoder.decode`
   to a finite (4, 768, 768, 3): exactly 61 GroupNorm and 16 attention
   launches a UNet call (5 at L = 9216, 5 at 2304, 5 at 576, 1 at 144, heads
   of 64, batch 8) and 30 GroupNorm launches in the decode. Prints the text
   encoder's, a step's and the decode's ms, images/s, peak memory, profiles
   of a step and of the decode, each attention call beside SDPA and its
   bound, each decode GroupNorm beside `F.group_norm`; every recorded call
   against its plain version (the attention at L = 9216 at batch 1, where
   the plain version's weights fit).
40. sd1_512: the sd_1.5 UNet (bf16, against its manifest), one batched CFG
   call at batch 2 on (2, 64, 64, 4): finite, exactly 61 GroupNorm launches
   and none of attention (heads of 40, 80, 160: the plain route).
41. edm64: imagenet_64x64_cond (`DhariwalUNet` under `EDMPrecond`, bf16)
   under `ElucidatedDenoiser`, Heun-18 at batch 64 with one-hot labels
   arange(64) % 1000: finite, exactly 95 GroupNorm launches a network call
   (groups of min(32, C // 4)); images/s, ms per network call, peak memory,
   a profile of one step; every recorded call against its plain version.
42. edm2_xxl: imagenet_512x512_xxl (`EDM2UNet` under `EDM2Precond`, bf16,
   gains drawn) under `ElucidatedLatentDenoiser`, Heun-32 at batch 8 with
   labels arange(8) % 1000 (no kernel of ours), then the sd-vae-ft-mse VAE
   (against the SD VAE manifest) with StabilityVAEEncoder's statistics to a
   finite (8, 512, 512, 3) with exactly 30 GroupNorm launches; images/s, ms
   per network call, the decode's ms, peak memory, profiles, each decode
   GroupNorm against its plain version beside `F.group_norm`.
43. the v-diffusion, CC12M-1 and JiT slices: the small modules of the CPU
   tests on the CPU (plain versions) and on the card (kernels), same random
   weights, float32: a `VDMUNet` (heads of 32 and 64, affine pre-norms,
   bilinear upsampling) under `VelocityDenoiser` and DDIM-4; the attention
   block with its pre-norm at one group of 1024 and of 2048 channels;
   CC12M-1's FiLM convolution blocks at 512 and 1024 channels and its skip
   block; JiT (heads of 32) under `JITDenoiser`, with and without labels,
   and Heun-4 under batched CFG. Exact launches, each recorded call against
   its plain version.
44. cc12m_cfg256: CC12M-1 (603M, bf16) under `VelocityDenoiser`, batched CFG
   at guidance 2, eight seeded unit-norm CLIP image embeddings against the
   zero embedding, DDIM-50 on (8, 256, 256, 3): exactly 135 GroupNorm and
   24 attention launches a call (8 each at L = 256, 64, 16); images/s, ms a
   step, peak memory, a profile of one step, each GroupNorm call of a call
   beside its bound and `F.group_norm`, every recorded call against its
   plain version.
45. vdm_yfcc512L and vdm_in128: the yfcc_512x512_large network (968M) at
   batch 4 on 512 x 512 (12 GroupNorm launches on groups of 1024 and 2048
   channels, 12 attention) and the imagenet_128x128 network (290M) at batch
   16 (24 attention at heads of 128), bf16, each against its manifest, one
   `VelocityDenoiser` call each: ms, peak memory, profile, the GroupNorm
   calls beside their bound and `F.group_norm`, every recorded call
   against its plain version.
46. jit_l16_cfg: the jit_0.5b_16 card's JiT-L/16 (459M, bf16, against its
   manifest, its zero-initialized layers drawn) under `JITDenoiser`,
   batched CFG at 2, labels arange(8) % 1000 against the null label,
   Heun-50 on (8, 256, 256, 3): exactly 24 attention launches a network
   call (8 at L = 256, 16 at 288); images/s, ms a step, peak memory,
   profile, every recorded call against its plain version.
47. jit_h16: the jit_1.0b_16 card's JiT-H/16 (953M), one batched CFG call at
   batch 8: finite, no launch of ours (heads of 80: the plain route).
48. one line of phases 43-47's paths: images/s, ms a step or a call, and
   the phases' time.
49. checkpoint loading, in a temporary hub directory (`hub.set_hub_dir`,
   deleted afterwards), with `urllib.request.urlopen` made to fail: (a)
   ADM `imagenet_256x256` built in float32 on the CPU from a seeded
   generator, saved with `torch.save` in the guided-diffusion layout under
   the cache name of the card's URL, and loaded by
   `adm.load_model(name, dtype=torch.bfloat16)` onto the card: every
   parameter equal to the source's cast to bf16, the load's peak device
   memory at most the bf16 parameters plus `LOAD_SLACK_BYTES`, then
   DDIM-8 at batch 8 with exactly 84 + 17 GroupNorm and 16 attention
   launches a forward, its trajectory equal to the source model's (moved
   to the card in bf16) bit for bit; (b) the sd_2 UNet drawn in float16 on
   the card, written as `unet/diffusion_pytorch_model.fp16.safetensors`
   by the script's own writer, read by `sd.load_unet` (the helper of
   `sd.load_model`: the port's safetensors reader, `check_manifest`,
   `skip_init`) in bf16: every parameter equal, then one batched CFG call
   at batch 8 on 96 x 96 latents with exactly 61 GroupNorm and 16
   attention launches (5/5/5/1 at L = 9216/2304/576/144), every recorded
   call against its plain version. Prints the files' sizes, each load's
   seconds and GB/s, and the peak memory.
50. the kernels line `{"kernels": [...]}` (the launches of phases 36,
   39-42, 44-47 and 49 added to their kernels' entries, by path; the wide
   groups' and the new paths' GroupNorm timings beside the GroupNorm and
   statistics entries), then the result line.

The last line of standard output is the JSON result
`{"ok": true, "device": {...}}`; nothing is printed there unless every phase
passed.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import itertools
import json
import math
import pathlib
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from azula_tpu_torch import guidance, hub, sample, train
from azula_tpu_torch.denoise import KarrasDenoiser
from azula_tpu_torch.guidance import CFGDenoiser, MMPSDenoiser
from azula_tpu_torch.linalg import IsotropicCovariance
from azula_tpu_torch.models import adm, edm, eldm, flux, jit, sana, sd, vdm
from azula_tpu_torch.models.adm.convert import canonicalize_adm_keys
from azula_tpu_torch.models.autoencoder import AutoencoderKL, canonicalize_vae_keys
from azula_tpu_torch.models.clip import CLIPTextEncoder, canonicalize_clip_keys
from azula_tpu_torch.models.flux import FluxDenoiser, FluxTransformer
from azula_tpu_torch.models.gemma import Gemma2TextModel, canonicalize_gemma_keys
from azula_tpu_torch.models.sana import SanaDenoiser, SanaTransformer
from azula_tpu_torch.models.sana.autoencoder import AutoencoderDC
from azula_tpu_torch.models.t5 import T5Encoder, canonicalize_t5_keys
from azula_tpu_torch.models.utils import SeededTokenizer, check_manifest, load_cards
from azula_tpu_torch.nn.attention import MultiheadSelfAttention
from azula_tpu_torch.nn.embedding import Modulated
from azula_tpu_torch.nn.layers import Conv, GroupNorm
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

# text to image (phases 35-37). One prompt, its ids drawn by seeded stand-ins
# of the tokenizers (the real vocabularies and lengths; no tokenizer file
# ships), every weight random from the phase's seeded generator.
T2I_PROMPT = "A photograph of an astronaut riding a horse on the moon, earth rising behind, detailed, 8k"
# FLUX.1-dev's VAE (`AutoencoderKL(latent_channels=16, use_quant_conv=False)`,
# bf16) decodes the (1, 64, 64, 64) packed latent to (1, 1024, 1024, 3): its
# GroupNorms (32 groups) are the mid block's 5, two in each of the four up
# blocks' three resnets, and `conv_norm_out`; SiLU runs apart (`F.silu`)
FLUX_VAE_CALLS = {"group_norm": 5 + 4 * 3 * 2 + 1}
FLUX_VAE_SHIFT, FLUX_VAE_SCALE = 0.1159, 0.3611
# sana1k (bench.py:49-82, 583-601): Sana 1.6B (`ARCHS["1.6b"]`, bf16) under
# `SanaDenoiser`, batch 8 of (32, 32, 32) latents, DDIM-20 (eta = 0), on
# Gemma-2-2B (bf16) over 300 prompt tokens; DC-AE decodes in float32, the
# `vae` dtype of the sana_1.6b_1024 card. Nothing cut. No kernel of ours
SANA_METRIC = "sana_1.6b_1024px_flow20_sampling_throughput"
SANA_BATCH = 8
SANA_SHAPE = (32, 32, 32)
SANA_STEPS = 20
SANA_TEXT = 300
SANA_SCALE = 0.41407
# the small text-to-image modules of phase 35 (those of the CPU tests)
TINY_VAE = dict(latent_channels=4, block_out_channels=(32, 64), layers_per_block=1)  # noqa: C408
TINY_CLIP = dict(vocab_size=99, hidden=32, layers=2, heads=4, intermediate=64, max_positions=16)  # noqa: C408
TINY_T5 = dict(vocab_size=99, dim=32, heads=4, head_dim=8, ff_dim=64, layers=3)  # noqa: C408
TINY_GEMMA = dict(  # noqa: C408
    vocab_size=127, dim=32, layers=3, heads=4, kv_heads=2, head_dim=8, intermediate=64, query_pre_attn_scalar=8.0,
    attn_logit_softcapping=1.5, sliding_window=5,
)
TINY_SANA = dict(  # noqa: C408
    in_channels=8, out_channels=8, num_attention_heads=4, attention_head_dim=8, num_cross_attention_heads=2,
    cross_attention_head_dim=16, caption_channels=32, num_layers=2,
)
TINY_DCAE = dict(  # noqa: C408
    latent_channels=4, block_types=("ResBlock", "EfficientViTBlock"), block_out_channels=(8, 16),
    encoder_layers_per_block=(1, 1), decoder_layers_per_block=(2, 1), qkv_multiscales=((), (5,)), head_dim=4,
)

# Stable Diffusion, EDM and EDM2 (phases 38-42), every weight random from the
# phase's seeded generator, bf16 unless stated.
# sd2_768, the sd_2 card (stabilityai/stable-diffusion-2, 768-v): ARCHS["sd2"]'s
# UNet (heads of 64 at L = 9216, 2304, 576 and 144), CLIP-H text encoder and
# the SD VAE, velocity prediction; four prompts and the empty negative prompt
# (77 ids each, seeded stand-in tokenizer) under batched CFG at guidance 6.5
# (diffusers' 7.5: its noise is u + 7.5 (c - u), ours (1 + w) c - w u),
# DDIM cut from the 50 steps users run to 25, the latents (4, 96, 96, 4)
# decoded to (4, 768, 768, 3)
SD2_PROMPTS = (
    "A photograph of an astronaut riding a horse on the moon, earth rising behind, detailed, 8k",
    "An oil painting of a lighthouse on a cliff in a storm, dramatic light",
    "A bowl of ramen on a wooden table, steam rising, shallow depth of field",
    "A watercolor map of an imaginary island with mountains and rivers",
)
SD2_SIDE = 96
SD2_STEPS = 25
SD2_GUIDANCE = 6.5
SD_SCALE = 0.18215
# per UNet call: two GroupNorms in each of 22 resnets, one in each of 16
# transformers, `conv_norm_out`; the 16 transformers' self-attention (heads
# of 64 on the kernel; cross-attention's 77 keys take the plain route)
SD2_CALLS_PER_FORWARD = {"group_norm": 61, "attention_fwd": 16}
SD2_ATTENTION_BY_L = {9216: 5, 2304: 5, 576: 5, 144: 1}
SD2_HEADS_BY_L = {9216: 5, 2304: 10, 576: 20, 144: 20}
# the SD VAE's decode: the mid block's 5, two in each of 4 x 3 up resnets, conv_norm_out
SD_VAE_CALLS = {"group_norm": 30}
# checkpoint loading (phase 49): ADM-256 from a full-width guided-diffusion
# .pt, sampled by DDIM-8 at batch 8; the sd_2 UNet from its float16
# safetensors, one batched CFG call at batch 8 (4 rows of 96 x 96 latents)
LOAD_ADM_STEPS = 8
LOAD_SD2_ROWS = 4
# the load may allocate on the card the bf16 parameters and this much more
LOAD_SLACK_BYTES = 256 * 2**20
# sd1_512, the sd_1.5 card's UNet (ARCHS["sd1"]: heads of 40, 80 and 160, the
# plain route): one batched CFG denoiser call at batch 2 on (2, 64, 64, 4)
SD1_BATCH = 2
SD1_CALLS_PER_FORWARD = {"group_norm": 61}
# edm64, the imagenet_64x64_cond card (edm-imagenet-64x64-cond-adm, as
# NVlabs/edm's train.py --arch=adm builds it) under EDMPrecond and
# ElucidatedDenoiser, Heun with EDM's generate.py's 18 steps (two network
# calls a step), batch 64, one-hot labels arange(64) % 1000. Per network
# call: two GroupNorms in each of 36 blocks, one in each of 22 attention
# blocks, `out_norm` (groups of min(32, C // 4); SiLU apart)
EDM64 = dict(  # noqa: C408
    img_resolution=64, in_channels=3, out_channels=3, label_dim=1000, model_channels=192,
    channel_mult=(1, 2, 3, 4), num_blocks=3, attn_resolutions=(32, 16, 8),
)
EDM64_BATCH = 64
EDM64_STEPS = 18
EDM64_CALLS_PER_FORWARD = {"group_norm": 95}
# edm2_xxl, the imagenet_512x512_xxl card (NVlabs/edm2's XXL preset: 448
# channels) under EDM2Precond and ElucidatedLatentDenoiser, Heun with EDM2's
# generate_images.py's 32 steps, batch 8, labels arange(8) % 1000: no kernel
# of ours (no GroupNorm; inline attention). Its latents decode through the
# sd-vae-ft-mse AutoencoderKL with NVlabs/edm2 training/encoders.py
# StabilityVAEEncoder's statistics: z = (raw - raw_mean) * final_std / raw_std
EDM2_XXL = dict(  # noqa: C408
    img_resolution=64, img_channels=4, label_dim=1000, model_channels=448,
    channel_mult=(1, 2, 3, 4), num_blocks=3, attn_resolutions=(16, 8),
)
EDM2_BATCH = 8
EDM2_STEPS = 32
EDM2_RAW_MEAN = (5.81, 3.25, 0.12, -2.15)
EDM2_RAW_STD = (4.17, 4.62, 3.71, 3.28)
EDM2_FINAL_STD = 0.5
# the small modules of phase 38 (those of the CPU tests); SD's with one head
# a level (heads of 32 at 16 x 16 and 64 at 8 x 8: the attention kernel)
TINY_SD = dict(  # noqa: C408
    in_channels=4, out_channels=4, block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=24,
    attention_head_dim=1, cross_attention_levels=(True, False),
)
TINY_SONG = dict(  # noqa: C408
    img_resolution=16, in_channels=3, out_channels=3, model_channels=16, channel_mult=(1, 2), channel_mult_emb=2,
    num_blocks=1, attn_resolutions=(8,),
)
TINY_DHARIWAL = {**TINY_SONG, "label_dim": 10}
TINY_EDM2 = dict(  # noqa: C408
    img_resolution=16, img_channels=4, label_dim=10, model_channels=16, channel_mult=(1, 2), num_blocks=1,
    attn_resolutions=(8,),
)
# the largest float32 weights (B H L L) the plain attention's check may take:
# calls above it are checked at batch 1
ATTENTION_CHECK_BYTES = 4 * 2**30

# v-diffusion and JiT (phases 43-47), every weight random from the phase's
# seeded generator, bf16. cc12m_cfg256: CC12M-1 (603M) under
# VelocityDenoiser in batched CFG at guidance 2 (the cc12m_1_cfg card's
# unconditional branch: the zero CLIP embedding), 8 seeded unit-norm 512-d
# CLIP ViT-B/16 image embeddings (CLIP is the caller's), DDIM-50 (eta = 0)
# on (8, 256, 256, 3). Per call (batch 16): 111 single-group GroupNorms
# without affine after the convolutions (87 of them on groups of 512 or
# 1024 channels) and 24 affine attention pre-norms; 24 attention calls,
# heads of 64, 8 each at L = 256, 64 and 16
CC12M_BATCH = 8
CC12M_STEPS = 50
CC12M_GUIDANCE = 2.0
CC12M_CALLS_PER_FORWARD = {"group_norm": 135, "attention_fwd": 24}
CC12M_ATTENTION_BY_L = {256: 8, 64: 8, 16: 8}
# vdm_yfcc512L: the yfcc_512x512_large card (SPECS["yfcc_2"], 968M), one
# call at batch 4 on (4, 512, 512, 3): 12 single-group affine pre-norms
# (groups of 1024 and 2048 channels) and 12 attention calls, heads of 64
YFCC_CARD = "yfcc_512x512_large"
YFCC_BATCH = 4
YFCC_CALLS_PER_FORWARD = {"group_norm": 12, "attention_fwd": 12}
# vdm_in128: the imagenet_128x128 card (290M), one call at batch 16: 24
# attention calls, heads of 128, no GroupNorm
IN128_CARD = "imagenet_128x128"
IN128_BATCH = 16
IN128_CALLS_PER_FORWARD = {"attention_fwd": 24}
# jit_l16_cfg: jit_0.5b_16 (JiT-L/16, 459M) under JITDenoiser in batched
# CFG at guidance 2, labels arange(8) % 1000 against the null label 1000,
# Heun-50 on (8, 256, 256, 3): 24 attention calls a network call (batch
# 16), heads of 64, 8 at L = 256 and 16 at 288 (the in-context tokens)
JIT_L_CARD = "jit_0.5b_16"
JIT_BATCH = 8
JIT_STEPS = 50
JIT_GUIDANCE = 2.0
JIT_L_CALLS_PER_FORWARD = {"attention_fwd": 24}
JIT_L_ATTENTION_BY_L = {256: 8, 288: 16}
# jit_h16: jit_1.0b_16 (JiT-H/16, 953M), one batched CFG call at batch 8:
# heads of 80, the plain route, as the JAX package takes XLA: no launch
JIT_H_CARD = "jit_1.0b_16"
# the wide groups of these paths (one group of more than 256 channels, or a
# whole 256 x 256 image a group) that phases 3 and 23 also check and time:
# yfcc_2's pre-norms, CC12M-1's widest and its first level's
WIDE_GN_SHAPES = (
    (4, 16, 2048), (4, 64, 2048), (4, 256, 1024),
    (16, 16, 1024), (16, 64, 1024), (16, 1024, 512), (16, 65536, 128),
)
# wide groups off these paths that phase 3 also checks, as (shape, groups):
# three bands of 512, five of 206 (1030 channels, bf16 vectors of 2), two
# groups of four bands, the widest group a cluster takes (16 bands)
WIDE_GN_OFF_PATH = (((3, 100, 1536), 1), ((2, 256, 1030), 1), ((2, 4096, 4096), 2), ((1, 64, 8192), 1))
# the small modules of phase 43 (those of the CPU tests): a VDMUNet with
# heads of 32 and 64 at L = 64 and 16, attention pre-norms and bilinear
# upsampling; JiT with heads of 32
TINY_VDM = dict(  # noqa: C408
    cs=(32, 64, 64), blocks=1, inner=2, attn=(1, 2), head_dim=32, final_act=False, t_input="t", up="bilinear",
    std=1.0, attn_norm=True,
)
TINY_JIT = dict(  # noqa: C408
    input_size=64, patch_size=16, hidden_size=64, depth=3, num_heads=2, num_classes=10, bottleneck_dim=16,
    in_context_len=4, in_context_start=1,
)

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

# adm256_cfg (bench.py:103-120, 590-595): imagenet_256x256_cond under
# CFGDenoiser, labels arange(8) % 1000 against label 0, guidance 1.5
CFG_CARD = "imagenet_256x256_cond"
CFG_GUIDANCE = 1.5
# the batched (2B) CFG mean against the two-call mean at t = CFG_TIME,
# max |error| / max |mean|. The rows are independent, but the library's
# convolutions and matmuls round a batch of 16 elsewhere than one of 8: the
# denoiser's own mean moves by up to 4.7e-2 of max |mean| between the two
# batches, with our kernels and with GroupNorm and attention on their plain
# versions alike, and not at all when run twice at one batch. CFG's
# (1 + w) mu+ - w mu- carries that shift times 1 + 2 w over a max |mean| of
# up to 1 + 2 w: about 4.7e-2 of it at most; the limit is twice that. A
# broken batched path (the halves swapped, one label for both, the labels
# rolled) lies at 1.25 or more, and each run checks that it lies above the
# limit. In float32 the two forms agree to 8.3e-6 (the limit: 1e-4)
TOL_CFG_BATCHED = 0.1
TOL_CFG_FLOAT32 = 1e-4
CFG_TIME = 0.5

# mmps32 (bench.py:159-186): unet32 (norm="layer") under MMPS, gmres-1
MMPS_BATCH = 64
MMPS_STEPS = 64
MMPS_NOISE = 0.05
# the network VJPs of one MMPS step: one per gmres iteration and one after
MMPS_VJPS_PER_STEP = 2

# ADM-256 under the guidance VJP: MMPSDenoiser (gmres-1) on imagenet_256x256,
# bf16, batch 8, cut from DDIM-64 to 4 steps (not a timing path)
GUIDED_STEPS = 4
GUIDED_LAUNCHES_PER_STEP = {
    "group_norm_silu": 84, "group_norm": 17, "group_stats": 101,
    "attention_fwd_lse": 16, "attention_bwd": 16 * MMPS_VJPS_PER_STEP,
}
# per step, by sequence length: the LSE forwards and the backwards (rows 9 at
# L = 1024, row 8's form at L = 256 and 64)
GUIDED_ATTENTION_BY_L = {
    "attention_fwd_lse": {1024: 5, 256: 5, 64: 6},
    "attention_bwd": {1024: 5 * MMPS_VJPS_PER_STEP, 256: 5 * MMPS_VJPS_PER_STEP, 64: 6 * MMPS_VJPS_PER_STEP},
}

# the CPU-against-card slices of the samplers and the guidance methods
SLICE_STEPS = 8
SLICE_CLASSES = 10
# TMPD divides by var_y + A cov_x A^T 1, which crosses zero on a random
# network (|d| down to 3.6e-4 against var_y = 2.5e-3 on the slice's tiny
# ADM at t = 0.3), so its float32 result carries the division's
# amplification: on the CPU it lies 1.07e-4 from the float64 result there,
# where the other methods lie within 1.3e-5, and the card's float32 has
# lain 1.6e-4 to 2.4e-4 from the CPU's. So the card is held to the CPU's
# float64 result, at the sum of those two distances rounded up, scaled by
# sigma / alpha as the other slices' bound
TOL_TMPD_SLICE = 4e-4

# the port's checkpoint manifests: each card's parameter names and shapes
# (data, read as JSON)
MANIFESTS = pathlib.Path(__file__).resolve().parent / "azula_tpu_torch" / "models" / "manifests"

# attention shapes off the main path that phase 3 also checks: a ragged
# length and the other head dims (shape: scale)
ATTENTION_EXTRA = {(8, 16, 100, 64): 0.125, (4, 8, 256, 32): 32**-0.5, (2, 4, 200, 128): 128**-0.5}

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
    kernels it launches over `reps` calls after a warm-up call, with the
    host's gaps between them left out (CUDA events around a short call also
    count the time in which the card waits for the host). Each kernel
    counts its mean time per launch times its launches per call (its count
    over `reps`, at least one): the profiler's activity records are now and
    then lost, in part or whole, and a trace that lost some still reads the
    calls' time; one that lost all is taken again, up to three times. Where
    all three lost everything the time is not measured: NaN, which the
    lines print as such and the kernels line as null (a timing, not a
    check, so the run goes on)."""

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_call = 0.0
        for event in prof.key_averages():
            if event.device_type != torch.autograd.DeviceType.CUDA or getattr(event, "is_user_annotation", False):
                continue
            us = getattr(event, "self_device_time_total", None)
            us = getattr(event, "self_cuda_time_total", 0) if us is None else us
            if event.count:
                per_call += us / event.count * max(1, round(event.count / reps))
        if per_call:
            return per_call / 1e3
    log("  the profiler saw no device time in three traces: not measured")
    return math.nan


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


def redesign_ptxas_summaries() -> tuple[str, str, str]:
    r"""`ptxas -v` of the bf16 tensor-core forms of the fused MSA kernel
    (`tc::fused_msa_tc_kernel<D>` of `csrc/fused_msa.cu`) and of conv3x3
    (`tc::conv3x3_tc_kernel` of `csrc/conv3x3.cu`): registers, spill stores
    and the dynamic shared memory of a block; and of the cluster kernels of
    GroupNorm and the group statistics (`group_norm_kernel<T, VEC, SiLU>`,
    `group_stats_kernel<T, VEC>`): registers and spill stores of each form."""

    lib = _build.library()
    msa = ptxas_summary(
        ptxas_entries("fused_msa.cu"), r"fused_msa_tc_kernelILi(\d+)E", lambda: "bf16",
        lambda D: f"{lib.azula_fused_msa_tc_shared_bytes(D):,} B",
    )
    conv3x3 = ", ".join(
        f"{regs} regs {spill} B spilled; shared memory per block {lib.azula_conv3x3_tc_shared_bytes():,} B"
        for name, regs, spill in ptxas_entries("conv3x3.cu") if "conv3x3_tc_kernel" in name
    )
    forms = []
    for kind, pattern in (("group_norm", r"group_norm_kernelI(13__nv_bfloat16|f)Li(\d+)ELb(\d)E"),
                          ("group_stats", r"group_stats_kernelI(13__nv_bfloat16|f)Li(\d+)EE")):
        for name, regs, spill in ptxas_entries(f"{kind}.cu"):
            found = re.search(pattern, name)
            if found:
                dtype, vec, *silu = found.groups()
                label = f"{kind} {'f32' if dtype == 'f' else 'bf16'} x{vec}{' SiLU' if silu == ['1'] else ''}"
                forms.append(f"{label} {regs} regs {spill} B spilled")
    return msa, conv3x3, ", ".join(forms)


def new_entry() -> dict:
    r"""A kernel's entry of the kernels line, before its timings."""

    return dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, device_ms=0.0, max_abs_err=0.0,  # noqa: C408
                max_err=0.0, bound_by=collections.Counter())


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
    inputs per distinct call) that the main path makes while it is active:
    GroupNorm, the group statistics, the attention forwards (exact,
    max-free, fused MSA) and the attention training route (the LSE forward
    and the backward)."""

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

    def lse(q, k, v, scale, *masked):
        calls[("lse", tuple(q.shape), q.dtype, scale)] += 1
        return lse_kernel(q, k, v, scale, *masked)

    def bwd(q, k, v, o, lse_, g, scale, *masked):
        calls[("bwd", tuple(q.shape), q.dtype, scale)] += 1
        return bwd_kernel(q, k, v, o, lse_, g, scale, *masked)

    def stats(x, groups):
        calls[("stats", tuple(x.shape), x.dtype, groups)] += 1
        return stats_kernel(x, groups)

    lse_kernel, bwd_kernel = attention._attention_lse_kernel, attention._attention_bwd_kernel
    stats_kernel = norm._STATS["kernel"]
    norm._compose_affine, norm._group_norm_kernel, attention._attention_kernel = compose_affine, gn, attn
    fused_msa._fused_msa_kernel, attention._attention_max_free_kernel = msa, max_free
    attention._attention_lse_kernel, attention._attention_bwd_kernel = lse, bwd
    norm._STATS["kernel"] = stats
    try:
        yield calls, affine
    finally:
        norm._compose_affine, norm._group_norm_kernel, attention._attention_kernel = compose, gn_kernel, attn_kernel
        fused_msa._fused_msa_kernel, attention._attention_max_free_kernel = msa_kernel, max_free_kernel
        attention._attention_lse_kernel, attention._attention_bwd_kernel = lse_kernel, bwd_kernel
        norm._STATS["kernel"] = stats_kernel


def kernel_name(key) -> str:
    r"""The kernel of a recorded call."""

    if key[0] == "gn":
        return "group_norm_silu" if key[4] else "group_norm"
    return {
        "attn": "attention_fwd", "msa": "fused_msa", "max_free": "attention_fwd_max_free",
        "lse": "attention_fwd_lse", "bwd": "attention_bwd", "stats": "group_stats",
    }[key[0]]


def manifest_parameters(name: str) -> int:
    r"""The parameters of ADM card `name`'s backbone, as its checkpoint
    manifest lists them."""

    shapes = json.loads((MANIFESTS / "adm" / f"{name}.model.json").read_text())
    return sum(math.prod(shape) for shape in shapes.values())


def full_width_model(generator: torch.Generator, name: str = "imagenet_256x256", dtype=torch.bfloat16):
    r"""The ADM denoiser of card `name` (the main path's imagenet_256x256 by
    default) with random weights of `dtype` (bf16 by default) on the
    generator's device: every layer that the backbone zero-initializes is
    drawn like the others."""

    card = load_cards(adm)[name]
    denoiser = adm.make_model(**card.config, device=generator.device, generator=generator)

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

    backbone.to(dtype)

    return denoiser


def plan_text(plan) -> str:
    return (f"bands of {plan.band}, clusters of {plan.cluster} x {plan.rows} rows, "
            f"{plan.resident} kept, {plan.smem:,} B shared")


# the most shared memory each of two blocks on one SM can take (228 KB an
# SM, less 1 KB the card keeps for each block)
TWO_BLOCKS_SHARED = (228 - 2) * 1024 // 2


def plan_neighbours(HW: int, C: int, groups: int, plan) -> list:
    r"""The bf16 plans beside the planner's: half and twice its band, half
    and twice its cluster, and its own with the kept rows cut so that two
    blocks share an SM (where its shared memory allows only one)."""

    cpg = C // groups
    found = []
    for band, cluster in ((plan.band // 2, plan.cluster), (plan.band * 2, plan.cluster),
                          (plan.band, plan.cluster // 2), (plan.band, plan.cluster * 2)):
        if band % cpg or C % band or not 0 < band <= 512 or not 1 <= cluster <= 16 or HW < cluster:
            continue
        other = norm._plan(HW, band, cluster, 2)
        if other.smem <= norm._MAX_SHARED and other != plan and other not in found:
            found.append(other)
    kept = (TWO_BLOCKS_SHARED - norm._shared_bytes(plan.band, 0, 2)) // (plan.band * 2)
    if plan.smem > TWO_BLOCKS_SHARED and kept >= 2 * norm._row_threads(plan.band, 2):
        found.append(plan._replace(resident=kept, smem=norm._shared_bytes(plan.band, kept, 2)))
    return found


def sweep_plans(shapes, generator) -> None:
    r"""The GroupNorm kernel with SiLU in bf16 under the planner's plan and
    its neighbours (`plan_neighbours`), each held against the plain version
    and timed on the device: one line per shape, and how often the
    planner's was the fastest among the shapes whose times were all
    measured (a time the profiler missed prints "not measured")."""

    best = near = counted = 0
    for (B, HW, C), groups in shapes:
        x = torch.randn((B, HW, C), generator=generator, device="cuda").to(torch.bfloat16)
        P = 1 + 0.3 * torch.randn(B, C, generator=generator, device="cuda")
        Q = 0.3 * torch.randn(B, C, generator=generator, device="cuda")
        want = norm._group_norm_plain(x, P, Q, groups, 1e-5, True)
        plan = norm._gn_plan(B, HW, C, groups, 2)
        times = []
        for each in [plan] + plan_neighbours(HW, C, groups, plan):
            _, rel_err = errors(norm._group_norm_kernel(x, P, Q, groups, 1e-5, True, each), want)
            if rel_err > TOL_GN[torch.bfloat16]:
                raise AssertionError(f"group norm {(B, HW, C)} under {each}: {rel_err}")
            times.append((device_ms(lambda: norm._group_norm_kernel(x, P, Q, groups, 1e-5, True, each), reps=10), each))
        ours = times[0][0]
        # a time the profiler did not measure (NaN) leaves the shape out of the tally
        measured = not any(math.isnan(t) for t, _ in times)
        if measured:
            fastest = min(t for t, _ in times)
            best += ours == fastest
            near += ours <= 1.03 * fastest
            counted += 1

        def ms(t):
            return "not measured" if math.isnan(t) else f"{t:.4f}"

        others = "; ".join(f"{p.band}/{p.cluster}/{p.resident} kept {ms(t)}" for t, p in times[1:])
        log(f"  plan sweep {(B, HW, C)} G={groups} bf16 SiLU, device ms: planner {plan.band}/{plan.cluster}/"
            f"{plan.resident} kept {ms(ours)} (band/cluster/rows kept); {others}"
            + ("" if measured else "; not measured, left out of the tally"))
        del x, want
    log(f"  plan sweep: the planner's plan the fastest at {best} of {counted} measured shapes "
        f"({len(shapes)} in all), within 3% of the fastest at {near}")


def check_gn_calls(calls, affine, generator, per_kernel=None, quiet=False) -> dict:
    r"""Each recorded GroupNorm call, with its recorded affine inputs, against
    the plain version in bf16 and float32, with the plan and its shared
    memory held against the C entry's; where `per_kernel` is given, timed
    in the call's own dtype (by events and on the device) and summed into
    it. Returns the largest relative error by dtype; `quiet` leaves out the
    line per call."""

    lib = _build.library()
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}

    keys = sorted((k for k in calls if k[0] == "gn"), key=lambda k: (k[4], k[5], k[1]))
    for key in keys:
        _, shape, dtype, groups, silu, modulated = key
        P, Q, eps = affine[key]
        name = "group_norm_silu" if silu else "group_norm"
        count = calls[key]

        for check_dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=generator, device="cuda") * 2 + 0.5).to(check_dtype)
            plan = norm._gn_plan(*shape, groups, x.element_size())
            span = norm._span(plan.band, shape[-1] // groups)
            if lib.azula_group_norm_shared_bytes(plan.band, span, plan.resident, norm._DTYPES[check_dtype]) != plan.smem:
                raise AssertionError(f"group norm {shape} {check_dtype}: the planner's shared memory is not the kernel's")
            got = norm._group_norm_kernel(x, P, Q, groups, eps, silu)
            want = norm._group_norm_plain(x, P, Q, groups, eps, silu)
            abs_err, rel_err = errors(got, want)
            if rel_err > TOL_GN[check_dtype]:
                raise AssertionError(f"group norm {shape} {check_dtype} silu={silu}: {rel_err} > {TOL_GN[check_dtype]}")
            worst[check_dtype] = max(worst[check_dtype], rel_err)

            line = (
                f"  group_norm {shape} {str(check_dtype)[6:]} silu={silu} mod={modulated} x{count}/fwd: "
                f"max abs err {abs_err:.3e}, rel {rel_err:.3e} (tol {TOL_GN[check_dtype]})"
            )

            if per_kernel is not None and check_dtype == dtype:  # the main path's dtype: time it
                entry = per_kernel[name]
                ms = elapsed_ms(lambda: norm._group_norm_kernel(x, P, Q, groups, eps, silu))
                dev = device_ms(lambda: norm._group_norm_kernel(x, P, Q, groups, eps, silu), reps=10)
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
                entry["device_ms"] += count * dev
                entry["plain_ms"] += count * plain
                entry["bound_ms"] += count * bound
                entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
                entry["max_err"] = max(entry["max_err"], rel_err)
                line += (f"; {ms:.4f} ms, device {dev:.4f} ms, plain {plain:.4f} ms, library {library} ms, "
                         f"bound {bound:.4f} ms ({by}); {plan_text(plan)}")
            elif check_dtype == dtype:
                line += f"; {plan_text(plan)}"

            if not quiet:
                log(line)

    return worst


def check_wide_groups() -> dict:
    r"""The GroupNorm kernel at the wide groups of the v-diffusion paths
    (`WIDE_GN_SHAPES`: one group a batch row, of up to 2048 channels, which
    spans up to four bands): against its plain version in bf16 and float32
    (`check_gn_calls`; yfcc_2's with an affine, CC12M-1's without), timed in
    bf16 by events and on the device beside its bound and `F.group_norm`;
    then at |mean| / std = 1e4 in float32 against the float64 GroupNorm of
    the same inputs, at CC12M-1's 8.4M-element groups and yfcc_2's widest.
    The groups of `WIDE_GN_OFF_PATH` are held to the plain version too,
    untimed. Its inputs come from a generator of its own. Returns the timed
    entry."""

    generator = torch.Generator(device="cuda").manual_seed(13)
    calls, affine = collections.Counter(), {}
    for shape in WIDE_GN_SHAPES:
        B, _, C = shape
        key = ("gn", shape, torch.bfloat16, 1, False, False)
        calls[key] = 1
        if B == YFCC_BATCH:  # yfcc's affine pre-norm
            P = (1 + 0.2 * torch.randn(1, C, generator=generator, device="cuda")).expand(B, C).contiguous()
            Q = (0.2 * torch.randn(1, C, generator=generator, device="cuda")).expand(B, C).contiguous()
        else:
            P, Q = torch.ones(B, C, device="cuda"), torch.zeros(B, C, device="cuda")
        affine[key] = (P, Q, 1e-5)
    per_kernel = {name: new_entry() for name in ("group_norm_silu", "group_norm")}
    check_gn_calls(calls, affine, generator, per_kernel)
    entry = per_kernel["group_norm"]
    log(f"  the {len(WIDE_GN_SHAPES)} wide-group calls: {entry['ms']:.4f} ms by events, device "
        f"{entry['device_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
        f"F.group_norm {entry['library_ms']:.4f} ms")

    off_path, off_affine = collections.Counter(), {}
    for shape, groups in WIDE_GN_OFF_PATH:
        B, _, C = shape
        key = ("gn", shape, torch.bfloat16, groups, False, False)
        off_path[key] = 1
        off_affine[key] = (1 + 0.2 * torch.randn(B, C, generator=generator, device="cuda"),
                           0.2 * torch.randn(B, C, generator=generator, device="cuda"), 1e-5)
    worst = check_gn_calls(off_path, off_affine, generator)
    log(f"  wide groups off the paths {[shape for shape, _ in WIDE_GN_OFF_PATH]}: worst rel err "
        + ", ".join(f"{str(dtype)[6:]} {err:.3e}" for dtype, err in worst.items()))

    for shape in ((16, 65536, 128), (4, 16, 2048)):
        B, HW, C = shape
        x = torch.randn(shape, generator=generator, device="cuda") + 1e4
        P, Q = torch.ones(B, C, device="cuda"), torch.zeros(B, C, device="cuda")
        got = norm._group_norm_kernel(x, P, Q, 1, 1e-5, False)
        var, mean = torch.var_mean(x.double(), dim=(1, 2), keepdim=True, correction=0)
        abs_err, _ = errors(got, (x.double() - mean) / torch.sqrt(var + 1e-5))
        if abs_err > TOL_GN_LARGE_MEAN:
            raise AssertionError(f"group norm {shape} G=1 at |mean|/std = 1e4: abs err {abs_err} against float64")
        log(f"  group_norm {shape} G=1 float32 |mean|/std=1e4 ({HW * C:,} elements a group): max abs err "
            f"{abs_err:.3e} against float64 (tol {TOL_GN_LARGE_MEAN})")
        del x, got
    torch.cuda.empty_cache()

    return entry


def check_group_norm(calls, affine, generator) -> dict:
    r"""Each recorded GroupNorm call against the plain version
    (`check_gn_calls`, timed in bf16); plus a large-mean input, designs (a)
    and (b) at (8, 65536, 256), the plan against its neighbours
    (`sweep_plans`), and the host's cost of the autograd node that a direct
    call no longer makes."""

    lib = _build.library()
    per_kernel = {
        name: new_entry()
        for name in ("group_norm_silu", "group_norm")
    }
    check_gn_calls(calls, affine, generator, per_kernel)
    keys = [k for k in calls if k[0] == "gn"]

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

    # HW = 65536 (ADM's 256 x 256 stage): design (a), one group (16 bytes)
    # a band, every row kept on clusters of 8 or 16 blocks, against (b), the
    # planner's 128-byte bands on 16 blocks, the rows past what a block's
    # shared memory holds read again (from L2, which keeps them); and (b) on
    # clusters of 8. Their inputs come from a generator of their own, so
    # that the later phases draw what they drew before these checks existed
    own = torch.Generator(device="cuda").manual_seed(12)
    B, HW, C = 8, 65536, 256
    x = torch.randn((B, HW, C), generator=own, device="cuda").to(torch.bfloat16)
    P, Q = torch.ones(B, C, device="cuda"), torch.zeros(B, C, device="cuda")
    want = norm._group_norm_plain(x, P, Q, GROUPS, 1e-5, True)
    for label, plan in (
        ("(b) the planner's", norm._gn_plan(B, HW, C, GROUPS, 2)),
        ("(b) on 8 blocks", norm._plan(HW, 64, 8, 2)),
        ("(a) on 8 blocks", norm._plan(HW, 8, 8, 2)),
        ("(a) on 16 blocks", norm._plan(HW, 8, 16, 2)),
    ):
        _, rel_err = errors(norm._group_norm_kernel(x, P, Q, GROUPS, 1e-5, True, plan), want)
        if rel_err > TOL_GN[torch.bfloat16]:
            raise AssertionError(f"group norm {label}: {rel_err}")
        ms = elapsed_ms(lambda: norm._group_norm_kernel(x, P, Q, GROUPS, 1e-5, True, plan))
        dev = device_ms(lambda: norm._group_norm_kernel(x, P, Q, GROUPS, 1e-5, True, plan), reps=10)
        clusters = lib.azula_group_norm_active_clusters(plan.band, plan.cluster, plan.resident, 1, 1)
        log(f"  group_norm {(B, HW, C)} bfloat16 silu=True, design {label}: {ms:.4f} ms, device {dev:.4f} ms; "
            f"{plan_text(plan)}; {clusters} clusters at once; rel err {rel_err:.3e}")
    # a yardstick of the card's rate for one read of x and one write of y
    # (not the same function: no statistics)
    log(f"  F.silu on the same x (1R + 1W): device {device_ms(lambda: F.silu(x), reps=10):.4f} ms")
    del x, want

    # the plan against its neighbours at every recorded GroupNorm shape and
    # unet32's three (16 groups)
    shapes = sorted({(k[1], k[3]) for k in keys}) + [(shape, UNET_GROUPS) for shape in UNET_GN_SHAPES]
    sweep_plans(shapes, own)

    # the host's cost of a call on ADM's smallest GroupNorm: the direct
    # launch, and the same through the autograd node every call made before
    x = torch.randn((B, 64, 1024), generator=own, device="cuda").to(torch.bfloat16)
    P, Q = torch.ones(B, 1024, device="cuda"), torch.zeros(B, 1024, device="cuda")
    launch = norm._group_norm_kernel.__wrapped__

    def host_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        return seconds / n * 1e6

    direct = host_us(lambda: norm._group_norm_kernel(x, P, Q, GROUPS, 1e-5, True))
    node = host_us(lambda: _build._ForwardOnly.apply("group_norm", "", launch, x, P, Q, GROUPS, 1e-5, True))
    direct_again = host_us(lambda: norm._group_norm_kernel(x, P, Q, GROUPS, 1e-5, True))
    log(f"  group_norm (8, 64, 1024) host time per call: direct {direct:.2f}, {direct_again:.2f} us; "
        f"through the autograd node {node:.2f} us")

    return per_kernel


def check_attention(calls, generator, entry=None, extra=None, quiet=False) -> dict:
    r"""The attention kernel against the plain version at the recorded shapes
    and at those of `extra` (shape: scale), in bf16 and float32, bf16 also
    against its own rounding points; where `entry` is given, the recorded
    shapes timed in bf16 (with SDPA as the library yardstick) and summed
    into it. Returns the largest relative error by dtype; `quiet` leaves
    out the line per call."""

    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    recorded = {k[1]: (calls[k], k[3]) for k in calls if k[0] == "attn"}
    extra = {shape: (0, scale) for shape, scale in (extra or {}).items()}

    for shape, (count, scale) in sorted({**recorded, **extra}.items()):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=generator, device="cuda").to(dtype) for _ in range(3))
            got = attention._attention_kernel(q, k, v, scale)
            want = attention._attention_plain(q, k, v, scale=scale)
            abs_err, rel_err = errors(got, want)
            if rel_err > TOL_ATTN[dtype]:
                raise AssertionError(f"attention {shape} {dtype}: {rel_err} > {TOL_ATTN[dtype]}")
            worst[dtype] = max(worst[dtype], rel_err)

            line = f"  attention {shape} {str(dtype)[6:]} x{count}/fwd: max abs err {abs_err:.3e}, rel {rel_err:.3e} (tol {TOL_ATTN[dtype]})"
            if dtype == torch.bfloat16:
                tiled = check_tiled(got, attention._attention_tiled_plain(q, k, v, scale)[0], f"attention {shape}")
                line += f"; against its rounding points rel {tiled:.3e} (tol {TOL_TC})"

            if entry is not None and count and dtype == torch.bfloat16:
                ms = elapsed_ms(lambda: attention._attention_kernel(q, k, v, scale))
                plain = elapsed_ms(lambda: attention._attention_tiled_plain(q, k, v, scale))
                library = elapsed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
                B, H, L, D = shape
                ops = 4 * B * H * L * L * D
                bound, by = bound_ms(4 * q.numel() * q.element_size(), ops, dtype)
                add_timing(entry, count, ms, plain, library, bound, by, abs_err, rel_err, ops)
                line += (f"; {ms:.4f} ms ({speed(ops, ms, bound)}), plain {plain:.4f} ms, SDPA {library:.4f} ms, "
                         f"bound {bound:.4f} ms ({by})")

            if not quiet:
                log(line)

    return worst


def tiny_adm_pair(rng: np.random.Generator, **config):
    r"""The tiny ADM (`TINY`, with `config`) on the CPU and on the card, float32,
    with the same weights drawn from `rng`."""

    cpu = adm.make_model(**TINY, **config, device="cpu")
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

    card = adm.make_model(**TINY, **config, device="cuda")
    card.backbone.load_state_dict(state)

    return cpu, card


def check_slice() -> None:
    r"""The tiny ADM on the CPU (plain versions) and on the card (kernels),
    with the same random weights, in float32."""

    rng = np.random.default_rng(0)
    cpu, card = tiny_adm_pair(rng)

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


def profile_step(step, what: str = "one step") -> None:
    r"""Device time of one full-width step (`step()`, a DDIM or train step, or
    `what` else) by kind of kernel, and the share of its wall time in which
    the card ran no kernel."""

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
        if "::group_norm_kernel<" in name:
            kind = "group_norm (ours)"
        elif "::group_stats_kernel<" in name:
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
    log(f"profile of {what}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
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


def check_training_pair(shape, dtype, scale, generator) -> tuple:
    r"""The LSE forward and the backward kernels on random q, k, v, g of
    `shape` against their plain versions (the plain backward takes the
    kernel's own o and lse, as autograd hands it the forward's), and in bf16
    against their own rounding points. Returns q, k, v, g, o, lse, the
    kernel's (dq, dk, dv), the errors by output and the line to log."""

    q, k, v, g = (torch.randn(shape, generator=generator, device="cuda").to(dtype) for _ in range(4))

    o, lse = attention._attention_lse_kernel(q, k, v, scale)
    grads = attention._attention_bwd_kernel(q, k, v, o, lse, g, scale)
    want_o, want_lse = attention._attention_lse_plain(q, k, v, scale)
    want_grads = attention._attention_bwd_plain(q, k, v, o, lse, g, scale)

    errs = {"o": errors(o, want_o), "lse": errors(lse, want_lse)}
    errs.update({name: errors(a, b) for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads)})
    del want_o, want_lse, want_grads
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

    return q, k, v, g, o, lse, grads, errs, line


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
            q, k, v, g, o, lse, grads, errs, line = check_training_pair(shape, dtype, scale, generator)

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
            del q, k, v, g, o, lse, grads
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


def check_stats_case(shape, groups, dtype, generator) -> tuple:
    r"""The statistics kernel against its plain version on 100 + 3 N inputs
    of `shape`, and both against the exact statistics in float64. Returns
    x, the plan, the mean's absolute and relative errors, the variance's
    relative error and the line to log."""

    B, HW, C = shape
    x = (100 + 3 * torch.randn(shape, generator=generator, device="cuda")).to(dtype)
    plan = norm._gn_plan(B, HW, C, groups, x.element_size(), stats=True)
    mean, var = norm._stats_kernel(x, groups)
    want_mean, want_var = norm._stats_kernel_plain(x, groups, plan.rows)
    exact_var, exact_mean = torch.var_mean(x.double().view(B, HW, groups, -1), dim=(1, 3), correction=0)

    mean_abs, mean_rel = errors(mean, want_mean)
    var_rel = ((var.double() - want_var.double()).abs() / want_var.double()).max().item()
    exact_rel = ((var.double() - exact_var).abs() / exact_var).max().item()
    exact_mean_rel = errors(mean, exact_mean)[1]
    tol = TOL_STATS[dtype]
    line = (f"  group_stats {shape} G={groups} {str(dtype)[6:]} (bands of {plan.band}, clusters of "
            f"{plan.cluster} x {plan.rows} rows; JAX's TPU kernel "
            f"{'covers' if norm.stats_kernel_eligible(shape) else 'does not cover'} it): "
            f"mean rel {mean_rel:.3e}, var rel {var_rel:.3e}; against float64 mean {exact_mean_rel:.3e}, "
            f"var {exact_rel:.3e} (tol {tol})")
    if max(mean_rel, var_rel, exact_rel, exact_mean_rel) > tol:
        raise AssertionError(line)

    return x, plan, mean_abs, mean_rel, var_rel, line


def check_group_stats(generator) -> dict:
    r"""The statistics kernel against its plain version on 100 + 3 N inputs
    (|mean| / std ~ 33), in bf16 and float32, at unet32's three GroupNorm
    shapes (timed in bf16 beside the plain version, `torch.var_mean` and the
    bound; the entry sums the 18 calls of one train step), at the JAX
    package's production shapes (tests/test_ops_tpu.py) and at the wide
    groups of the v-diffusion paths (timed too, one call each, under the
    entry's `wide`), and both against the exact statistics in float64."""

    entry = new_entry()
    count = UNET_TRAIN_CALLS_PER_STEP["group_stats"] // len(UNET_GN_SHAPES)

    cases = [(shape, UNET_GROUPS, "step") for shape in UNET_GN_SHAPES] + [
        ((8, 65536, 256), 32, None),
        ((8, 16384, 512), 32, None),
        ((2, 4096, 1024), 32, None),
        ((4, 9216, 384), 32, None),
        ((8, 66049, 256), 32, None),
        ((2, 4096, 192), 24, None),
    ]
    # the wide groups of the v-diffusion paths, timed apart (`wide`); their
    # inputs from a generator of their own, so that the cases above draw
    # what they drew before
    wide = new_entry()
    own = torch.Generator(device="cuda").manual_seed(23)
    cases += [(shape, 1, "wide") for shape in WIDE_GN_SHAPES]
    for shape, groups, timed in cases:
        B, HW, C = shape
        for dtype in (torch.bfloat16, torch.float32):
            x, plan, mean_abs, mean_rel, var_rel, line = check_stats_case(
                shape, groups, dtype, own if timed == "wide" else generator
            )

            if timed and dtype == torch.bfloat16:
                xv = x.view(B, HW, groups, C // groups)
                ms = elapsed_ms(lambda: norm._stats_kernel(x, groups))
                dev = device_ms(lambda: norm._stats_kernel(x, groups), reps=10)
                plain = elapsed_ms(lambda: norm._stats_kernel_plain(x, groups, plan.rows))
                library = elapsed_ms(lambda: torch.var_mean(xv, dim=(1, 3), correction=0))
                library_dev = device_ms(lambda: torch.var_mean(xv, dim=(1, 3), correction=0), reps=10)
                # x read once and (mean, var) written once; a subtraction, a
                # square and two sums per element, float32 on the CUDA cores
                bound, by = bound_ms(x.numel() * x.element_size() + 2 * B * groups * 4, 4 * x.numel(), torch.float32)
                timed_entry, n = (entry, count) if timed == "step" else (wide, 1)
                add_timing(timed_entry, n, ms, plain, library, bound, by, mean_abs, max(mean_rel, var_rel))
                timed_entry["device_ms"] += n * dev
                line += (f"; {ms:.4f} ms, device {dev:.4f} ms ({x.numel() * x.element_size() / dev / 1e6:.1f} GB/s), "
                         f"plain {plain:.4f} ms, torch.var_mean {library:.4f} ms (device {library_dev:.4f}), "
                         f"bound {bound:.4f} ms ({by})")
            log(line)
            del x
        torch.cuda.empty_cache()
    log(f"  the {len(WIDE_GN_SHAPES)} wide-group calls: {wide['ms']:.4f} ms by events, device {wide['device_ms']:.4f} ms, "
        f"bound {wide['bound_ms']:.4f} ms, plain {wide['plain_ms']:.4f} ms, torch.var_mean {wide['library_ms']:.4f} ms")
    entry["wide"] = wide

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


def check_recorded(label: str, calls, affine, seed: int, quiet: bool = True) -> None:
    r"""Every kernel call that a path recorded (`recording()`) against its
    plain version at the recorded shape, in bf16 and float32: GroupNorm with
    the recorded affine inputs (`check_gn_calls`, the planner's plan for
    the recorded batch), the attention forward (`check_attention`), the
    statistics (`check_stats_case`) and the LSE forward with the backward
    (`check_training_pair`, also against their bf16 rounding points). The
    inputs come from a generator seeded with `seed`, so that the path's own
    draws stay as they were. One line for the path, and one per training
    pair; `quiet=False` adds one per call."""

    generator = torch.Generator(device="cuda").manual_seed(seed)
    worst = collections.defaultdict(float)
    with torch.no_grad():
        if any(k[0] == "gn" for k in calls):
            for dtype, err in check_gn_calls(calls, affine, generator, quiet=quiet).items():
                worst["group_norm", dtype] = err
        if any(k[0] == "attn" for k in calls):
            for dtype, err in check_attention(calls, generator, quiet=quiet).items():
                worst["attention_fwd", dtype] = err
        for key in sorted(k for k in calls if k[0] == "stats"):
            for dtype in (torch.bfloat16, torch.float32):
                *_, mean_rel, var_rel, line = check_stats_case(key[1], key[3], dtype, generator)
                worst["group_stats", dtype] = max(worst["group_stats", dtype], mean_rel, var_rel)
                if not quiet:
                    log(line)
        pairs = sorted({(k[1], k[3]) for k in calls if k[0] in ("lse", "bwd")})
        for shape, scale in pairs:
            for dtype in (torch.bfloat16, torch.float32):
                *_, errs, line = check_training_pair(shape, dtype, scale, generator)
                worst["attention_fwd_lse + attention_bwd", dtype] = max(
                    worst["attention_fwd_lse + attention_bwd", dtype], *(rel for _, rel in errs.values())
                )
                log(line)
        torch.cuda.empty_cache()

    shapes = collections.Counter(kernel_name(k) for k in calls)
    log(f"  {label}: every recorded call against its plain version, distinct shapes {dict(shapes)}; worst rel err "
        + ", ".join(f"{name} {str(dtype)[6:]} {err:.3e}" for (name, dtype), err in worst.items()))


def launch_counts(calls) -> dict:
    r"""Recorded calls summed by kernel."""

    counts = collections.Counter()
    for key, n in calls.items():
        counts[kernel_name(key)] += n
    return dict(counts)


def cfg_full_width(generator, steps: int) -> dict:
    r"""adm256_cfg at full width (phase 30): two-call CFG, then batched,
    each a DDIM trajectory from the same noise with exact launch counts,
    images/s, ms/step, peak memory and a profile of one step; every call
    that either recorded held against its plain version (`check_recorded`:
    GroupNorm at the batch-16 plans too); then the batched mean against
    the two-call mean at one time beside its sources and controls
    (`cfg_readings`)."""

    denoiser = full_width_model(generator, CFG_CARD)
    n_params = sum(p.numel() for p in denoiser.backbone.parameters())
    if n_params != manifest_parameters(CFG_CARD):
        raise AssertionError(f"{CFG_CARD} has {n_params:,} parameters, its manifest {manifest_parameters(CFG_CARD):,}")
    labels = torch.arange(BATCH, device="cuda") % 1000
    cond = dict(positive={"label": labels}, negative={"label": torch.zeros_like(labels)}, guidance=CFG_GUIDANCE)  # noqa: C408
    log(f"{CFG_CARD}: {n_params:,} parameters (its manifest's); labels {labels.tolist()}, negative 0, "
        f"guidance {CFG_GUIDANCE}")

    x = DDIMSampler(denoiser, steps=steps).init((BATCH, 256, 256, 3), generator=generator)
    results, recorded = {}, {}
    for batched in (False, True):
        sampler = DDIMSampler(CFGDenoiser(denoiser, batched=batched), eta=0.0, steps=steps)
        calls_per_step = CALLS_PER_FORWARD if batched else {name: 2 * n for name, n in CALLS_PER_FORWARD.items()}
        label = "batched (one call at batch 16)" if batched else "two-call (two calls at batch 8)"

        with torch.inference_mode():
            grid = sampler.timesteps.cuda()
            with recording() as (calls, affine):
                sampler.step(x, grid[0], grid[1], **cond)  # warm-up
            recorded[batched] = label, calls, affine
            torch.cuda.synchronize()
            batches = {key[1][0] for key in calls}
            log(f"{label}: calls in one step {launch_counts(calls)}, batch {sorted(batches)}")
            if launch_counts(calls) != calls_per_step or batches != {2 * BATCH if batched else BATCH}:
                raise AssertionError(f"expected {calls_per_step} calls per CFG step at one batch")
            torch.cuda.reset_peak_memory_stats()

            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            y = sampler(x, **cond)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)

        peak = torch.cuda.max_memory_allocated()
        if not bool(torch.isfinite(y).all()) or y.shape != x.shape:
            raise AssertionError("the adm256_cfg trajectory is not finite")
        expected = {name: n * steps for name, n in calls_per_step.items()}
        log(f"launches {launches}, expected {expected}")
        if launches != expected:
            raise AssertionError("the adm256_cfg launch counts are not exact")
        results[batched] = dict(images_s=BATCH / seconds, ms=seconds / steps * 1e3, peak_gib=peak / 2**30)  # noqa: C408
        log(f"adm256_cfg {label}: trajectory {seconds:.3f} s, {BATCH / seconds:.4f} images/s, "
            f"{seconds / steps * 1e3:.2f} ms/step, peak memory {peak / 2**30:.2f} GiB; "
            f"sample mean {y.float().mean().item():.4f}, std {y.float().std().item():.4f}")
        with torch.inference_mode():
            profile_step(lambda sampler=sampler, grid=grid: sampler.step(x, grid[0], grid[1], **cond))

    for batched, (label, calls, affine) in recorded.items():
        check_recorded(f"adm256_cfg {label}", calls, affine, seed=300 + batched)

    t = torch.tensor(CFG_TIME, device="cuda")
    readings = cfg_readings(denoiser, x, t, cond)
    err, err32 = readings["batched"][0], readings["float32"][0]
    controls = min(reading[0] for name, reading in readings.items() if name.startswith("control"))
    log(f"batched against two-call mean at t = {CFG_TIME}: rel err {err:.3e} (tol {TOL_CFG_BATCHED}), "
        f"float32 {err32:.3e} (tol {TOL_CFG_FLOAT32}); the nearest control {controls:.3e}")
    if err > TOL_CFG_BATCHED or err32 > TOL_CFG_FLOAT32:
        raise AssertionError("the batched CFG mean disagrees with the two-call mean")
    if controls <= TOL_CFG_BATCHED:
        raise AssertionError("a broken batched CFG path would pass the limit")
    log(f"adm256_cfg: batched / two-call ms per step {results[True]['ms'] / results[False]['ms']:.3f}")

    del denoiser, x, y, sampler
    torch.cuda.empty_cache()

    return results


@contextlib.contextmanager
def plain_forwards():
    r"""GroupNorm and the attention forward on their plain versions on the
    card while it is active: a reading of where a difference comes from,
    never a path whose launches are counted."""

    def gn(x, P, Q, groups, eps, silu):
        return norm._group_norm_plain(x, P, Q, groups, eps, silu)

    def attn(q, k, v, scale, bias=None, *masked):
        if bias is not None:
            raise NotImplementedError("plain_forwards() covers attention without a bias")
        return attention._attention_plain(q, k, v, scale=scale)

    gn_kernel, attn_kernel = norm._group_norm_kernel, attention._attention_kernel
    norm._group_norm_kernel, attention._attention_kernel = gn, attn
    try:
        yield
    finally:
        norm._group_norm_kernel, attention._attention_kernel = gn_kernel, attn_kernel


def cfg_readings(denoiser, x, t, cond) -> dict:
    r"""The batched CFG mean against the two-call mean at time `t`, beside
    where their difference comes from and what a broken batched path would
    give: (max |error| / max |want|, rms error / rms want) of each.

    - batched: the batched mean against the two-call mean;
    - denoiser at 16 against 8 (kernels or plain): the denoiser's mean of
      the positive rows at batch 16 (beside the negative rows, as the
      batched call runs them) against the same rows at batch 8, with the
      kernels or with GroupNorm and attention on their plain versions;
    - denoiser run twice: the batch-8 call against itself;
    - float32: batched against two-call with the backbone in float32
      (the float32 kernels), after the bf16 readings;
    - controls: the halves swapped (the guidance term's sign reversed), the
      negative label for both halves, and the positive labels rolled by
      one, each against the two-call mean."""

    def rel(got, want):
        diff = (got.double() - want.double())
        return (diff.abs().max().item() / want.double().abs().max().item(),
                diff.pow(2).mean().sqrt().item() / want.double().pow(2).mean().sqrt().item())

    labels, negative = cond["positive"]["label"], cond["negative"]["label"]
    readings = {}
    with torch.inference_mode():
        two = CFGDenoiser(denoiser)(x, t, **cond).mean
        readings["batched"] = rel(CFGDenoiser(denoiser, batched=True)(x, t, **cond).mean, two)

        x2, labels2 = torch.cat([x, x]), torch.cat([labels, negative])
        eight = {}
        for name, context in (("kernels", contextlib.nullcontext), ("plain", plain_forwards)):
            with context():
                eight[name] = denoiser(x, t, label=labels).mean
                sixteen = denoiser(x2, t, label=labels2).mean[:BATCH]
            readings[f"denoiser at 16 against 8 ({name})"] = rel(sixteen, eight[name])
        readings["denoiser run twice"] = rel(denoiser(x, t, label=labels).mean, eight["kernels"])

        controls = {
            "control: halves swapped": dict(positive=cond["negative"], negative=cond["positive"]),  # noqa: C408
            "control: the negative label for both": dict(positive=cond["negative"], negative=cond["negative"]),  # noqa: C408
            "control: labels rolled by one": dict(  # noqa: C408
                positive={"label": labels.roll(1)}, negative=cond["negative"],
            ),
        }
        for name, swapped in controls.items():
            readings[name] = rel(CFGDenoiser(denoiser, batched=True)(x, t, **swapped, guidance=CFG_GUIDANCE).mean, two)

        denoiser.backbone.float()
        two = CFGDenoiser(denoiser)(x, t, **cond).mean
        readings["float32"] = rel(CFGDenoiser(denoiser, batched=True)(x, t, **cond).mean, two)
        denoiser.backbone.to(torch.bfloat16)

    for name, (max_rel, rms_rel) in readings.items():
        log(f"  CFG at t = {t.item():.4f}, {name}: max {max_rel:.3e}, rms {rms_rel:.3e}")

    return readings


def left_half(x: torch.Tensor) -> torch.Tensor:
    r"""mmps32's forward operator: the left half of each image, flattened."""

    return x[..., : x.shape[-2] // 2, :].reshape(*x.shape[:-3], -1)


def mmps32_full_width(generator) -> dict:
    r"""mmps32 at full width (phase 32) as `bench.py` builds it: the unet32
    denoiser (norm="layer": no kernel of ours), left-half inpainting, MMPS
    with gmres-1, DDIM-64 at batch 64 under `torch.no_grad()`, with the
    network's VJPs counted by a backward hook on the untimed warm-up step."""

    denoiser = unet32_model(generator, "layer")
    x_true = torch.randn((MMPS_BATCH, 32, 32, 3), generator=generator, device="cuda")
    y = left_half(x_true)
    y = y + MMPS_NOISE * torch.randn(y.shape, generator=generator, device="cuda")
    guided = MMPSDenoiser(denoiser, y, left_half, IsotropicCovariance(MMPS_NOISE**2), solver="gmres", iterations=1)
    sampler = DDIMSampler(guided, eta=0.0, steps=MMPS_STEPS)
    x = sampler.init((MMPS_BATCH, 32, 32, 3), generator=generator)

    vjps = [0]

    def count(module, grad_input, grad_output):
        vjps[0] += 1

    # the VJPs are counted on the warm-up step only: the hook wraps every
    # backbone call in autograd functions of its own, so the timed
    # trajectory runs without it
    hook = denoiser.backbone.register_full_backward_hook(count)
    try:
        with torch.no_grad():
            grid = sampler.timesteps.cuda()
            sampler.step(x, grid[0], grid[1])  # warm-up
            torch.cuda.synchronize()
    finally:
        hook.remove()
    counted = vjps[0]

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = sampler(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)

    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(out).all()) or out.shape != x.shape:
        raise AssertionError("the mmps32 trajectory is not finite")
    log(f"launches {launches}, expected none (norm='layer' runs no kernel of ours); "
        f"network VJPs in the warm-up step {counted}, expected {MMPS_VJPS_PER_STEP}")
    if launches or counted != MMPS_VJPS_PER_STEP:
        raise AssertionError("the mmps32 path launched a kernel or took another count of VJPs")
    residual = (left_half(out) - y).float().pow(2).mean().sqrt().item()
    result = dict(images_s=MMPS_BATCH / seconds, ms=seconds / MMPS_STEPS * 1e3, peak_gib=peak / 2**30)  # noqa: C408
    log(f"mmps32 trajectory {seconds:.3f} s, {result['images_s']:.4f} images/s, {result['ms']:.3f} ms/step, "
        f"{counted} VJPs per step, peak memory {result['peak_gib']:.2f} GiB; "
        f"observed-half residual rms {residual:.4f} (noise {MMPS_NOISE})")
    with torch.no_grad():
        profile_step(lambda: sampler.step(x, grid[0], grid[1]))

    del denoiser, guided, sampler, x, out
    torch.cuda.empty_cache()

    return result


def guided_adm(generator) -> dict:
    r"""ADM-256 under the guidance VJP (phase 33): MMPSDenoiser (gmres-1) on
    imagenet_256x256, bf16, batch 8, a seeded mask of half the pixels, DDIM
    cut to `GUIDED_STEPS` steps, with the launches of GroupNorm through its
    autograd node, the statistics it saves, the LSE forwards and the
    backwards counted exactly per step, and every call of one step held
    against its plain version at its recorded shape (`check_recorded`: the
    LSE forward and the backward at each (B, H, L, D) of
    `GUIDED_ATTENTION_BY_L`, bf16 and float32)."""

    denoiser = full_width_model(generator)
    pixels = 256 * 256
    keep = torch.randperm(pixels, generator=torch.Generator().manual_seed(30))[: pixels // 2].sort().values.cuda()

    def A(x):
        return x.reshape(*x.shape[:-3], pixels, 3)[..., keep, :].reshape(*x.shape[:-3], -1)

    x_true = torch.randn((BATCH, 256, 256, 3), generator=generator, device="cuda").clip(-1, 1)
    y = A(x_true)
    y = y + MMPS_NOISE * torch.randn(y.shape, generator=generator, device="cuda")
    guided = MMPSDenoiser(denoiser, y, A, IsotropicCovariance(MMPS_NOISE**2), solver="gmres", iterations=1)
    sampler = DDIMSampler(guided, eta=0.0, steps=GUIDED_STEPS)
    x = sampler.init((BATCH, 256, 256, 3), generator=generator)
    log(f"steps cut from 64 to {GUIDED_STEPS}; mask of {pixels // 2} of {pixels} pixels (seed 30)")

    with torch.no_grad():
        grid = sampler.timesteps.cuda()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        with recording() as (calls, affine):
            sampler.step(x, grid[0], grid[1])
        torch.cuda.synchronize()
        step_launches = dict(_build.LAUNCHES)
        by_length = {name: collections.Counter() for name in GUIDED_ATTENTION_BY_L}
        for key, n in calls.items():
            if kernel_name(key) in by_length:
                by_length[kernel_name(key)][key[1][2]] += n
        by_length = {name: dict(counter) for name, counter in by_length.items()}
        log(f"one guided step: launches {step_launches}; attention by L {by_length}")
        if step_launches != GUIDED_LAUNCHES_PER_STEP or by_length != GUIDED_ATTENTION_BY_L:
            raise AssertionError(f"expected {GUIDED_LAUNCHES_PER_STEP} launches per guided step, by L {GUIDED_ATTENTION_BY_L}")

        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = sampler(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)

    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(out).all()) or out.shape != x.shape:
        raise AssertionError("the guided ADM trajectory is not finite")
    expected = {name: n * GUIDED_STEPS for name, n in GUIDED_LAUNCHES_PER_STEP.items()}
    log(f"launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError("the guided ADM launch counts are not exact")
    log(f"guided ADM-256: {GUIDED_STEPS} steps in {seconds:.3f} s ({seconds / GUIDED_STEPS * 1e3:.1f} ms/step, "
        f"not a timing path), peak memory {peak / 2**30:.2f} GiB; sample mean {out.float().mean().item():.4f}, "
        f"std {out.float().std().item():.4f}")
    check_recorded("guided ADM-256", calls, affine, seed=330)
    with torch.no_grad():
        profile_step(lambda: sampler.step(x, grid[0], grid[1]))

    del denoiser, guided, sampler, x, out
    torch.cuda.empty_cache()

    return dict(launches=launches, peak_gib=peak / 2**30)  # noqa: C408


class SeededNormal:
    r"""Normal draws from a seeded NumPy generator, in the requested dtype and
    on the requested device: the same draws on the CPU and on the card."""

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def __call__(self, generator, shape, like: torch.Tensor) -> torch.Tensor:
        draw = torch.from_numpy(self.rng.standard_normal(tuple(shape)).astype(np.float32))
        return draw.to(device=like.device, dtype=like.dtype)


class SeededAncestors:
    r"""TDS's ancestors by the Gumbel-max trick on seeded Gumbel noise: the
    same draws on both devices, so the same indices for (nearly) equal
    weights."""

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def __call__(self, log_w: torch.Tensor, generator) -> torch.Tensor:
        K = log_w.shape[0]
        gumbel = torch.from_numpy(self.rng.gumbel(size=(K, K))).to(log_w.device)
        return torch.argmax(log_w[None, :].double() + gumbel, dim=1)


SAMPLER_SLICES = {
    "DDPMSampler": lambda d: sample.DDPMSampler(d, steps=SLICE_STEPS),
    "DDIMSampler": lambda d: sample.DDIMSampler(d, eta=0.5, steps=SLICE_STEPS),
    "EulerSampler": lambda d: sample.EulerSampler(d, steps=SLICE_STEPS),
    "HeunSampler": lambda d: sample.HeunSampler(d, steps=SLICE_STEPS),
    "ItoSampler": lambda d: sample.ItoSampler(d, steps=SLICE_STEPS),
    "zABSampler": lambda d: sample.zABSampler(d, order=3, steps=SLICE_STEPS),
    "vABSampler": lambda d: sample.vABSampler(d, steps=SLICE_STEPS),
    "zEABSampler": lambda d: sample.zEABSampler(d, steps=SLICE_STEPS),
    "xEABSampler": lambda d: sample.xEABSampler(d, order=3, steps=SLICE_STEPS),
    "REABSampler": lambda d: sample.REABSampler(d, steps=SLICE_STEPS),
    "PCSampler": lambda d: sample.PCSampler(d, steps=SLICE_STEPS),
}


def check_sampler_slices() -> None:
    r"""Each of the eleven samplers on the tiny ADM, CPU (plain versions)
    against the card (kernels), float32, `SLICE_STEPS` steps, the stochastic
    ones fed the same draws on both devices."""

    cpu, card = tiny_adm_pair(np.random.default_rng(31))
    x = torch.from_numpy(np.random.default_rng(32).standard_normal((2, 32, 32, 3)).astype(np.float32))

    with torch.inference_mode():
        for i, (name, make) in enumerate(SAMPLER_SLICES.items()):
            out = []
            for model, device in ((cpu, "cpu"), (card, "cuda")):
                sampler = make(model)
                sampler._normal = SeededNormal(100 + i)
                _build.LAUNCHES.clear()
                out.append(sampler(x.to(device), generator=torch.Generator(device=device)).cpu())
                launched = dict(_build.LAUNCHES)
            _, err = errors(out[1], out[0])
            log(f"  {name}: {SLICE_STEPS} steps, rel err {err:.3e} (tol {TOL_TRAJECTORY}); card launches {launched}")
            if err > TOL_TRAJECTORY or set(launched) != set(CALLS_PER_FORWARD):
                raise AssertionError(f"{name} on the card disagrees with the CPU or missed a kernel")


def check_cfg_slice() -> None:
    r"""A tiny class-conditional ADM under CFG, two-call and batched, CPU
    against the card, float32: the mean at two times, a DDIM-4 trajectory,
    exact launches (twice the forward's for two calls, once batched)."""

    cpu, card = tiny_adm_pair(np.random.default_rng(33), num_classes=SLICE_CLASSES)
    x = torch.from_numpy(np.random.default_rng(34).standard_normal((2, 32, 32, 3)).astype(np.float32))

    def cond(device):
        return dict(positive={"label": torch.tensor([3, 7], device=device)},  # noqa: C408
                    negative={"label": torch.tensor([0], device=device)}, guidance=CFG_GUIDANCE)

    with torch.inference_mode():
        _build.LAUNCHES.clear()
        card(x.cuda(), torch.tensor(0.5, device="cuda"), label=torch.tensor([3, 7], device="cuda"))
        forward = dict(_build.LAUNCHES)

        for batched in (False, True):
            for t in (0.3, 0.9):
                want = CFGDenoiser(cpu, batched=batched)(x, torch.tensor(t), **cond("cpu")).mean
                _build.LAUNCHES.clear()
                got = CFGDenoiser(card, batched=batched)(x.cuda(), torch.tensor(t, device="cuda"), **cond("cuda")).mean
                launched = dict(_build.LAUNCHES)
                alpha, sigma = cpu.schedule(torch.tensor(t))
                tol = TOL_SLICE * max(1.0, float(sigma / alpha)) * (1 + 2 * CFG_GUIDANCE)
                _, err = errors(got.cpu(), want)
                expected = forward if batched else {name: 2 * n for name, n in forward.items()}
                log(f"  CFG {'batched' if batched else 'two-call'} t={t}: rel err {err:.3e} (tol {tol:.1e}), "
                    f"launches {launched} (expected {expected})")
                if err > tol or launched != expected:
                    raise AssertionError("the tiny CFG denoiser on the card disagrees with the CPU")

            want = DDIMSampler(CFGDenoiser(cpu, batched=batched), steps=4)(x, **cond("cpu"))
            got = DDIMSampler(CFGDenoiser(card, batched=batched), steps=4)(x.cuda(), **cond("cuda"))
            _, err = errors(got.cpu(), want)
            tol = TOL_TRAJECTORY * (1 + 2 * CFG_GUIDANCE)
            log(f"  CFG {'batched' if batched else 'two-call'} DDIM-4: rel err {err:.3e} (tol {tol:.1e})")
            if err > tol:
                raise AssertionError("the tiny CFG trajectory on the card disagrees with the CPU")


def tiny_inverse_problem(device: str):
    r"""mmps32's left-half inpainting on the tiny ADM's 32 x 32 images: the
    observation y, the masked image and the mask, from seeded draws."""

    rng = np.random.default_rng(35)
    x_true = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)).clip(-1, 1)
    y = left_half(x_true) + MMPS_NOISE * torch.from_numpy(rng.standard_normal((2, 16 * 32 * 3)).astype(np.float32))
    mask = torch.arange(32)[None, :, None] < 16
    return y.to(device), torch.where(mask, x_true, 0.0).to(device), mask.expand(32, 32, 3).to(device)


def left_half_inverse(y: torch.Tensor) -> torch.Tensor:
    r"""A pseudo-inverse of `left_half` on 32 x 32 images: zeros on the right."""

    left = y.reshape(*y.shape[:-1], 32, 16, 3)
    return torch.cat([left, torch.zeros_like(left)], dim=-2)


GUIDED_WRAPPERS = {
    "MMPSDenoiser": lambda d, y: MMPSDenoiser(d, y, left_half, IsotropicCovariance(MMPS_NOISE**2)),
    "TMPDenoiser": lambda d, y: guidance.TMPDenoiser(d, y, left_half, MMPS_NOISE**2),
    "DiffPIRDenoiser": lambda d, y: guidance.DiffPIRDenoiser(d, y, left_half, MMPS_NOISE**2, lmbda=1.0, iterations=2),
    "JFPSDenoiser": lambda d, y: guidance.JFPSDenoiser(
        d, y, left_half, IsotropicCovariance(MMPS_NOISE**2), IsotropicCovariance(1.0), iterations=2
    ),
}

GUIDED_SAMPLERS = {
    "DPSSampler": lambda d, y, obs, mask: guidance.DPSSampler(d, y, left_half, zeta=0.3, steps=SLICE_STEPS),
    "PGDMSampler": lambda d, y, obs, mask: guidance.PGDMSampler(d, y, left_half, left_half_inverse, eta=0.5, steps=SLICE_STEPS),
    "RePaintSampler": lambda d, y, obs, mask: guidance.RePaintSampler(d, obs, mask, iterations=2, eta=0.5, steps=SLICE_STEPS),
}

# the kernels each guidance method runs on the tiny ADM: a VJP through the
# denoiser takes the training route (GroupNorm's autograd node with its
# statistics, the LSE forward and the backward)
GRAD_ROUTE = {"group_norm_silu", "group_norm", "group_stats", "attention_fwd_lse", "attention_bwd"}


def check_guidance_slices() -> None:
    r"""Each guidance method on the tiny ADM, CPU (plain versions) against
    the card (kernels, under grad where the method takes VJPs), float32,
    under `torch.no_grad()`: the wrappers' means at two times, the sampler
    subclasses' steps and a 4-step TDS trajectory with the same draws."""

    cpu, card = tiny_adm_pair(np.random.default_rng(36))
    x = torch.from_numpy(np.random.default_rng(37).standard_normal((2, 32, 32, 3)).astype(np.float32))
    problem = {"cpu": tiny_inverse_problem("cpu"), "cuda": tiny_inverse_problem("cuda")}

    def expect(name, launched):
        route = GRAD_ROUTE if name != "DiffPIRDenoiser" and name != "JFPSDenoiser" else set(CALLS_PER_FORWARD)
        if set(launched) != route:
            raise AssertionError(f"{name} launched {sorted(launched)} on the card, expected {sorted(route)}")

    exact = copy.deepcopy(cpu).double()
    with torch.no_grad():
        for name, make in GUIDED_WRAPPERS.items():
            for t in (0.3, 0.6):
                want = make(cpu, problem["cpu"][0])(x, torch.tensor(t)).mean
                _build.LAUNCHES.clear()
                got = make(card, problem["cuda"][0])(x.cuda(), torch.tensor(t, device="cuda")).mean
                launched = dict(_build.LAUNCHES)
                alpha, sigma = cpu.schedule(torch.tensor(t))
                scale = max(1.0, float(sigma / alpha))
                _, err = errors(got.cpu(), want)
                if name == "TMPDenoiser":
                    # held to the CPU's float64, beside the CPU's own float32
                    exact_mean = make(exact, problem["cpu"][0].double())(
                        x.double(), torch.tensor(t, dtype=torch.float64)
                    ).mean
                    _, err = errors(got.cpu(), exact_mean)
                    tol = TOL_TMPD_SLICE * scale
                    log(f"  {name} t={t}: rel err against the CPU's float64 {err:.3e} (tol {tol:.1e}); the CPU's "
                        f"float32 {errors(want, exact_mean)[1]:.3e}, the card against it {errors(got.cpu(), want)[1]:.3e}; "
                        f"card launches {launched}")
                else:
                    tol = TOL_SLICE * scale
                    log(f"  {name} t={t}: rel err {err:.3e} (tol {tol:.1e}); card launches {launched}")
                if err > tol:
                    raise AssertionError(f"{name} on the card disagrees with the CPU")
                expect(name, launched)

        for i, (name, make) in enumerate(GUIDED_SAMPLERS.items()):
            for t, s in ((1.0, 0.875), (0.5, 0.375), (0.125, 0.0)):
                out = []
                for model, device in ((cpu, "cpu"), (card, "cuda")):
                    sampler = make(model, *problem[device])
                    sampler._normal = SeededNormal(200 + i)
                    _build.LAUNCHES.clear()
                    out.append(sampler.step(
                        x.to(device), torch.tensor(t, device=device), torch.tensor(s, device=device),
                        generator=torch.Generator(device=device),
                    ).cpu())
                    launched = dict(_build.LAUNCHES)
                _, err = errors(out[1], out[0])
                log(f"  {name} step {t} -> {s}: rel err {err:.3e} (tol {TOL_TRAJECTORY}); card launches {launched}")
                if err > TOL_TRAJECTORY:
                    raise AssertionError(f"{name} on the card disagrees with the CPU")
                if name != "RePaintSampler":
                    expect(name, launched)
                elif set(launched) != set(CALLS_PER_FORWARD):
                    raise AssertionError(f"RePaintSampler launched {sorted(launched)} on the card")

        xk = torch.from_numpy(np.random.default_rng(38).standard_normal((4, 32, 32, 3)).astype(np.float32))
        for threshold in (1.0, 0.0):
            out = []
            for model, device in ((cpu, "cpu"), (card, "cuda")):
                y0 = problem[device][0][0]

                def twist(x_hat, ratio, y0=y0):
                    return -torch.sum((y0 - left_half(x_hat)) ** 2, dim=-1) / (2 * (MMPS_NOISE**2 + ratio**2))

                sampler = guidance.TDSSampler(model, twist, resample_threshold=threshold, return_weights=True, steps=4)
                sampler._normal, sampler._resample = SeededNormal(300), SeededAncestors(301)
                _build.LAUNCHES.clear()
                particles, log_w = sampler(xk.to(device), generator=torch.Generator(device=device))
                out.append((particles.cpu(), log_w.cpu()))
                launched = dict(_build.LAUNCHES)
            _, err = errors(out[1][0], out[0][0])
            _, w_err = errors(out[1][1], out[0][1])
            log(f"  TDSSampler threshold {threshold}: 4 steps, rel err {err:.3e}, log-weights {w_err:.3e} "
                f"(tol {TOL_TRAJECTORY}); card launches {launched}")
            if err > TOL_TRAJECTORY or w_err > TOL_TRAJECTORY:
                raise AssertionError("TDSSampler on the card disagrees with the CPU")
            if not GRAD_ROUTE <= set(launched):
                raise AssertionError(f"TDSSampler launched {sorted(launched)} on the card")


def check_cards(generator) -> None:
    r"""Each of ADM's six cards once at full width (phase 34): one bf16
    forward at batch 1 of `make_model(**card.config)` with random weights,
    finite, with the manifest's parameter count, every attention block on
    the attention kernel (the 128-px card's heads of 128, 192 and 256), and
    every recorded call held against its plain version (`check_recorded`)."""

    for i, (name, card) in enumerate(load_cards(adm).items()):
        denoiser = full_width_model(generator, name)
        n_params = sum(p.numel() for p in denoiser.backbone.parameters())
        blocks = sum(isinstance(m, adm.backbone.ADMAttentionBlock) for m in denoiser.backbone.modules())
        size = card.config["image_size"]
        x = torch.randn((1, size, size, 3), generator=generator, device="cuda")
        label = torch.tensor([7], device="cuda") if card.config.get("num_classes") else None

        with torch.inference_mode(), recording() as (calls, affine):
            out = denoiser(x, torch.tensor(0.5, device="cuda"), label=label)
            torch.cuda.synchronize()
        heads = sorted({(key[1][3], key[1][2]) for key in calls if key[0] == "attn"})
        counts = launch_counts(calls)
        log(f"  {name}: {n_params:,} parameters (manifest {manifest_parameters(name):,}), {size} px, "
            f"calls {counts}, attention (D, L) {heads}; mean {out.mean.float().mean().item():.4f}")
        if not bool(torch.isfinite(out.mean).all()) or out.mean.shape != x.shape:
            raise AssertionError(f"{name}'s forward is not finite")
        if n_params != manifest_parameters(name):
            raise AssertionError(f"{name}'s parameter count is not its manifest's")
        if counts.get("attention_fwd", 0) != blocks:
            raise AssertionError(f"{name}: {counts.get('attention_fwd', 0)} attention kernel calls for {blocks} blocks")
        if name == "imagenet_128x128_cond" and {D for D, _ in heads} != {128, 192, 256}:
            raise AssertionError(f"{name}: heads {heads}, expected D = 128, 192 and 256 on the kernel")
        check_recorded(name, calls, affine, seed=340 + i)

        del denoiser, x, out
        torch.cuda.empty_cache()


def tokenizers(clip: int = 49408, t5: int = 32128, gemma: int = 256000, clip_length: int = 77) -> dict:
    r"""Seeded stand-ins of the CLIP, T5 and Gemma tokenizers, with their
    special ids and lengths, over vocabularies of the given sizes (the real
    ones by default)."""

    return {
        "clip": SeededTokenizer(clip, clip_length, bos=clip - 2, eos=clip - 1, pad=clip - 1, seed=1),
        "t5": SeededTokenizer(t5, 512, eos=1, pad=0, seed=2),
        "gemma": SeededTokenizer(gemma, 8192, bos=2, pad=0, seed=3),
    }


def slice_check(label: str, got: torch.Tensor, want: torch.Tensor, tol: float = TOL_SLICE) -> None:
    _, err = errors(got.float().cpu(), want.float())
    log(f"  {label}: rel err {err:.3e} (tol {tol})")
    if err > tol:
        raise AssertionError(f"{label}: the card disagrees with the CPU")


def check_t2i_slices() -> None:
    r"""The small text-to-image modules on the CPU (plain versions) and on
    the card (kernels), same random weights, float32: the VAE (encode and
    decode, with and without the quant convolutions; every GroupNorm call it
    recorded against its plain version), CLIP, T5 and Gemma (a padding mask),
    Flux's `TextEncoder` and `AutoEncoder`, `SanaTransformer` under
    `SanaDenoiser` (one call and DDIM-4), and the DC-AE (both attention
    branches)."""

    def pair(cls, seed, **config):
        cpu = cls(**config, device="cpu", generator=torch.Generator().manual_seed(seed))
        return cpu, copy.deepcopy(cpu).cuda()

    rng = np.random.default_rng(35)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    _build.LAUNCHES.clear()
    recorded = []  # held against their plain versions once the slices' launches are read
    with torch.inference_mode():
        for quant in (True, False):
            cpu, card = pair(AutoencoderKL, 40 + quant, **TINY_VAE, use_quant_conv=quant)
            x, z = normal(2, 32, 32, 3), normal(2, 8, 8, 4)
            before = dict(_build.LAUNCHES)
            want = (*cpu.encode(x), cpu.decode(z))
            if dict(_build.LAUNCHES) != before:
                raise AssertionError("a kernel ran on the CPU path")
            with recording() as (calls, affine):
                got = (*card.encode(x.cuda()), card.decode(z.cuda()))
            recorded.append((f"VAE quant_conv={quant}", calls, affine))
            for name, g, w in zip(("encode mean", "encode std", "decode"), got, want, strict=True):
                slice_check(f"VAE quant_conv={quant} {name}", g, w)

        ids = torch.from_numpy(rng.integers(0, 99, (2, 16)))
        for label, cls, config in (("CLIP", CLIPTextEncoder, TINY_CLIP), ("T5", T5Encoder, TINY_T5)):
            cpu, card = pair(cls, 42, **config)
            slice_check(f"{label} last hidden state", card(ids.cuda()), cpu(ids))
        cpu, card = pair(Gemma2TextModel, 43, **TINY_GEMMA)
        ids = torch.from_numpy(rng.integers(0, 127, (2, 12)))
        mask = torch.ones(2, 12, dtype=torch.int64)
        mask[1, 7:] = 0
        slice_check("Gemma last hidden state, padding mask", card(ids.cuda(), mask.cuda()), cpu(ids, mask))

        # Flux's text encoder and auto-encoder
        (clip_cpu, clip_card), (t5_cpu, t5_card) = pair(CLIPTextEncoder, 44, **TINY_CLIP), pair(T5Encoder, 45, **TINY_T5)
        tok = tokenizers(TINY_CLIP["vocab_size"], TINY_T5["vocab_size"], clip_length=TINY_CLIP["max_positions"])
        want = flux.TextEncoder(clip_cpu, tok["clip"], t5_cpu, tok["t5"], 24)(T2I_PROMPT)
        got = flux.TextEncoder(clip_card, tok["clip"], t5_card, tok["t5"], 24)(T2I_PROMPT)
        for key in ("prompt_clip", "prompt_t5"):
            slice_check(f"Flux TextEncoder {key}", got[key], want[key])
        vae_cpu, vae_card = pair(AutoencoderKL, 46, **TINY_VAE, use_quant_conv=False)
        ae_cpu = flux.AutoEncoder(vae_cpu, FLUX_VAE_SHIFT, FLUX_VAE_SCALE)
        ae_card = flux.AutoEncoder(vae_card, FLUX_VAE_SHIFT, FLUX_VAE_SCALE)
        noise = normal(2, 16, 16, 4)
        ae_cpu._normal = ae_card._normal = lambda generator, like: noise.to(like.device)  # the same draws
        x = normal(2, 32, 32, 3)
        with recording() as (calls, affine):
            got = ae_card.encode(x.cuda())
            slice_check("Flux AutoEncoder encode", got, ae_cpu.encode(x))
            slice_check("Flux AutoEncoder decode", ae_card.decode(got), ae_cpu.decode(got.cpu()))
        recorded.append(("Flux AutoEncoder", calls, affine))

        # Sana: the transformer under the denoiser, and the DC-AE
        cpu, card = pair(SanaTransformer, 47, **TINY_SANA)
        cpu, card = SanaDenoiser(cpu), SanaDenoiser(card)
        cond = {"prompt_embeds": normal(1, 6, 32), "prompt_mask": torch.tensor([[1.0, 1, 1, 1, 0, 0]])}
        card_cond = {k: v.cuda() for k, v in cond.items()}
        x = normal(2, 8, 8, 8)
        for t in (0.3, 0.9):
            slice_check(f"SanaDenoiser t={t}", card(x.cuda(), torch.tensor(t, device="cuda"), **card_cond).mean,
                        cpu(x, torch.tensor(t), **cond).mean)
        slice_check("SanaDenoiser DDIM-4 trajectory", DDIMSampler(card, steps=4)(x.cuda(), **card_cond),
                    DDIMSampler(cpu, steps=4)(x, **cond), TOL_TRAJECTORY)
        cpu, card = pair(AutoencoderDC, 48, **TINY_DCAE)
        for side, branch in ((16, "linear"), (4, "quadratic")):
            x = normal(2, side, side, 3)
            slice_check(f"DC-AE encode, {branch} attention", card.encode(x.cuda()), cpu.encode(x))
            z = normal(2, side // 2, side // 2, 4)
            slice_check(f"DC-AE decode, {branch} attention", card.decode(z.cuda()), cpu.decode(z))

    launched = dict(_build.LAUNCHES)
    # each small VAE's encode (10 GroupNorms) and decode (14), three times
    expected = {"group_norm": 3 * (10 + 14)}
    counted = sum(launch_counts(calls).get("group_norm", 0) for _, calls, _ in recorded)
    log(f"  kernel launches on the card: {launched}, recorded {counted}, expected {expected}")
    if launched != expected or counted != expected["group_norm"]:
        raise AssertionError("the text-to-image slices' launch counts are not exact")
    for label, calls, affine in recorded:
        check_recorded(label, calls, affine, seed=36)


def flux_text_to_image(denoiser: FluxDenoiser, generator) -> dict:
    r"""FLUX.1-dev from a prompt to pixels at full width (phase 36): T5-XXL,
    CLIP-L and the VAE drawn on the card in bf16 beside phase 15's
    transformer, checked against the port's manifests; the prompt through
    `TextEncoder`, DDIM-`FLUX_STEPS`, `AutoEncoder.decode`, each timed, with
    exact launch counts; a profile of the decode; and each GroupNorm call of
    the decode against its plain version, with its plan, its time on the
    device, its bound and `F.group_norm`'s."""

    t0 = time.perf_counter()
    factory = dict(device="cuda", dtype=torch.bfloat16, generator=generator)  # noqa: C408
    t5, clip = T5Encoder(**factory), CLIPTextEncoder(**factory)
    vae = AutoencoderKL(latent_channels=16, use_quant_conv=False, **factory)
    torch.cuda.synchronize()
    counts = {name: sum(p.numel() for p in m.parameters()) for name, m in (("T5", t5), ("CLIP", clip), ("VAE", vae))}
    log(f"drawn on the card in {time.perf_counter() - t0:.1f} s: {counts} bf16 parameters; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB with the transformer")
    for component, module, canonicalize in (
        ("text_encoder", clip, canonicalize_clip_keys),
        ("text_encoder_2", t5, canonicalize_t5_keys),
        ("vae", vae, canonicalize_vae_keys),
        ("transformer", denoiser.backbone, None),
    ):
        check_manifest(module.state_dict(), "flux", "flux_1_dev", component, canonicalize)
    log("flux_1_dev.{text_encoder, text_encoder_2, vae, transformer}: the port's modules match the manifests")

    tok = tokenizers()
    encoder = flux.TextEncoder(clip, tok["clip"], t5, tok["t5"], max_length=FLUX_TEXT)
    autoencoder = flux.AutoEncoder(vae, FLUX_VAE_SHIFT, FLUX_VAE_SCALE)
    sampler = DDIMSampler(denoiser, eta=0.0, steps=FLUX_STEPS)
    x = sampler.init((FLUX_BATCH, FLUX_SIDE, FLUX_SIDE, 64), generator=generator)
    ids = tok["t5"]([T2I_PROMPT], truncation=True, max_length=FLUX_TEXT, padding="max_length")
    log(f"prompt: {len(T2I_PROMPT)} characters, {int(ids.attention_mask.sum())} of {FLUX_TEXT} T5 ids, "
        f"{int(tok['clip']([T2I_PROMPT]).attention_mask.sum())} of 77 CLIP ids")

    with torch.inference_mode():
        grid = sampler.timesteps.cuda()
        cond = encoder(T2I_PROMPT)  # warm-up of each part, untimed
        sampler.step(x, grid[0], grid[1], **cond, guidance=FLUX_GUIDANCE)
        # the sampler's float32 latents go to the VAE in its dtype (bf16):
        # its convolutions take their input's dtype
        with recording() as (calls, affine):
            autoencoder.decode(x.to(torch.bfloat16))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        cond = encoder(T2I_PROMPT)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y = sampler(x, **cond, guidance=FLUX_GUIDANCE)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        image = autoencoder.decode(y.to(torch.bfloat16))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = dict(_build.LAUNCHES)

    peak = torch.cuda.max_memory_allocated()
    if tuple(image.shape) != (FLUX_BATCH, 16 * FLUX_SIDE, 16 * FLUX_SIDE, 3) or not bool(torch.isfinite(image).all()):
        raise AssertionError(f"FLUX.1-dev's image is not finite of shape (1, 1024, 1024, 3): {tuple(image.shape)}")
    if tuple(cond["prompt_t5"].shape) != (1, FLUX_TEXT, 4096) or tuple(cond["prompt_clip"].shape) != (1, 768):
        raise AssertionError("the text encoders' outputs have the wrong shapes")
    expected = {name: n * FLUX_STEPS for name, n in FLUX_CALLS_PER_FORWARD.items()} | FLUX_VAE_CALLS
    log(f"launches {launches}, expected {expected}; recorded in the decode: {launch_counts(calls)}")
    if launches != expected or launch_counts(calls) != FLUX_VAE_CALLS:
        raise AssertionError("the FLUX.1-dev text-to-image path's launch counts are not exact")
    total = t3 - t0
    log(f"FLUX.1-dev prompt to pixels: text encoders {(t1 - t0) * 1e3:.2f} ms, {(t2 - t1) / FLUX_STEPS * 1e3:.2f} ms "
        f"per step ({FLUX_STEPS} steps, {(t2 - t1) * 1e3:.2f} ms), decode {(t3 - t2) * 1e3:.2f} ms; "
        f"{FLUX_BATCH / total:.6f} images/s end to end ({total:.3f} s), peak memory {peak / 2**30:.2f} GiB; "
        f"image mean {image.float().mean().item():.4f}, std {image.float().std().item():.4f}")
    with torch.inference_mode():
        profile_step(lambda: autoencoder.decode(y.to(torch.bfloat16)), "the decode")
        per_kernel = {name: new_entry() for name in ("group_norm", "group_norm_silu")}
        check_gn_calls(calls, affine, generator, per_kernel)
    entry = per_kernel["group_norm"]
    log(f"the decode's {FLUX_VAE_CALLS['group_norm']} GroupNorm calls: {entry['ms']:.4f} ms by events, device "
        f"{entry['device_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
        f"F.group_norm {entry['library_ms']:.4f} ms")

    del t5, clip, vae, encoder, autoencoder, sampler, x, y, image, cond
    torch.cuda.empty_cache()
    return {"launches": launches, "group_norm": entry, "ms": total * 1e3}


def sana_full_width(generator) -> dict:
    r"""sana1k at full width (phase 37), as `bench.py:49-82, 583-601` builds
    it, with its text encoder and its decoder: Gemma-2-2B through the Sana
    `TextEncoder`, DDIM-20 at batch 8 under `SanaDenoiser`, DC-AE in float32;
    each part timed, the trajectory as images/s under bench.py's metric
    name; peak memory, a profile of one step, no launch of our kernels, and
    the three modules against the port's manifests."""

    t0 = time.perf_counter()
    backbone = SanaTransformer(**sana.ARCHS["1.6b"], device="cuda", dtype=torch.bfloat16, generator=generator)
    gemma = Gemma2TextModel(device="cuda", dtype=torch.bfloat16, generator=generator)
    dcae = AutoencoderDC(device="cuda", dtype=torch.float32, generator=generator)
    torch.cuda.synchronize()
    counts = {name: sum(p.numel() for p in m.parameters()) for name, m in (("Sana", backbone), ("Gemma", gemma),
                                                                            ("DC-AE", dcae))}
    log(f"drawn on the card in {time.perf_counter() - t0:.1f} s: {counts} parameters (bf16, bf16, float32); "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    for component, module, canonicalize in (
        ("transformer", backbone, None), ("text_encoder", gemma, canonicalize_gemma_keys), ("vae", dcae, None)
    ):
        check_manifest(module.state_dict(), "sana", "sana_1.6b_1024", component, canonicalize)
    log("sana_1.6b_1024.{transformer, text_encoder, vae}: the port's modules match the manifests")

    encoder = sana.TextEncoder(gemma, tokenizers()["gemma"], max_length=SANA_TEXT)
    autoencoder = sana.AutoEncoder(dcae, scale=SANA_SCALE)
    sampler = DDIMSampler(SanaDenoiser(backbone), eta=0.0, steps=SANA_STEPS)
    x = sampler.init((SANA_BATCH, *SANA_SHAPE), generator=generator)

    peaks, seconds = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated()
        return out

    with torch.inference_mode():
        grid = sampler.timesteps.cuda()
        cond = encoder(T2I_PROMPT)  # warm-up of each part, untimed
        sampler.step(x, grid[0], grid[1], **cond)
        autoencoder.decode(x[:1])

        _build.LAUNCHES.clear()
        cond = timed("text", lambda: encoder(T2I_PROMPT))
        y = timed("trajectory", lambda: sampler(x, **cond))
        images = timed("decode", lambda: autoencoder.decode(y))
        launches = dict(_build.LAUNCHES)

    if tuple(cond["prompt_embeds"].shape) != (1, SANA_TEXT, 2304) or tuple(cond["prompt_mask"].shape) != (1, SANA_TEXT):
        raise AssertionError("the Gemma text encoder's outputs have the wrong shapes")
    if tuple(images.shape) != (SANA_BATCH, 1024, 1024, 3) or not bool(torch.isfinite(images).all()):
        raise AssertionError(f"sana1k's images are not finite of shape (8, 1024, 1024, 3): {tuple(images.shape)}")
    if images.dtype != torch.float32:
        raise AssertionError("DC-AE decoded in another dtype than float32")
    log(f"launches of our kernels {launches}, expected none")
    if launches:
        raise AssertionError("sana1k launched a kernel of ours")
    log(f"{SANA_METRIC}: {SANA_BATCH / seconds['trajectory']:.4f} images/s (DDIM-{SANA_STEPS} at batch {SANA_BATCH}, "
        f"{seconds['trajectory']:.3f} s, {seconds['trajectory'] / SANA_STEPS * 1e3:.2f} ms/step)")
    log(f"sana1k: text encoder {seconds['text'] * 1e3:.2f} ms ({int(cond['prompt_mask'].sum())} of {SANA_TEXT} "
        f"prompt tokens kept), decode {seconds['decode'] * 1e3:.2f} ms (batch {SANA_BATCH}, float32, whole); peak "
        f"memory: text {peaks['text'] / 2**30:.2f}, trajectory {peaks['trajectory'] / 2**30:.2f}, decode "
        f"{peaks['decode'] / 2**30:.2f} GiB; {SANA_BATCH / sum(seconds.values()):.4f} images/s end to end; "
        f"image mean {images.mean().item():.4f}, std {images.std().item():.4f}")
    with torch.inference_mode():
        profile_step(lambda: sampler.step(x, grid[0], grid[1], **cond))

    del backbone, gemma, dcae, encoder, autoencoder, sampler, x, y, images, cond
    torch.cuda.empty_cache()
    return {"images_s": SANA_BATCH / seconds["trajectory"], "seconds": seconds}


def fit_attention(calls) -> collections.Counter:
    r"""`calls` with each attention call whose plain check would hold more
    than `ATTENTION_CHECK_BYTES` of float32 weights (B H L L) moved to batch
    1: the kernel's blocks are (batch, head) pairs, so batch 1 runs the same
    code at the same L and D."""

    fitted = collections.Counter()
    for key, n in calls.items():
        if key[0] == "attn":
            B, H, L, D = key[1]
            if B * H * L * L * 4 > ATTENTION_CHECK_BYTES:
                log(f"  attention {key[1]}: held to its plain version at batch 1")
                key = (key[0], (1, H, L, D), *key[2:])
        fitted[key] += n
    return fitted


def draw_gains(module: torch.nn.Module, generator: torch.Generator) -> None:
    r"""Draws EDM2's scalar gains (`emb_gain`, `out_gain`, zero at
    initialization, which would zero the network's output and its embedding
    modulation) uniformly in [0.5, 1], as the layers that ADM zero-initializes
    are drawn for its full-width runs."""

    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("_gain"):
                p.copy_(torch.empty((), device=generator.device).uniform_(0.5, 1.0, generator=generator))


def per_forward(module: torch.nn.Module) -> collections.Counter:
    r"""The launches of one forward of `module` on the card: one GroupNorm
    per `GroupNorm` layer and per CC12M-1 single-group stage (`'gn1'`), and
    one attention forward per SD self-attention, v-diffusion attention and
    JiT attention whose heads are a kernel's head dim
    (`attention._HEAD_DIMS`)."""

    counts = collections.Counter()
    for name, m in module.named_modules():
        if isinstance(m, GroupNorm) or (isinstance(m, vdm.backbone.VDMStage) and m.kind == "gn1"):
            counts["group_norm"] += 1
        elif isinstance(m, sd.backbone.CrossAttention) and name.endswith("attn1"):
            if m.to_q.weight.shape[0] // m.heads in attention._HEAD_DIMS:
                counts["attention_fwd"] += 1
        elif isinstance(m, vdm.backbone.VDMSelfAttention2d):
            if m.out_proj.weight.shape[0] // m.heads in attention._HEAD_DIMS:
                counts["attention_fwd"] += 1
        elif isinstance(m, jit.backbone.JiTAttention):
            if m.proj.weight.shape[0] // m.num_heads in attention._HEAD_DIMS:
                counts["attention_fwd"] += 1
    return counts


def check_family_slices() -> None:
    r"""The small SD, EDM and EDM2 modules of the CPU tests on the CPU (plain
    versions) and on the card (kernels), same random weights, float32: SD's
    UNet in both projection layouts (one head a level: the attention kernel
    at heads of 32 and 64), `StableDenoiser` with both predictions, a
    batched-CFG DDIM-4 trajectory, the `AutoEncoder` (the same injected
    draws) and the `TextEncoder`; EDM's `SongUNet` (DDPM++ under VP, NCSN++
    under VE, the skip form and the conditional one) and `DhariwalUNet`
    under EDM's precond, `ElucidatedDenoiser` and a Heun-4 trajectory;
    EDM2's network with and without labels, `ElucidatedLatentDenoiser`,
    Heun-4 and its `AutoEncoder`. Launches exact, each recorded call against
    its plain version."""

    rng = np.random.default_rng(38)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def pair(build, seed):
        cpu = build(device="cpu", generator=torch.Generator().manual_seed(seed))
        draw_gains(cpu, torch.Generator().manual_seed(seed))
        return cpu, copy.deepcopy(cpu).cuda()

    def card(tree):
        if isinstance(tree, dict):
            return {k: card(v) for k, v in tree.items()}
        return None if tree is None else tree.cuda()

    expected = collections.Counter()
    recorded = []

    def on_card(label, fn, launches):
        with recording() as (calls, affine):
            out = fn()
        recorded.append((label, calls, affine))
        expected.update(launches)
        return out

    _build.LAUNCHES.clear()
    with torch.inference_mode():
        # Stable Diffusion
        for linear in (False, True):
            cpu, gpu = pair(lambda linear=linear, **f: sd.SDUNet(**TINY_SD, use_linear_projection=linear, **f), 380 + linear)
            z, t, ctx = normal(2, 16, 16, 4), torch.tensor([10, 999]), normal(2, 7, 24)
            got = on_card(f"SDUNet linear={linear}", lambda: gpu(z.cuda(), t.cuda(), ctx.cuda()), per_forward(gpu))
            slice_check(f"SDUNet use_linear_projection={linear}", got, cpu(z, t, ctx))

            prediction = "velocity" if linear else "epsilon"
            den_cpu, den_gpu = sd.StableDenoiser(cpu, prediction=prediction), sd.StableDenoiser(gpu, prediction=prediction)
            ctx = normal(1, 7, 24)
            for time_ in (torch.tensor(0.3), torch.tensor([0.2, 0.9])):
                got = on_card(
                    f"StableDenoiser {prediction}", lambda: den_gpu(z.cuda(), time_.cuda(), prompt_embeds=ctx.cuda()).mean,
                    per_forward(gpu),
                )
                alpha, sigma = den_cpu.schedule(time_)
                slice_check(f"StableDenoiser {prediction} t={time_.tolist()}", got,
                            den_cpu(z, time_, prompt_embeds=ctx).mean, TOL_SLICE * max(1.0, float((sigma / alpha).max())))

            cond = {"positive": {"prompt_embeds": normal(2, 7, 24)}, "negative": {"prompt_embeds": normal(1, 7, 24)},
                    "guidance": 6.5}
            cond_gpu = {**cond, "positive": card(cond["positive"]), "negative": card(cond["negative"])}
            got = on_card(
                f"SD CFG DDIM-4 linear={linear}",
                lambda: DDIMSampler(CFGDenoiser(den_gpu, batched=True), steps=4)(z.cuda(), **cond_gpu),
                {k: 4 * n for k, n in per_forward(gpu).items()},
            )
            slice_check(f"StableDenoiser {prediction} under batched CFG, DDIM-4 trajectory", got,
                        DDIMSampler(CFGDenoiser(den_cpu, batched=True), steps=4)(z, **cond), TOL_TRAJECTORY)

        vae_cpu, vae_gpu = pair(lambda **f: AutoencoderKL(**TINY_VAE, **f), 383)
        ae_cpu, ae_gpu = sd.AutoEncoder(vae_cpu, SD_SCALE), sd.AutoEncoder(vae_gpu, SD_SCALE)
        noise = normal(2, 16, 16, 4)
        ae_cpu._normal = ae_gpu._normal = lambda generator, like: noise.to(like.device)  # the same draws
        x = normal(2, 32, 32, 3)
        got = on_card("SD AutoEncoder", lambda: ae_gpu.encode(x.cuda()), per_forward(vae_gpu.encoder))
        slice_check("SD AutoEncoder encode", got, ae_cpu.encode(x))
        z = normal(1, 8, 8, 4)
        got = on_card("SD AutoEncoder", lambda: ae_gpu.decode(z.cuda()), per_forward(vae_gpu.decoder))
        slice_check("SD AutoEncoder decode", got, ae_cpu.decode(z))
        clip_cpu, clip_gpu = pair(lambda **f: CLIPTextEncoder(**TINY_CLIP, act="gelu", **f), 384)
        tok = tokenizers(TINY_CLIP["vocab_size"], clip_length=TINY_CLIP["max_positions"])["clip"]
        slice_check("SD TextEncoder", sd.TextEncoder(clip_gpu, tok)(list(SD2_PROMPTS[:2]))["prompt_embeds"],
                    sd.TextEncoder(clip_cpu, tok)(list(SD2_PROMPTS[:2]))["prompt_embeds"])

        # EDM: each network under a precond at two noise levels
        labels = torch.eye(10)[[3, 7]]
        for name, precond, unet, config in (
            ("DDPM++ under VPPrecond", edm.VPPrecond, edm.SongUNet, {}),
            ("NCSN++ under VEPrecond", edm.VEPrecond, edm.SongUNet, dict(  # noqa: C408
                embedding_type="fourier", encoder_type="residual", resample_filter=(1, 3, 3, 1), channel_mult_noise=2)),
            ("skip SongUNet under EDMPrecond", edm.EDMPrecond, edm.SongUNet, dict(encoder_type="skip", decoder_type="skip")),  # noqa: C408
            ("conditional SongUNet under VPPrecond", edm.VPPrecond, edm.SongUNet, dict(label_dim=10)),  # noqa: C408
            ("DhariwalUNet under EDMPrecond", edm.EDMPrecond, edm.DhariwalUNet, TINY_DHARIWAL),
        ):
            cpu, gpu = pair(lambda precond=precond, unet=unet, config=config, **f: precond(
                unet(**{**TINY_SONG, **config}, **f)), 385)
            x, sigma = normal(2, 16, 16, 3), torch.tensor([0.3, 5.0])
            y = labels if config.get("label_dim") else None
            got = on_card(f"EDM {name}", lambda: gpu(x.cuda(), sigma.cuda(), class_labels=card(y)), per_forward(gpu))
            slice_check(f"EDM {name}", got, cpu(x, sigma, class_labels=y))

        den_cpu, den_gpu = edm.ElucidatedDenoiser(cpu), edm.ElucidatedDenoiser(gpu)
        for time_ in (torch.tensor(0.4), torch.tensor([0.15, 0.8])):
            got = on_card("ElucidatedDenoiser", lambda: den_gpu(x.cuda(), time_.cuda(), label=labels.cuda()).mean,
                          per_forward(gpu))
            slice_check(f"ElucidatedDenoiser t={time_.tolist()}", got, den_cpu(x, time_, label=labels).mean)
        x1 = normal(2, 16, 16, 3) * 80
        got = on_card("EDM Heun-4", lambda: sample.HeunSampler(den_gpu, steps=4)(x1.cuda(), label=labels.cuda()),
                      {k: 8 * n for k, n in per_forward(gpu).items()})
        slice_check("ElucidatedDenoiser Heun-4 trajectory", got,
                    sample.HeunSampler(den_cpu, steps=4)(x1, label=labels), TOL_TRAJECTORY)

        # EDM2: the network with and without labels, the denoiser, Heun-4, the auto-encoder
        for label_dim in (10, 0):
            cpu, gpu = pair(lambda label_dim=label_dim, **f: eldm.EDM2Precond(
                eldm.EDM2UNet(**{**TINY_EDM2, "label_dim": label_dim}, **f), label_dim=label_dim), 386)
            x, sigma = normal(2, 16, 16, 4), torch.tensor([0.5, 7.0])
            y = labels if label_dim else None
            got = on_card(f"EDM2 label_dim={label_dim}", lambda: gpu(x.cuda(), sigma.cuda(), class_labels=card(y)), {})
            slice_check(f"EDM2Precond label_dim={label_dim}", got, cpu(x, sigma, class_labels=y))
        den_cpu, den_gpu = eldm.ElucidatedLatentDenoiser(cpu), eldm.ElucidatedLatentDenoiser(gpu)
        slice_check("ElucidatedLatentDenoiser t=[0.15, 0.8]",
                    den_gpu(x.cuda(), torch.tensor([0.15, 0.8], device="cuda")).mean,
                    den_cpu(x, torch.tensor([0.15, 0.8])).mean)
        x1 = normal(2, 16, 16, 4) * 80
        slice_check("ElucidatedLatentDenoiser Heun-4 trajectory", sample.HeunSampler(den_gpu, steps=4)(x1.cuda()),
                    sample.HeunSampler(den_cpu, steps=4)(x1), TOL_TRAJECTORY)
        scale = EDM2_FINAL_STD / torch.tensor(EDM2_RAW_STD)
        shift = -torch.tensor(EDM2_RAW_MEAN) * scale
        ae_cpu, ae_gpu = eldm.AutoEncoder(vae_cpu, shift, scale), eldm.AutoEncoder(vae_gpu, shift, scale)
        ae_cpu._normal = ae_gpu._normal = lambda generator, like: noise.to(like.device)
        x = normal(2, 32, 32, 3)
        got = on_card("EDM2 AutoEncoder", lambda: ae_gpu.encode(x.cuda()), per_forward(vae_gpu.encoder))
        slice_check("EDM2 AutoEncoder encode", got, ae_cpu.encode(x))
        z = normal(1, 8, 8, 4)
        got = on_card("EDM2 AutoEncoder", lambda: ae_gpu.decode(z.cuda()), per_forward(vae_gpu.decoder))
        slice_check("EDM2 AutoEncoder decode", got, ae_cpu.decode(z))

    launched = dict(_build.LAUNCHES)
    counted = collections.Counter()
    for _, calls, _ in recorded:
        counted.update(launch_counts(calls))
    log(f"  kernel launches on the card: {launched}, recorded {dict(counted)}, expected {dict(expected)}")
    if launched != dict(expected) or dict(counted) != dict(expected):
        raise AssertionError("the SD, EDM and EDM2 slices' launch counts are not exact")
    for label, calls, affine in recorded:
        if calls:
            check_recorded(label, calls, affine, seed=38)


def sd2_text_to_image(generator) -> dict:
    r"""sd2_768 from prompts to pixels (phase 39): the sd_2 card's UNet,
    CLIP-H and VAE drawn on the card in bf16 and held against the port's
    manifests; four prompts and the empty negative through `TextEncoder`,
    batched CFG at `SD2_GUIDANCE` under `StableDenoiser` (velocity),
    DDIM-`SD2_STEPS`, `AutoEncoder.decode` to (4, 768, 768, 3), each timed,
    with exact launch counts (per UNet call 61 GroupNorm and 16 attention
    launches by L, 30 GroupNorm in the decode); a profile of one step;
    each attention call timed at its shape beside SDPA and its bound, each
    decode GroupNorm timed beside `F.group_norm`, and every recorded call
    against its plain version."""

    t0 = time.perf_counter()
    factory = dict(device="cuda", dtype=torch.bfloat16, generator=generator)  # noqa: C408
    unet = sd.make_backbone("sd_2", **factory)
    clip = CLIPTextEncoder(**sd.ARCHS["sd2"]["clip"], **factory)
    vae = AutoencoderKL(**factory)
    torch.cuda.synchronize()
    counts = {name: sum(p.numel() for p in m.parameters()) for name, m in (("UNet", unet), ("CLIP-H", clip), ("VAE", vae))}
    log(f"drawn on the card in {time.perf_counter() - t0:.1f} s: {counts} bf16 parameters; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    for component, module, canonicalize in (
        ("unet", unet, None), ("text_encoder", clip, canonicalize_clip_keys), ("vae", vae, canonicalize_vae_keys)
    ):
        check_manifest(module.state_dict(), "sd", "sd_2", component, canonicalize)
    log("sd_2.{unet, text_encoder, vae}: the port's modules match the manifests")

    prediction = load_cards(sd)["sd_2"].config["prediction"]
    encoder = sd.TextEncoder(clip, tokenizers()["clip"])
    denoiser = CFGDenoiser(sd.StableDenoiser(unet, prediction=prediction), batched=True)
    autoencoder = sd.AutoEncoder(vae, scale=SD_SCALE)
    sampler = DDIMSampler(denoiser, eta=0.0, steps=SD2_STEPS)
    B = len(SD2_PROMPTS)
    x = sampler.init((B, SD2_SIDE, SD2_SIDE, 4), generator=generator)

    def encode():
        return {"positive": encoder(list(SD2_PROMPTS)), "negative": encoder(""), "guidance": SD2_GUIDANCE}

    seconds = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    with torch.inference_mode():
        grid = sampler.timesteps.cuda()
        cond = encode()  # warm-up of each part, untimed, recorded
        with recording() as (calls, affine):
            sampler.step(x, grid[0], grid[1], **cond)
        with recording() as (decode_calls, decode_affine):
            autoencoder.decode(x.to(torch.bfloat16))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        _build.LAUNCHES.clear()
        cond = timed("text", encode)
        y = timed("trajectory", lambda: sampler(x, **cond))
        # the sampler's float32 latents go to the VAE in its dtype (bf16)
        images = timed("decode", lambda: autoencoder.decode(y.to(torch.bfloat16)))
        launches = dict(_build.LAUNCHES)

    peak = torch.cuda.max_memory_allocated()
    if tuple(images.shape) != (B, 8 * SD2_SIDE, 8 * SD2_SIDE, 3) or not bool(torch.isfinite(images).all()):
        raise AssertionError(f"sd2_768's images are not finite of shape (4, 768, 768, 3): {tuple(images.shape)}")
    hidden = sd.ARCHS["sd2"]["clip"]["hidden"]
    if tuple(cond["positive"]["prompt_embeds"].shape) != (B, 77, hidden) or tuple(
            cond["negative"]["prompt_embeds"].shape) != (1, 77, hidden):
        raise AssertionError("CLIP-H's outputs have the wrong shapes")
    by_l = collections.Counter()
    for key, n in calls.items():
        if key[0] == "attn":
            B2, H, L, D = key[1]
            if (B2, D, H) != (2 * B, 64, SD2_HEADS_BY_L.get(L)):
                raise AssertionError(f"sd2_768: an attention call at {key[1]}")
            by_l[L] += n
    expected = {name: n * SD2_STEPS for name, n in SD2_CALLS_PER_FORWARD.items()}
    expected["group_norm"] += SD_VAE_CALLS["group_norm"]
    log(f"launches {launches}, expected {expected}; recorded in a step {launch_counts(calls)}, attention by L "
        f"{dict(by_l)}; in the decode {launch_counts(decode_calls)}")
    if (launches != expected or launch_counts(calls) != SD2_CALLS_PER_FORWARD or dict(by_l) != SD2_ATTENTION_BY_L
            or launch_counts(decode_calls) != SD_VAE_CALLS):
        raise AssertionError("the sd2_768 path's launch counts are not exact")
    total = sum(seconds.values())
    log(f"sd2_768 prompts to pixels: text encoder {seconds['text'] * 1e3:.2f} ms ({B} prompts and the negative), "
        f"{seconds['trajectory'] / SD2_STEPS * 1e3:.2f} ms per step (DDIM-{SD2_STEPS}, batched CFG at batch "
        f"{2 * B}, {seconds['trajectory']:.3f} s), decode {seconds['decode'] * 1e3:.2f} ms (batch {B}, 768 px); "
        f"{B / seconds['trajectory']:.4f} images/s for the trajectory, {B / total:.4f} end to end ({total:.3f} s), "
        f"peak memory {peak / 2**30:.2f} GiB; image mean {images.float().mean().item():.4f}, "
        f"std {images.float().std().item():.4f}")

    with torch.inference_mode():
        profile_step(lambda: sampler.step(x, grid[0], grid[1], **cond), "one step (batched CFG, batch 8)")
        profile_step(lambda: autoencoder.decode(y.to(torch.bfloat16)), "the decode")
        attn = new_entry()
        for key, n in sorted(calls.items()):
            if key[0] != "attn":
                continue
            q, k, v = (torch.randn(key[1], generator=generator, device="cuda", dtype=torch.bfloat16) for _ in range(3))
            scale = key[3]
            ms = elapsed_ms(lambda: attention._attention_kernel(q, k, v, scale))
            plain = elapsed_ms(lambda: attention._attention_tiled_plain(q, k, v, scale), reps=3, warmup=1)
            library = elapsed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            Bq, H, L, D = key[1]
            ops = 4 * Bq * H * L * L * D
            bound, by = bound_ms(4 * q.numel() * q.element_size(), ops, torch.bfloat16)
            add_timing(attn, n, ms, plain, library, bound, by, 0.0, 0.0, ops)
            log(f"  attention {key[1]} bfloat16 x{n}/UNet call: {ms:.4f} ms ({speed(ops, ms, bound)}), "
                f"plain {plain:.4f} ms, SDPA {library:.4f} ms, bound {bound:.4f} ms ({by})")
            del q, k, v
        log(f"the UNet call's {SD2_CALLS_PER_FORWARD['attention_fwd']} attention calls: {attn['ms']:.4f} ms by events ({attn['ops'] / attn['ms'] / 1e9:.1f} "
            f"TFLOP/s), bound {attn['bound_ms']:.4f} ms, plain {attn['plain_ms']:.4f} ms, SDPA {attn['library_ms']:.4f} ms")
        per_kernel = {name: new_entry() for name in ("group_norm", "group_norm_silu")}
        check_gn_calls(decode_calls, decode_affine, generator, per_kernel)
    gn = per_kernel["group_norm"]
    log(f"the decode's {SD_VAE_CALLS['group_norm']} GroupNorm calls: {gn['ms']:.4f} ms by events, device "
        f"{gn['device_ms']:.4f} ms, bound {gn['bound_ms']:.4f} ms, plain {gn['plain_ms']:.4f} ms, "
        f"F.group_norm {gn['library_ms']:.4f} ms")

    del unet, clip, vae, encoder, denoiser, autoencoder, sampler, x, y, images, cond
    torch.cuda.empty_cache()
    check_recorded("sd2_768, one UNet call under batched CFG (batch 8)", fit_attention(calls), affine, seed=390)
    return {"launches": launches, "seconds": seconds, "images_s": B / seconds["trajectory"], "attention": attn}


def one_call(label: str, denoiser, x, t, cond: dict, per_call: dict) -> dict:
    r"""One denoiser call at `x` and `t` with the conditions `cond`: a
    recorded warm-up call, then a timed one, finite, with exactly
    `per_call` launches; its ms, peak memory and a profile. Returns its
    launches, ms and the recorded call."""

    rows = x.shape[0] * (2 if isinstance(denoiser, CFGDenoiser) and denoiser.batched else 1)
    with torch.inference_mode():
        with recording() as (calls, affine):
            denoiser(x, t, **cond)  # warm-up, recorded
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = denoiser(x, t, **cond).mean
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)

    if tuple(out.shape) != tuple(x.shape) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}'s call is not finite")
    log(f"launches {launches}, expected {per_call}; recorded {launch_counts(calls)}, attention by L "
        f"{dict(by_length(calls))}")
    if launches != per_call or launch_counts(calls) != per_call:
        raise AssertionError(f"{label}'s launch counts are not exact")
    log(f"{label}: one call on {rows} rows of {tuple(x.shape[1:])} {ms:.2f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean {out.float().mean().item():.4f}, "
        f"std {out.float().std().item():.4f}")
    with torch.inference_mode():
        profile_step(lambda: denoiser(x, t, **cond), f"one call ({rows} rows)")
    return {"launches": launches, "ms": ms, "calls": (calls, affine)}


def sd1_call(generator) -> dict:
    r"""sd1_512 (phase 40): the sd_1.5 card's UNet in bf16, held against its
    manifest, under `StableDenoiser` (epsilon) and batched CFG: one call at
    batch 2 on (2, 64, 64, 4) latents with random prompt embeddings
    (`one_call`: finite, exactly 61 GroupNorm launches and no attention
    launch, heads of 40, 80 and 160 taking the plain route), every recorded
    call against its plain version."""

    unet = sd.make_backbone("sd_1.5", device="cuda", dtype=torch.bfloat16, generator=generator)
    check_manifest(unet.state_dict(), "sd", "sd_1.5", "unet")
    log(f"sd_1.5 UNet: {sum(p.numel() for p in unet.parameters()):,} bf16 parameters, matching the manifest")
    denoiser = CFGDenoiser(sd.StableDenoiser(unet), batched=True)
    x = torch.randn((SD1_BATCH, 64, 64, 4), generator=generator, device="cuda")
    cond = {
        "positive": {"prompt_embeds": torch.randn((SD1_BATCH, 77, 768), generator=generator, device="cuda")},
        "negative": {"prompt_embeds": torch.randn((1, 77, 768), generator=generator, device="cuda")},
        "guidance": SD2_GUIDANCE,
    }
    run = one_call("sd1_512", denoiser, x, torch.tensor(0.5, device="cuda"), cond, SD1_CALLS_PER_FORWARD)
    calls, affine = run.pop("calls")

    del unet, denoiser, x, cond
    torch.cuda.empty_cache()
    check_recorded("sd1_512", calls, affine, seed=400)
    return run


def full_width_trajectory(label: str, sampler, backbone, x, cond: dict, per_call: dict, by_l: dict | None = None):
    r"""The trajectory of `sampler` from `x` with the conditions `cond`: one
    recorded network call (exactly `per_call` launches, the attention calls
    by L as `by_l` where given), a warm-up step, then the timed trajectory
    with exactly `per_call` launches per call of `backbone` (two a Heun
    step, one a DDIM step); prints images/s, ms a step and a network call,
    peak memory and a profile of one step. Returns the trajectory, its
    launches, its seconds and the recorded call."""

    denoiser = sampler.denoiser
    steps = sampler.steps
    calls_per_step = 2 if isinstance(sampler, sample.HeunSampler) else 1
    rows = x.shape[0] * (2 if isinstance(denoiser, CFGDenoiser) and denoiser.batched else 1)
    network_calls = [0]
    hook = backbone.register_forward_pre_hook(lambda *_: network_calls.__setitem__(0, network_calls[0] + 1))

    with torch.inference_mode():
        grid = sampler.timesteps.cuda()
        with recording() as (calls, affine):
            denoiser(x, grid[1], **cond)
        sampler.step(x, grid[0], grid[1], **cond)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        network_calls[0] = 0
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        y = sampler(x, **cond)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    hook.remove()

    peak = torch.cuda.max_memory_allocated()
    if tuple(y.shape) != tuple(x.shape) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{label}'s trajectory is not finite")
    expected = {name: n * network_calls[0] for name, n in per_call.items()}
    log(f"launches {launches}, expected {expected} ({network_calls[0]} network calls on {rows} rows); recorded in "
        f"one call {launch_counts(calls)}, attention by L {dict(by_length(calls))}")
    if (network_calls[0] != calls_per_step * steps or launches != expected or launch_counts(calls) != per_call
            or (by_l is not None and dict(by_length(calls)) != by_l)):
        raise AssertionError(f"{label}'s launch counts are not exact")
    log(f"{label}: {steps} steps at batch {x.shape[0]} ({rows} rows a network call): {seconds:.3f} s, "
        f"{x.shape[0] / seconds:.4f} images/s, {seconds / steps * 1e3:.2f} ms a step, "
        f"{seconds / network_calls[0] * 1e3:.2f} ms per network call, peak memory {peak / 2**30:.2f} GiB; "
        f"sample mean {y.float().mean().item():.4f}, std {y.float().std().item():.4f}")
    with torch.inference_mode():
        profile_step(lambda: sampler.step(x, grid[0], grid[1], **cond), f"one step ({calls_per_step} network calls)")
    return y, launches, seconds, (calls, affine)


def edm64_full_width(generator) -> dict:
    r"""edm64 (phase 41): the imagenet_64x64_cond network in bf16 under
    EDMPrecond and `ElucidatedDenoiser`, Heun-18 at batch 64 with one-hot
    labels arange(64) % 1000 (`full_width_trajectory`: exactly 95 GroupNorm
    launches a network call), every recorded call against its plain
    version."""

    net = edm.EDMPrecond(edm.DhariwalUNet(**EDM64, device="cuda", dtype=torch.bfloat16, generator=generator))
    log(f"edm64 (imagenet_64x64_cond): {sum(p.numel() for p in net.parameters()):,} bf16 parameters")
    labels = F.one_hot(torch.arange(EDM64_BATCH, device="cuda") % 1000, 1000).float()
    sampler = sample.HeunSampler(edm.ElucidatedDenoiser(net), steps=EDM64_STEPS)
    x = sampler.init((EDM64_BATCH, 64, 64, 3), generator=generator)
    _, launches, seconds, (calls, affine) = full_width_trajectory(
        "edm64", sampler, net, x, {"label": labels}, EDM64_CALLS_PER_FORWARD
    )
    del net
    torch.cuda.empty_cache()
    check_recorded("edm64, one network call (batch 64)", calls, affine, seed=410)
    return {"launches": launches, "images_s": EDM64_BATCH / seconds, "ms_per_call": seconds / (2 * EDM64_STEPS) * 1e3}


def edm2_full_width(generator) -> dict:
    r"""edm2_xxl (phase 42): the imagenet_512x512_xxl network in bf16 (its
    gains drawn) under EDM2Precond and `ElucidatedLatentDenoiser`, Heun-32 at
    batch 8 with labels arange(8) % 1000 (`full_width_trajectory`: no launch of
    ours), then the decode through the sd-vae-ft-mse VAE (bf16, the SD VAE
    manifest's architecture) with StabilityVAEEncoder's statistics to a
    finite (8, 512, 512, 3): exactly 30 GroupNorm launches, timed, profiled,
    each GroupNorm call against its plain version, timed beside
    `F.group_norm`."""

    net = eldm.EDM2Precond(
        eldm.EDM2UNet(**EDM2_XXL, device="cuda", dtype=torch.bfloat16, generator=generator), label_dim=1000
    )
    draw_gains(net, generator)
    vae = AutoencoderKL(device="cuda", dtype=torch.bfloat16, generator=generator)
    check_manifest(vae.state_dict(), "sd", "sd_1.5", "vae", canonicalize_vae_keys)
    log(f"edm2_xxl (imagenet_512x512_xxl): {sum(p.numel() for p in net.parameters()):,} bf16 parameters; the VAE "
        f"matches the SD VAE manifest")
    scale = EDM2_FINAL_STD / torch.tensor(EDM2_RAW_STD)
    autoencoder = eldm.AutoEncoder(vae, shift=-torch.tensor(EDM2_RAW_MEAN) * scale, scale=scale).to(torch.bfloat16)
    labels = F.one_hot(torch.arange(EDM2_BATCH, device="cuda") % 1000, 1000).float()
    sampler = sample.HeunSampler(eldm.ElucidatedLatentDenoiser(net), steps=EDM2_STEPS)
    x = sampler.init((EDM2_BATCH, 64, 64, 4), generator=generator)
    y, launches, seconds, _ = full_width_trajectory("edm2_xxl", sampler, net, x, {"label": labels}, {})

    with torch.inference_mode():
        with recording() as (calls, affine):
            autoencoder.decode(y.to(torch.bfloat16))  # warm-up, recorded
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        images = autoencoder.decode(y.to(torch.bfloat16))
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3
        decode_launches = dict(_build.LAUNCHES)

    if tuple(images.shape) != (EDM2_BATCH, 512, 512, 3) or not bool(torch.isfinite(images).all()):
        raise AssertionError(f"edm2_xxl's images are not finite of shape (8, 512, 512, 3): {tuple(images.shape)}")
    log(f"decode launches {decode_launches}, expected {SD_VAE_CALLS}; recorded {launch_counts(calls)}")
    if decode_launches != SD_VAE_CALLS or launch_counts(calls) != SD_VAE_CALLS:
        raise AssertionError("the edm2_xxl decode's launch counts are not exact")
    log(f"edm2_xxl decode: {decode_ms:.2f} ms (batch {EDM2_BATCH}, 512 px), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {EDM2_BATCH / (seconds + decode_ms / 1e3):.4f} "
        f"images/s with the decode; image mean {images.float().mean().item():.4f}, std {images.float().std().item():.4f}")
    with torch.inference_mode():
        profile_step(lambda: autoencoder.decode(y.to(torch.bfloat16)), "the decode")
        per_kernel = {name: new_entry() for name in ("group_norm", "group_norm_silu")}
        check_gn_calls(calls, affine, generator, per_kernel)
    gn = per_kernel["group_norm"]
    log(f"the decode's {SD_VAE_CALLS['group_norm']} GroupNorm calls: {gn['ms']:.4f} ms by events, device "
        f"{gn['device_ms']:.4f} ms, bound {gn['bound_ms']:.4f} ms, plain {gn['plain_ms']:.4f} ms, "
        f"F.group_norm {gn['library_ms']:.4f} ms")

    del net, vae, autoencoder, y, images
    torch.cuda.empty_cache()
    launches = {name: launches.get(name, 0) + n for name, n in decode_launches.items()}
    return {"launches": launches, "images_s": EDM2_BATCH / seconds, "ms_per_call": seconds / (2 * EDM2_STEPS) * 1e3}


def draw_zeroed(module: torch.nn.Module, generator: torch.Generator) -> None:
    r"""Draws the layers that JiT zero-initializes (each block's AdaLN
    modulation, the final layer's linear and modulation), which would zero
    every block's update and the output, uniformly within 1 / sqrt(fan in),
    as the layers that ADM zero-initializes are drawn for its full-width
    runs."""

    with torch.no_grad():
        for name, m in module.named_modules():
            if name.endswith(("adaLN_modulation.1", "final_layer.linear")):
                bound = 1 / math.sqrt(m.weight.shape[1])
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)


def by_length(calls) -> collections.Counter:
    r"""The recorded attention calls by sequence length."""

    counts = collections.Counter()
    for key, n in calls.items():
        if key[0] == "attn":
            counts[key[1][2]] += n
    return counts


def check_vdm_jit_slices() -> None:
    r"""The small v-diffusion, CC12M-1 and JiT modules of the CPU tests on
    the CPU (plain versions) and on the card (kernels), same random weights,
    float32: a `VDMUNet` (heads of 32 and 64, affine pre-norms, bilinear
    upsampling) under `VelocityDenoiser` and a DDIM-4 trajectory; the
    attention block with its pre-norm at 1024 and 2048 channels (one group
    of two and four bands); CC12M-1's FiLM convolution blocks at 512 and
    1024 channels and its skip block; JiT (heads of 32, its zero-initialized
    layers drawn) under `JITDenoiser` with and without labels, and a Heun-4
    trajectory under batched CFG. Launches exact, each recorded call against
    its plain version."""

    def pair(build, seed):
        cpu = build(device="cpu", generator=torch.Generator().manual_seed(seed))
        draw_zeroed(cpu, torch.Generator().manual_seed(seed))
        return cpu, copy.deepcopy(cpu).cuda()

    rng = np.random.default_rng(43)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    expected = collections.Counter()
    recorded = []

    def on_card(label, fn, launches):
        with recording() as (calls, affine):
            out = fn()
        recorded.append((label, calls, affine))
        expected.update(launches)
        return out

    _build.LAUNCHES.clear()
    with torch.inference_mode():
        # v-diffusion
        spec = vdm.VDMSpec(**TINY_VDM)
        cpu, gpu = pair(lambda **f: vdm.VDMUNet(spec, **f), 430)
        x, t = normal(2, 16, 16, 3), torch.tensor([0.3, 0.8])
        got = on_card("VDMUNet", lambda: gpu(x.cuda(), t.cuda()), per_forward(gpu))
        slice_check("VDMUNet", got, cpu(x, t))
        den_cpu, den_gpu = vdm.VelocityDenoiser(cpu), vdm.VelocityDenoiser(gpu)
        for time_ in (torch.tensor(0.4), torch.tensor([0.15, 0.8])):
            got = on_card("VelocityDenoiser", lambda: den_gpu(x.cuda(), time_.cuda()).mean, per_forward(gpu))
            alpha, sigma = den_cpu.schedule(time_)
            slice_check(f"VelocityDenoiser t={time_.tolist()}", got, den_cpu(x, time_).mean,
                        TOL_SLICE * max(1.0, float((sigma / alpha).max())))
        got = on_card("VDM DDIM-4", lambda: DDIMSampler(den_gpu, steps=4)(x.cuda()),
                      {k: 4 * n for k, n in per_forward(gpu).items()})
        slice_check("VelocityDenoiser DDIM-4 trajectory", got, DDIMSampler(den_cpu, steps=4)(x), TOL_TRAJECTORY)

        # the wide pre-norms: one group of 1024 and 2048 channels
        for C, side in ((1024, 8), (2048, 4)):
            cpu, gpu = pair(lambda C=C, **f: vdm.backbone.VDMSelfAttention2d(C, C // 64, pre_norm=True, **f), 431)
            x = normal(2, side, side, C) * 2 + 0.5
            got = on_card(f"VDMSelfAttention2d C={C}", lambda: gpu(x.cuda()), per_forward(gpu))
            slice_check(f"VDMSelfAttention2d, pre-norm of one group of {C} channels", got, cpu(x))

        # CC12M-1's blocks: the FiLM convolution blocks, the skip block
        cond = normal(2, 64)
        for C, side in ((512, 8), (1024, 4)):
            cpu, gpu = pair(lambda C=C, **f: vdm.cc12m.CC12MModConvBlock(64, C, C, C, **f), 432)
            x = normal(2, side, side, C)
            got = on_card(f"CC12MModConvBlock C={C}", lambda: gpu(x.cuda(), cond.cuda()), per_forward(gpu))
            slice_check(f"CC12MModConvBlock, single groups of {C} channels", got, cpu(x, cond))
        cpu, gpu = pair(lambda **f: vdm.cc12m.CC12MSkipBlock([
            vdm.backbone.VDMStage("down"), vdm.cc12m.CC12MModConvBlock(64, 64, 128, 64, **f),
            vdm.backbone.VDMSelfAttention2d(64, 1, pre_norm=True, **f), vdm.backbone.VDMStage("up", "bilinear"),
        ]), 433)
        x = normal(2, 16, 16, 64)
        got = on_card("CC12MSkipBlock", lambda: gpu(x.cuda(), cond.cuda()), per_forward(gpu))
        slice_check("CC12MSkipBlock", got, cpu(x, cond))

        # JiT
        cpu, gpu = pair(lambda **f: jit.JiT(**TINY_JIT, **f), 434)
        den_cpu, den_gpu = jit.JITDenoiser(cpu, num_classes=10), jit.JITDenoiser(gpu, num_classes=10)
        x, labels = normal(2, 64, 64, 3), torch.tensor([3, 10])
        for label in (labels, None):
            for time_ in (torch.tensor(0.4), torch.tensor([0.15, 0.8])):
                got = on_card("JITDenoiser", lambda: den_gpu(x.cuda(), time_.cuda(), label=None if label is None else label.cuda()).mean,
                              per_forward(gpu))
                slice_check(f"JITDenoiser t={time_.tolist()} labels={label is not None}", got,
                            den_cpu(x, time_, label=label).mean)
        cond = {"positive": {"label": labels}, "negative": {"label": torch.tensor([10])}, "guidance": JIT_GUIDANCE}
        cond_gpu = {**cond, "positive": {"label": labels.cuda()}, "negative": {"label": torch.tensor([10]).cuda()}}
        got = on_card("JiT CFG Heun-4", lambda: sample.HeunSampler(CFGDenoiser(den_gpu, batched=True), steps=4)(
            x.cuda(), **cond_gpu), {k: 8 * n for k, n in per_forward(gpu).items()})
        slice_check("JITDenoiser under batched CFG, Heun-4 trajectory", got,
                    sample.HeunSampler(CFGDenoiser(den_cpu, batched=True), steps=4)(x, **cond), TOL_TRAJECTORY)

    launched = dict(_build.LAUNCHES)
    counted = collections.Counter()
    for _, calls, _ in recorded:
        counted.update(launch_counts(calls))
    log(f"  kernel launches on the card: {launched}, recorded {dict(counted)}, expected {dict(expected)}")
    if launched != dict(expected) or dict(counted) != dict(expected):
        raise AssertionError("the v-diffusion and JiT slices' launch counts are not exact")
    for label, calls, affine in recorded:
        if calls:
            check_recorded(label, calls, affine, seed=43)


def timings(calls: int, timed: dict) -> dict:
    r"""The kernels line's record of `calls` timed calls (`new_entry`'s sums);
    a device time the profiler did not measure (NaN) is null."""

    return {
        "calls": calls, "ms": timed["ms"],
        "device_ms": None if math.isnan(timed["device_ms"]) else timed["device_ms"],
        "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"], "library_ms": timed["library_ms"],
        "max_err": timed["max_err"],
    }


def bf16_model(build, generator, zeroed: bool = False) -> torch.nn.Module:
    r"""A model built by `build(**factory)` in bf16 on the card from
    `generator`, JiT's zero-initialized layers drawn where `zeroed`."""

    t0 = time.perf_counter()
    model = build(device="cuda", dtype=torch.bfloat16, generator=generator)
    if zeroed:
        draw_zeroed(model, generator)
    torch.cuda.synchronize()
    log(f"  {sum(p.numel() for p in model.parameters()):,} bf16 parameters drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def timed_gn(calls, affine, generator, what: str) -> dict:
    r"""Each recorded GroupNorm call of a path timed beside its bound and
    `F.group_norm` (`check_gn_calls`), summed over the call's launches."""

    per_kernel = {name: new_entry() for name in ("group_norm", "group_norm_silu")}
    with torch.inference_mode():
        check_gn_calls(calls, affine, generator, per_kernel)
    gn = per_kernel["group_norm"]
    log(f"{what}'s GroupNorm calls: {gn['ms']:.4f} ms by events, device {gn['device_ms']:.4f} ms, bound "
        f"{gn['bound_ms']:.4f} ms, plain {gn['plain_ms']:.4f} ms, F.group_norm {gn['library_ms']:.4f} ms")
    return gn


def cc12m_full_width(generator) -> dict:
    r"""cc12m_cfg256 (phase 44): CC12M-1 in bf16 under `VelocityDenoiser`
    and batched CFG at `CC12M_GUIDANCE`, eight seeded unit-norm CLIP image
    embeddings against the zero embedding, DDIM-`CC12M_STEPS` on (8, 256,
    256, 3) (`full_width_trajectory`: 135 GroupNorm and 24 attention launches a
    call, 8 at each L); each GroupNorm call of a call timed beside its bound
    and `F.group_norm`; every recorded call against its plain version."""

    model = bf16_model(lambda **f: vdm.CC12M1Model(**f), generator)
    denoiser = vdm.VelocityDenoiser(model)
    clip = torch.randn((CC12M_BATCH, 512), generator=generator, device="cuda")
    cond = {
        "positive": {"clip_embed": clip / torch.linalg.vector_norm(clip, dim=-1, keepdim=True)},
        "negative": {"clip_embed": torch.zeros((1, 512), device="cuda")},
        "guidance": CC12M_GUIDANCE,
    }
    sampler = DDIMSampler(CFGDenoiser(denoiser, batched=True), eta=0.0, steps=CC12M_STEPS)
    x = sampler.init((CC12M_BATCH, 256, 256, 3), generator=generator)
    if per_forward(model) != collections.Counter(CC12M_CALLS_PER_FORWARD):
        raise AssertionError(f"CC12M-1's modules give {per_forward(model)} launches a call")

    _, launches, seconds, (calls, affine) = full_width_trajectory(
        "cc12m_cfg256", sampler, model, x, cond, CC12M_CALLS_PER_FORWARD, CC12M_ATTENTION_BY_L
    )
    gn = timed_gn(calls, affine, generator, "cc12m_cfg256's network call (batch 16)")
    del model, denoiser, sampler, x, cond
    torch.cuda.empty_cache()
    check_recorded("cc12m_cfg256, one network call under batched CFG (batch 16)", calls, affine, seed=440)
    return {"launches": launches, "images_s": CC12M_BATCH / seconds, "ms_step": seconds / CC12M_STEPS * 1e3,
            "group_norm": gn}


def vdm_cards_full_width(generator) -> dict:
    r"""vdm_yfcc512L and vdm_in128 (phase 45): the yfcc_512x512_large card's
    network (bf16, against its manifest) under `VelocityDenoiser`, one call
    at batch 4 on (4, 512, 512, 3) (12 GroupNorm launches on groups of 1024
    and 2048 channels, 12 attention), its GroupNorm calls timed beside their
    bound and `F.group_norm`; the imagenet_128x128 card's, one call at batch
    16 (24 attention launches at heads of 128); every recorded call against
    its plain version."""

    runs = {}
    for card_name, batch, side, per_call in (
        (YFCC_CARD, YFCC_BATCH, 512, YFCC_CALLS_PER_FORWARD),
        (IN128_CARD, IN128_BATCH, 128, IN128_CALLS_PER_FORWARD),
    ):
        spec = load_cards(vdm)[card_name].config["model"]
        model = bf16_model(lambda spec=spec, **f: vdm.VDMUNet(vdm.SPECS[spec], **f), generator)
        check_manifest(model.state_dict(), "vdm", card_name, "model")
        log(f"  {card_name} ({spec}) matches its manifest")
        x = torch.randn((batch, side, side, 3), generator=generator, device="cuda")
        run = one_call(card_name, vdm.VelocityDenoiser(model), x, torch.tensor(0.5, device="cuda"), {}, per_call)
        calls, affine = run.pop("calls")
        if any(k[0] == "gn" for k in calls):
            run["group_norm"] = timed_gn(calls, affine, generator, f"{card_name}'s call")
        del model, x
        torch.cuda.empty_cache()
        check_recorded(f"{card_name}, one call (batch {batch})", calls, affine, seed=450)
        runs[card_name] = run
    return runs


def jit_full_width(generator) -> dict:
    r"""jit_l16_cfg (phase 46): the jit_0.5b_16 card's JiT-L/16 (bf16, its
    zero-initialized layers drawn, against its manifest) under `JITDenoiser`
    and batched CFG at `JIT_GUIDANCE`, labels arange(8) % 1000 against the
    null label, Heun-`JIT_STEPS` on (8, 256, 256, 3) (`full_width_trajectory`: 24
    attention launches a network call, 8 at L = 256 and 16 at 288); every
    recorded call against its plain version."""

    config = load_cards(jit)[JIT_L_CARD].config["model"]
    model = bf16_model(lambda **f: jit.JiT(**jit.JIT_CONFIGS[config], **f), generator, zeroed=True)
    check_manifest(model.state_dict(), "jit", JIT_L_CARD, "model")
    log(f"  {JIT_L_CARD} ({config}) matches its manifest")
    denoiser = jit.JITDenoiser(model)
    cond = {
        "positive": {"label": torch.arange(JIT_BATCH, device="cuda") % 1000},
        "negative": {"label": torch.tensor([1000], device="cuda")},
        "guidance": JIT_GUIDANCE,
    }
    sampler = sample.HeunSampler(CFGDenoiser(denoiser, batched=True), steps=JIT_STEPS)
    x = sampler.init((JIT_BATCH, 256, 256, 3), generator=generator)

    _, launches, seconds, (calls, affine) = full_width_trajectory(
        "jit_l16_cfg", sampler, model, x, cond, JIT_L_CALLS_PER_FORWARD, JIT_L_ATTENTION_BY_L
    )
    del model, denoiser, sampler, x, cond
    torch.cuda.empty_cache()
    check_recorded("jit_l16_cfg, one network call under batched CFG (batch 16)", calls, affine, seed=460)
    return {"launches": launches, "images_s": JIT_BATCH / seconds, "ms_step": seconds / JIT_STEPS * 1e3}


def jit_h_call(generator) -> dict:
    r"""jit_h16 (phase 47): the jit_1.0b_16 card's JiT-H/16 (bf16, zeroed
    layers drawn, against its manifest), one batched CFG call at batch 8:
    finite, no launch of ours (heads of 80 take the plain route)."""

    config = load_cards(jit)[JIT_H_CARD].config["model"]
    model = bf16_model(lambda **f: jit.JiT(**jit.JIT_CONFIGS[config], **f), generator, zeroed=True)
    check_manifest(model.state_dict(), "jit", JIT_H_CARD, "model")
    log(f"  {JIT_H_CARD} ({config}) matches its manifest")
    denoiser = CFGDenoiser(jit.JITDenoiser(model), batched=True)
    x = torch.randn((JIT_BATCH, 256, 256, 3), generator=generator, device="cuda")
    cond = {
        "positive": {"label": torch.arange(JIT_BATCH, device="cuda") % 1000},
        "negative": {"label": torch.tensor([1000], device="cuda")},
        "guidance": JIT_GUIDANCE,
    }
    run = one_call(JIT_H_CARD, denoiser, x, torch.tensor(0.5, device="cuda"), cond, {})
    run.pop("calls")
    del model, denoiser, x
    torch.cuda.empty_cache()
    return run


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


SAFETENSORS_NAMES = {torch.float16: "F16", torch.bfloat16: "BF16", torch.float32: "F32", torch.int64: "I64"}


def write_safetensors(path: pathlib.Path, tensors: dict) -> int:
    r"""Writes `tensors` as a safetensors file (the card's machine has no
    `safetensors` package): an 8-byte little-endian header length, the JSON
    header padded with spaces to 8 bytes, the raw bytes in order. Returns the
    file's size."""

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)

    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return 8 + len(raw) + offset


def hold_loaded(label: str, module: torch.nn.Module, want: dict, canonicalize=None) -> int:
    r"""Every parameter of a loaded `module` lies on the card and equals the
    source's tensor (`want`, by the checkpoint's names) cast to bf16, bit for
    bit. Returns the number of parameters."""

    names = {k: k for k in module.state_dict()}
    if canonicalize is not None:
        names = canonicalize(names)
    own = module.state_dict()
    if set(names) != set(want):
        raise AssertionError(f"{label}: the loaded module's names are not the checkpoint's")
    for key, value in want.items():
        got = own[names[key]]
        if got.device.type != "cuda" or got.dtype != torch.bfloat16:
            raise AssertionError(f"{label}: {key} is {got.dtype} on {got.device}")
        if not torch.equal(got, value.to("cuda", torch.bfloat16).reshape(got.shape)):
            raise AssertionError(f"{label}: {key} differs from the source's")
    return sum(p.numel() for p in module.parameters())


def load_adm256(generator) -> dict:
    r"""Phase 49 (a): ADM `imagenet_256x256` loaded by `adm.load_model` from a
    full-width guided-diffusion `.pt` (float32, written from a seeded model
    built on the CPU) in the hub, bf16 on the card: bitwise parameters, the
    load's peak device memory, then DDIM-8 at batch 8 with the loaded model
    and with the source moved to the card, exact launches, equal
    trajectories."""

    name = "imagenet_256x256"
    card = load_cards(adm)[name]
    t0 = time.perf_counter()
    source = full_width_model(torch.Generator().manual_seed(49), name, dtype=torch.float32)
    ckpt = canonicalize_adm_keys(source.backbone.state_dict())
    # the attention's projections are conv1d kernels in the checkpoints
    ckpt = {k: v[..., None] if k.endswith(("qkv.weight", "proj_out.weight")) else v for k, v in ckpt.items()}
    path = hub.get_hub_dir() / hub.cache_name(card.url)
    torch.save(ckpt, path)
    size = path.stat().st_size
    log(f"{name}: {sum(v.numel() for v in ckpt.values()):,} float32 parameters built on the CPU and saved, "
        f"{size / 1e9:.3f} GB, in {time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    denoiser = adm.load_model(name, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base

    n = hold_loaded(name, denoiser.backbone, ckpt, canonicalize_adm_keys)
    limit = 2 * n + LOAD_SLACK_BYTES
    log(f"{name} loaded in {seconds:.3f} s ({size / seconds / 1e9:.3f} GB/s of the file), {n:,} bf16 parameters "
        f"on the card equal to the source's; peak device memory of the load {peak / 2**20:.1f} MiB, limit "
        f"{limit / 2**20:.1f} MiB (the bf16 parameters {2 * n / 2**20:.1f} MiB + {LOAD_SLACK_BYTES / 2**20:.0f})")
    if peak > limit:
        raise AssertionError(f"{name}: the load took {peak} bytes on the card, above {limit}")
    if not torch.equal(denoiser.sigmas.cpu(), source.sigmas):
        raise AssertionError(f"{name}: the loaded discrete table differs from the source's")

    source.backbone.to("cuda", torch.bfloat16)
    source.to("cuda")
    del ckpt

    sampler = DDIMSampler(denoiser, eta=0.0, steps=LOAD_ADM_STEPS)
    x = sampler.init((BATCH, 256, 256, 3), generator=generator)
    with torch.inference_mode():
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        y = sampler(x)
        torch.cuda.synchronize()
        trajectory = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        want = DDIMSampler(source, eta=0.0, steps=LOAD_ADM_STEPS)(x)

    expected = {k: v * LOAD_ADM_STEPS for k, v in CALLS_PER_FORWARD.items()}
    log(f"launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"{name}: the loaded model's launch counts are not exact")
    if not bool(torch.isfinite(y).all()) or y.shape != x.shape:
        raise AssertionError(f"{name}: the loaded model's trajectory is not finite")
    if torch.equal(y, want):
        log(f"DDIM-{LOAD_ADM_STEPS} at batch {BATCH}, {trajectory:.3f} s: the loaded model's trajectory equals the "
            f"source's bit for bit; mean {y.float().mean().item():.4f}, std {y.float().std().item():.4f}")
    else:
        _, err = errors(y, want)
        log(f"DDIM-{LOAD_ADM_STEPS}: the loaded model's trajectory is not the source's bit for bit: rel err "
            f"{err:.3e} (tol {TOL_TRAJECTORY})")
        if err > TOL_TRAJECTORY:
            raise AssertionError(f"{name}: the loaded model's trajectory differs from the source's")

    del denoiser, source, sampler, x, y, want
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": seconds, "gb_s": size / seconds / 1e9, "peak_mib": peak / 2**20}


def load_sd2_unet(generator) -> dict:
    r"""Phase 49 (b): the sd_2 UNet read from a full-width float16
    `unet/diffusion_pytorch_model.fp16.safetensors` (written from the port's
    UNet drawn on the card) by `sd.load_unet`, the helper of `sd.load_model`,
    bf16 on the card: bitwise parameters, then one batched CFG call at batch
    8 on 96 x 96 latents with exact launches, every recorded call against
    its plain version."""

    entry = load_cards(sd)["sd_2"]
    url = f"https://huggingface.co/{entry.repo}/resolve/main/unet/diffusion_pytorch_model.{entry.variant}.safetensors"
    path = hub.get_hub_dir() / hub.cache_name(url)

    t0 = time.perf_counter()
    source = sd.make_backbone("sd_2", device="cuda", dtype=torch.float16, generator=generator)
    ckpt = source.state_dict()
    size = write_safetensors(path, ckpt)
    log(f"sd_2 UNet: {sum(v.numel() for v in ckpt.values()):,} float16 parameters drawn on the card and written as "
        f"safetensors, {size / 1e9:.3f} GB, in {time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unet = sd.load_unet(hub.download(url), "sd_2", device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n = hold_loaded("sd_2 UNet", unet, ckpt)
    log(f"sd_2 UNet read in {seconds:.3f} s ({size / seconds / 1e9:.3f} GB/s of the file), {n:,} bf16 parameters on "
        f"the card equal to the source's")
    del source, ckpt
    torch.cuda.empty_cache()

    denoiser = CFGDenoiser(sd.StableDenoiser(unet, prediction=entry.config["prediction"]), batched=True)
    hidden = sd.ARCHS["sd2"]["unet"]["cross_attention_dim"]
    x = torch.randn((LOAD_SD2_ROWS, SD2_SIDE, SD2_SIDE, 4), generator=generator, device="cuda")
    cond = {
        "positive": {"prompt_embeds": torch.randn((LOAD_SD2_ROWS, 77, hidden), generator=generator, device="cuda")},
        "negative": {"prompt_embeds": torch.randn((1, 77, hidden), generator=generator, device="cuda")},
        "guidance": SD2_GUIDANCE,
    }
    run = one_call("the loaded sd_2 UNet", denoiser, x, torch.tensor(0.5, device="cuda"), cond, SD2_CALLS_PER_FORWARD)
    calls, affine = run["calls"]
    if dict(by_length(calls)) != SD2_ATTENTION_BY_L:
        raise AssertionError(f"the loaded sd_2 UNet's attention calls by L are not {SD2_ATTENTION_BY_L}")

    del unet, denoiser, x, cond
    torch.cuda.empty_cache()
    check_recorded("the loaded sd_2 UNet, one call under batched CFG (batch 8)", fit_attention(calls), affine, seed=490)
    return {"launches": run["launches"], "seconds": seconds, "gb_s": size / seconds / 1e9, "ms": run["ms"]}


def checkpoint_loading(generator) -> dict:
    r"""Phase 49: both loads in a temporary hub directory, which is deleted
    afterwards; no download may reach the network."""

    reached = []

    def offline(url, *args, **kwargs):
        reached.append(url)
        raise AssertionError(f"phase 49 reached the network: {url}")

    previous, real_urlopen = hub._HUB_DIR, urllib.request.urlopen
    urllib.request.urlopen = offline
    try:
        with tempfile.TemporaryDirectory(prefix="azula-hub-") as directory:
            hub.set_hub_dir(directory)
            adm256 = load_adm256(generator)
            sd2 = load_sd2_unet(generator)
    finally:
        hub._HUB_DIR = previous
        urllib.request.urlopen = real_urlopen

    if reached:
        raise AssertionError(f"phase 49 reached the network: {reached}")
    log("no download reached the network")
    return {"adm256": adm256, "sd2_unet": sd2}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=64, help="DDIM steps of the full-width ADM run")
    args = parser.parse_args()
    t_start = time.perf_counter()

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
    msa_ptxas, conv_ptxas, norm_ptxas = redesign_ptxas_summaries()
    log(f"ptxas -v of the bf16 tensor-core fused MSA: {msa_ptxas}")
    log(f"ptxas -v of the bf16 tensor-core conv3x3: {conv_ptxas}")
    log(f"ptxas -v of the GroupNorm and statistics cluster kernels: {norm_ptxas}")
    flash_forward, flash_backward = flash_ptxas_summaries()
    log(f"ptxas -v of the bf16 tensor-core flash_blhd forward: {flash_forward}")
    log(f"ptxas -v of the bf16 tensor-core flash_blhd backward: {flash_backward}")
    if not all((forward, backward, msa_ptxas, conv_ptxas, norm_ptxas, flash_forward, flash_backward)):
        raise AssertionError("ptxas reported no tensor-core attention, fused MSA, conv3x3, flash_blhd or GroupNorm kernel")

    log("== 3. kernels against their plain versions at the main path's shapes")
    generator = torch.Generator(device="cuda").manual_seed(0)
    denoiser = full_width_model(generator)
    sampler = DDIMSampler(denoiser, eta=0.0, steps=args.steps)
    x = sampler.init((BATCH, 256, 256, 3), generator=generator)

    with torch.inference_mode(), recording() as (calls, affine):
        denoiser(x, sampler.timesteps[0].cuda())
    recorded = launch_counts(calls)
    log(f"calls in one full-width forward: {recorded}")
    if recorded != CALLS_PER_FORWARD:
        raise AssertionError(f"expected {CALLS_PER_FORWARD} calls per forward")

    with torch.inference_mode():
        gn = check_group_norm(calls, affine, generator)
        wide_gn = check_wide_groups()
        at = new_entry()
        check_attention(calls, generator, at, ATTENTION_EXTRA)

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
    recorded = launch_counts(calls)
    log(f"calls in one full-width dit32 forward: {recorded}; {list(calls)}")
    if recorded != DIT_CALLS_PER_FORWARD:
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
    # phase 36 reuses the transformer (two copies do not fit on the card
    # beside T5-XXL); it waits in host memory, so that phases 16-34 measure
    # the peaks of their own paths
    del flux_sampler, xf, yf, cond
    t0 = time.perf_counter()
    flux.to("cpu")
    torch.cuda.empty_cache()
    log(f"FLUX.1-dev's transformer moved to host memory for phase 36 in {time.perf_counter() - t0:.1f} s")

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

    log("== 28. the eleven samplers: CPU plain versions against the card's kernels, float32")
    check_sampler_slices()

    log("== 29. the tiny CFG slice: CPU plain versions against the card's kernels, float32")
    check_cfg_slice()

    log(f"== 30. adm256_cfg at full width: {CFG_CARD}, bf16, batch {BATCH}, DDIM-{args.steps}, "
        f"guidance {CFG_GUIDANCE}, two-call then batched")
    cfg = cfg_full_width(generator, args.steps)

    log("== 31. the guidance slices: CPU plain versions against the card's kernels, float32")
    check_guidance_slices()

    log(f"== 32. mmps32 at full width: unet32 (norm='layer'), bf16, batch {MMPS_BATCH}, DDIM-{MMPS_STEPS}, "
        f"MMPS gmres-1")
    mmps32 = mmps32_full_width(generator)

    log(f"== 33. ADM-256 under the guidance VJP: MMPS gmres-1, imagenet_256x256, bf16, batch {BATCH}, "
        f"DDIM-{GUIDED_STEPS}")
    guided = guided_adm(generator)

    log("== 34. ADM's six cards at full width: one bf16 forward at batch 1 each")
    check_cards(generator)
    log(f"new paths: adm256_cfg two-call {cfg[False]['images_s']:.4f} images/s, batched {cfg[True]['images_s']:.4f}; "
        f"mmps32 {mmps32['images_s']:.4f} images/s; guided ADM-256 peak {guided['peak_gib']:.2f} GiB")

    log("== 35. the text-to-image slices: CPU plain versions against the card's kernels, float32")
    check_t2i_slices()

    log(f"== 36. FLUX.1-dev from a prompt to pixels at full width: T5-XXL, CLIP-L, phase 15's transformer, "
        f"DDIM-{FLUX_STEPS}, the VAE, bf16, {FLUX_SIDE * 16} px")
    t0 = time.perf_counter()
    flux.to("cuda")
    log(f"phase 15's transformer back on the card in {time.perf_counter() - t0:.1f} s")
    t2i = flux_text_to_image(flux, generator)
    del flux
    torch.cuda.empty_cache()

    log(f"== 37. sana1k at full width: Sana 1.6B and Gemma-2-2B in bf16, batch {SANA_BATCH}, DDIM-{SANA_STEPS}, "
        f"DC-AE in float32")
    sana1k = sana_full_width(generator)
    log(f"new paths: FLUX.1-dev prompt to pixels {t2i['ms']:.1f} ms; {SANA_METRIC} {sana1k['images_s']:.4f} images/s")

    log("== 38. the SD, EDM and EDM2 slices: CPU plain versions against the card's kernels, float32")
    check_family_slices()

    log(f"== 39. sd2_768 from prompts to pixels: SD 2 (768-v), CLIP-H, the VAE, bf16, {len(SD2_PROMPTS)} prompts, "
        f"batched CFG {SD2_GUIDANCE}, DDIM-{SD2_STEPS} (cut from 50)")
    sd2 = sd2_text_to_image(generator)

    log(f"== 40. sd1_512: the sd_1.5 UNet, bf16, one batched CFG call at batch {SD1_BATCH}")
    sd1 = sd1_call(generator)

    log(f"== 41. edm64: imagenet_64x64_cond, bf16, batch {EDM64_BATCH}, Heun-{EDM64_STEPS}")
    edm64 = edm64_full_width(generator)

    log(f"== 42. edm2_xxl: imagenet_512x512_xxl, bf16, batch {EDM2_BATCH}, Heun-{EDM2_STEPS}, the VAE decode")
    edm2 = edm2_full_width(generator)
    log(f"new paths: sd2_768 {sd2['images_s']:.4f} images/s (trajectory); sd1_512 {sd1['ms']:.2f} ms a call; edm64 "
        f"{edm64['images_s']:.4f} images/s, {edm64['ms_per_call']:.2f} ms per network call; edm2_xxl "
        f"{edm2['images_s']:.4f} images/s, {edm2['ms_per_call']:.2f} ms per network call")

    log("== 43. the v-diffusion, CC12M-1 and JiT slices: CPU plain versions against the card's kernels, float32")
    t43 = time.perf_counter()
    check_vdm_jit_slices()

    log(f"== 44. cc12m_cfg256: CC12M-1, bf16, {CC12M_BATCH} CLIP embeddings against the zero one, batched CFG "
        f"{CC12M_GUIDANCE}, DDIM-{CC12M_STEPS}, 256 px")
    cc12m = cc12m_full_width(generator)

    log(f"== 45. vdm_yfcc512L and vdm_in128: {YFCC_CARD} at batch {YFCC_BATCH} (512 px), {IN128_CARD} at batch "
        f"{IN128_BATCH} (128 px), bf16, one call each")
    vdm_cards = vdm_cards_full_width(generator)

    log(f"== 46. jit_l16_cfg: {JIT_L_CARD} (JiT-L/16), bf16, labels arange({JIT_BATCH}) against the null label, "
        f"batched CFG {JIT_GUIDANCE}, Heun-{JIT_STEPS}, 256 px")
    jit_l = jit_full_width(generator)

    log(f"== 47. jit_h16: {JIT_H_CARD} (JiT-H/16), bf16, one batched CFG call at batch {JIT_BATCH}")
    jit_h = jit_h_call(generator)
    log("== 48. the v-diffusion and JiT paths")
    log(f"new paths: cc12m_cfg256 {cc12m['images_s']:.4f} images/s, {cc12m['ms_step']:.2f} ms a step; "
        f"vdm_yfcc512L {vdm_cards[YFCC_CARD]['ms']:.2f} ms a call; vdm_in128 {vdm_cards[IN128_CARD]['ms']:.2f} ms a "
        f"call; jit_l16_cfg {jit_l['images_s']:.4f} images/s, {jit_l['ms_step']:.2f} ms a step; jit_h16 "
        f"{jit_h['ms']:.2f} ms a call; phases 43-47 took {time.perf_counter() - t43:.1f} s")

    log("== 49. checkpoint loading: ADM-256 from a full-width .pt, the sd_2 UNet from its fp16 safetensors, "
        "through the hub, bf16 on the card")
    t49 = time.perf_counter()
    loaded = checkpoint_loading(generator)
    log(f"new paths: imagenet_256x256 loaded at {loaded['adm256']['gb_s']:.3f} GB/s (peak "
        f"{loaded['adm256']['peak_mib']:.1f} MiB), the sd_2 UNet read at {loaded['sd2_unet']['gb_s']:.3f} GB/s; "
        f"{smi.stdout.strip().splitlines()[0]}; phase 49 took {time.perf_counter() - t49:.1f} s")

    log("== 50. result")
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
            # the same calls' kernel time on the device (the profiler):
            # without the host's gaps that CUDA events count around short calls
            "device_ms": entry.get("device_ms") if not math.isnan(entry.get("device_ms") or math.nan) else None,
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

    # the launches of the text-to-image path (phase 36), of the SD, EDM and
    # EDM2 paths (phases 39-42), of the v-diffusion and JiT paths (phases
    # 44-47) and of the loaded models (phase 49) beside each kernel's own
    # main path's; the FLUX.1-dev VAE
    # decode's GroupNorm calls timed as phase 3 times ADM's; the wide groups
    # of phases 3 and 23 (one call each) and the GroupNorm calls of one
    # cc12m_cfg256 and one vdm_yfcc512L call (each at its count)
    paths = {
        "flux_text_to_image": t2i, "sd2_768": sd2, "sd1_512": sd1, "edm64": edm64, "edm2_xxl": edm2,
        "cc12m_cfg256": cc12m, "vdm_yfcc512L": vdm_cards[YFCC_CARD], "vdm_in128": vdm_cards[IN128_CARD],
        "jit_l16_cfg": jit_l, "jit_h16": jit_h,
        "load_adm256": loaded["adm256"], "load_sd2_unet": loaded["sd2_unet"],
    }
    for entry in kernels:
        extra = {path: run["launches"][entry["name"]] for path, run in paths.items() if run["launches"].get(entry["name"])}
        if extra:
            entry["launches_by_path"] = {"main": entry["launches"], **extra}
            entry["launches"] += sum(extra.values())
        if entry["name"] == "group_norm":
            for key, calls, timed in (
                ("flux_vae_decode", FLUX_VAE_CALLS["group_norm"], t2i["group_norm"]),
                ("wide_groups", len(WIDE_GN_SHAPES), wide_gn),
                ("cc12m_cfg256_call", CC12M_CALLS_PER_FORWARD["group_norm"], cc12m["group_norm"]),
                ("vdm_yfcc512L_call", YFCC_CALLS_PER_FORWARD["group_norm"], vdm_cards[YFCC_CARD]["group_norm"]),
            ):
                entry[key] = timings(calls, timed)
        if entry["name"] == "group_stats":
            entry["wide_groups"] = timings(len(WIDE_GN_SHAPES), stats["wide"])

    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels launched no time on their main path: {idle}")

    log(f"all phases took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
