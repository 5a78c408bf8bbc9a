// Flash-attention backward on (B, H, L, D): dq, dk, dv of
// o = softmax(q k^T * scale) v per (batch, head) pair, given the cotangent g
// of o and the float32 log-sum-exp of each query row.
//
// Replaces: azula_tpu/ops/attention.py:1102 (_pallas_attention_bwd: dq_kernel
// at :1200 and dkv_kernel at :1275, which rebuild p = exp(s - lse) in _p_ds at
// :1159), with its bias and dropout, and azula_tpu/ops/attention.py:966
// (_pallas_attention_batched_bwd), the same function for L <= 512. q, k, v,
// o, g, dq, dk and dv are (B H, L, D); lse is the float32 (B H, L) row
// log-sum-exp m + log l that attention_fwd.cu's LSE entry wrote (the TPU
// kernels read it lane-replicated, (B H, L, 128)). Inputs and outputs are
// bf16 or float32; D is 32, 64, 128, 192 or 256; any L is taken. The
// arithmetic is the JAX kernels', with their rounding points:
// s = (q k^T) scale + bias, p = exp(s - lse) and delta = sum of g o from the
// stored o in float32, ds = T(p (M dp / (1 - r) - delta) scale),
// dq = T(ds) k, dk = T(ds)^T q and dv = T(M p / (1 - r))^T g, each summed in
// float32 and rounded once, where the keep mask M of dropout rate r is
// regenerated per tile from the forward's coordinate hash (M = 1 without
// dropout). The batched TPU kernel recomputes the softmax when its forward
// wrote no LSE (lse=None, L <= 512); the port's forward writes the LSE at
// every L whenever autograd records the call, so these kernels take every
// length, as JAX's do under a bias or dropout.
//
// Bound on the H100: a pair reads 5 L D elements and L floats and writes
// 3 L D elements, and does 10 L^2 D operations (the JAX cost estimates,
// dq 4 and dk, dv 6), 5 L / 8 operations per byte in bf16; at dit64's
// L = 1024 that is 640, above the ~295 of the bf16 tensor cores, so the
// ideal kernel is bound by operations (0.521 ms per call at B = 128, H = 6,
// D = 64). The bf16 kernel does those 10 L^2 D operations once, on the tensor
// cores; it also moves a float32 dq accumulator (zeroed, L D / 64 reduced
// per key tile, read once: at L = 1024, D = 64 about 1.6 GB of reductions
// per call, most of them in L2).
//
// Design, bf16 (every form): FlashAttention-3's one-pass backward on
// Hopper, without its producer warpgroup. A block owns one key tile of one
// pair, 128 keys at D <= 128 (two warpgroups of 64 keys each) and 64 at
// D >= 192 (two warpgroups on the same keys, each with part of dK's and dV's
// columns: 128 + 64 at D = 192, 128 + 128 at 256; a (64, D) pair of
// accumulators would need D registers a thread). Eight warps and no ninth:
// a warpgroup holds ~200 registers a thread, and a producer's warps would
// cap every thread at 168 (setmaxnreg does not lift ptxas's allocation past
// that: with a producer warpgroup ptxas spills 1-2 KB a thread at
// D >= 128). Thread 0 loads K and V once by TMA, then each 64-query tile's
// Q and G (64-column panels in the 128-byte swizzle; 32-column panels in
// the 64-byte swizzle at D <= 64) and its rows' LSE and delta (a 1-D bulk
// copy) into a two-stage ring on mbarriers, reloading a stage as soon as
// both warpgroups have released it, a tile ahead of its use. Per query
// tile each warpgroup computes S^T = K Q^T and dP^T = V G^T by wgmma (float32
// accumulators, keys as rows), rebuilds p, the dropped p~ and ds in
// registers at (key, query) coordinates (the bias read per score from
// device memory, the keep mask hashed per score), and with P~^T and dS^T,
// rounded pairwise to bf16, as the register A operand accumulates
// dV += P~^T G and dK += dS^T Q. dS^T also goes to a shared tile (bf16, keys
// as rows, the 128-byte swizzle), one per stage, behind a proxy fence and a
// named barrier of the two warpgroups; each then computes its half
// of dQ's columns, dQ_tile = dS K with both operands MN-major in shared
// memory, and adds it to a float32 (B H, L, D) accumulator by vector float32
// atomics (rows past L are not written). One pass builds the scores and the
// dropout hash once, where the FlashAttention-2 split builds them twice (14
// L^2 D operations); the price is that dq's float32 sums run in an order
// that changes from run to run. A pre-kernel computes delta = rowsum(g o) in
// float32, copies it and the LSE into per-tile rows (zero past L) and zeroes
// the accumulator; a post-kernel rounds it to dq. Stream order keeps the
// three apart; no device-wide barrier. Blocks form a one-dimensional grid,
// (pair, key tile) with the tiles of a pair together. The three kernels are
// in attention_bwd_tc.cuh, templated on where a pair's rows lie, which
// flash_blhd_bwd.cu shares; this file gives them pairs of (B H, L, D).
//
// Design, float32: the CUDA-core FlashAttention-2 split of azula::flash_bwd
// in common.cuh (shared with flash_blhd_bwd.cu), unchanged: a dq kernel per
// (pair, query tile) that also writes delta, then a dk, dv kernel per (pair,
// key tile); tiles in shared memory as float32, products by plain FMA (TF32
// would break the float32 gates), no atomics.
#include "attention_bwd_tc.cuh"
#include "common.cuh"

namespace {

namespace flash_bwd = azula::flash_bwd;

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(flash_bwd::kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ o, const T* __restrict__ g, const float* __restrict__ lse,
                        T* __restrict__ dq, float* __restrict__ delta, int L, int H, float scale,
                        azula::MaskArgs mask) {
  flash_bwd::dq_block<T, D, kDropout>(q, k, v, o, g, lse, dq, delta, L, H, scale, mask);
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(flash_bwd::kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int L, int H, float scale, azula::MaskArgs mask) {
  flash_bwd::dkv_block<T, D, kDropout>(q, k, v, g, lse, delta, dk, dv, L, H, scale, mask);
}

template <int D>
cudaError_t launch_float(const void* q, const void* k, const void* v, const void* o, const void* g,
                         const float* lse, void* dq, void* dk, void* dv, float* delta, int BH, int L, float scale,
                         const azula::MaskArgs& mask, cudaStream_t s) {
  // (B H, L, D) is the (B, L, H D) layout with one head per batch row
  using T = float;
  if (mask.seed != nullptr) {
    return flash_bwd::launch<T, D>(attention_bwd_dq_kernel<T, D, true>, attention_bwd_dkv_kernel<T, D, true>, q, k,
                                   v, o, g, lse, dq, dk, dv, delta, BH, L, 1, scale, s, mask);
  }
  return flash_bwd::launch<T, D>(attention_bwd_dq_kernel<T, D, false>, attention_bwd_dkv_kernel<T, D, false>, q, k, v,
                                 o, g, lse, dq, dk, dv, delta, BH, L, 1, scale, s, mask);
}

// The bf16 backward on the tensor cores (attention_bwd_tc.cuh), on pairs
// of (B H, L, D).
namespace tc {

using namespace azula::attention_bwd_tc;

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                     void* dq, void* dk, void* dv, float* rows, float* dq_acc, int BH, int L, float scale,
                     const azula::MaskArgs& mask, cudaStream_t s) {
  const PairLayout<D> pairs{L};
  const bool bias = mask.bias != nullptr;
  const bool dropout = mask.seed != nullptr;
  if (bias && dropout) {
    return launch<D, true, true>(pairs, q, k, v, o, g, lse, dq, dk, dv, rows, dq_acc, BH, scale, mask, s);
  }
  if (bias) return launch<D, true, false>(pairs, q, k, v, o, g, lse, dq, dk, dv, rows, dq_acc, BH, scale, mask, s);
  if (dropout) return launch<D, false, true>(pairs, q, k, v, o, g, lse, dq, dk, dv, rows, dq_acc, BH, scale, mask, s);
  return launch<D, false, false>(pairs, q, k, v, o, g, lse, dq, dk, dv, rows, dq_acc, BH, scale, mask, s);
}

}  // namespace tc

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                     void* dq, void* dk, void* dv, float* delta, float* dq_acc, int BH, int L, int D, float scale,
                     bool is_bf16, const azula::MaskArgs& mask, cudaStream_t s) {
  if (is_bf16 && dq_acc == nullptr) return cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return is_bf16 ? tc::dispatch<32>(q, k, v, o, g, lse, dq, dk, dv, delta, dq_acc, BH, L, scale, mask, s)
                     : launch_float<32>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, mask, s);
    case 64:
      return is_bf16 ? tc::dispatch<64>(q, k, v, o, g, lse, dq, dk, dv, delta, dq_acc, BH, L, scale, mask, s)
                     : launch_float<64>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, mask, s);
    case 128:
      return is_bf16 ? tc::dispatch<128>(q, k, v, o, g, lse, dq, dk, dv, delta, dq_acc, BH, L, scale, mask, s)
                     : launch_float<128>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, mask, s);
    case 192:
      return is_bf16 ? tc::dispatch<192>(q, k, v, o, g, lse, dq, dk, dv, delta, dq_acc, BH, L, scale, mask, s)
                     : launch_float<192>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, mask, s);
    case 256:
      return is_bf16 ? tc::dispatch<256>(q, k, v, o, g, lse, dq, dk, dv, delta, dq_acc, BH, L, scale, mask, s)
                     : launch_float<256>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, mask, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, g, dq, dk, dv: (BH, L, D) contiguous; lse: float32 (BH, L)
// from azula_attention_fwd_lse; dtype 0 = float32, 1 = bfloat16; D in
// {32, 64, 128, 192, 256}. Scratch: delta, float32, BH 2 ceil(L / 64) 64
// floats (the float32 kernels use its first BH L); dq_acc, float32, BH L D
// (bf16 only; null for float32). bias: null or (Gm, L, L) in the dtype, pair
// p reading group (p / bias_div) % bias_mod; seed: null (no dropout) or two
// int32 words, keeping where the hash is at least `threshold` and scaling by
// 1 / retain, as the forward did. Launches three kernels on `stream` in
// bf16, two in float32. Returns cudaGetLastError().
extern "C" int azula_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
                                   const void* lse, void* dq, void* dk, void* dv, void* delta, void* dq_acc, int BH,
                                   int L, int D, float scale, int dtype, void* stream, const void* bias, int bias_div,
                                   int bias_mod, const void* seed, int threshold, float retain) {
  if (BH <= 0 || L <= 0 || bias_div <= 0 || bias_mod <= 0) return cudaErrorInvalidValue;
  if (dtype != azula::kBFloat16 && dtype != azula::kFloat32) return cudaErrorInvalidValue;
  return dispatch(q, k, v, o, g, static_cast<const float*>(lse), dq, dk, dv, static_cast<float*>(delta),
                  static_cast<float*>(dq_acc), BH, L, D, scale, dtype == azula::kBFloat16,
                  azula::mask_args(bias, bias_div, bias_mod, seed, threshold, retain), static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of a block of the bf16 tensor-core backward at
// head dim D (0 if there is no such block).
extern "C" int azula_attention_bwd_tc_shared_bytes(int D) {
  switch (D) {
    case 32: return tc::Layout<32>::kBytes;
    case 64: return tc::Layout<64>::kBytes;
    case 128: return tc::Layout<128>::kBytes;
    case 192: return tc::Layout<192>::kBytes;
    case 256: return tc::Layout<256>::kBytes;
    default: return 0;
  }
}
