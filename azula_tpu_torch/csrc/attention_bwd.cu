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
// arithmetic is the JAX kernels', with their rounding points
// (azula::flash_bwd in common.cuh): s = (q k^T) scale + bias, p =
// exp(s - lse) and delta = sum of g o from the stored o in float32,
// ds = T(p (M dp / (1 - r) - delta) scale), dq = T(ds) k, dk = T(ds)^T q
// and dv = T(M p / (1 - r))^T g, each summed in float32, where the keep
// mask M of dropout rate r is regenerated per tile from the forward's
// coordinate hash (M = 1 without dropout). The batched TPU kernel recomputes
// the softmax when its forward wrote no LSE (lse=None, L <= 512); the port's
// forward writes the LSE at every L whenever autograd records the call, so
// these kernels take every length, as JAX's do under a bias or dropout.
//
// Bound on the H100: a pair reads 5 L D elements and L floats and writes
// 3 L D elements, and does 10 L^2 D operations (the JAX cost estimates,
// dq 4 and dk, dv 6), 5 L / 8 operations per byte in bf16; at dit64's
// L = 1024 that is 640, above the ~295 of the bf16 tensor cores, so even the
// ideal kernel is bound by operations (0.521 ms per call at B = 128, H = 6,
// D = 64). These kernels run their products on the float32 CUDA cores (67
// TFLOP/s) and recompute the scores and dp in both kernels (14 L^2 D
// operations), so they are bound by operations, far above that.
//
// Design: the TPU kernels ran a sequential (pair, query block, key block)
// grid with 512-row blocks and carried dq, or dk and dv, in VMEM scratch
// across the last axis. Blocks on the H100 run in no order and hold at most
// 227 KB of shared memory, so the sequential axis becomes a loop inside a
// block over 64-row tiles: the FlashAttention-2 split of azula::flash_bwd
// (shared with flash_blhd_bwd.cu, whose (B, L, H D) layout is the general
// case; here H = 1 and the pairs are the batch), a dq kernel per (pair,
// query tile) that also writes delta to a float32 scratch, then a dk, dv
// kernel per (pair, key tile). No atomics. At D = 128 a block takes 170,752
// bytes of shared memory (one block per SM), at D = 64 105,216 (two); at
// D = 192 and 256 query tiles have 32 rows (217,472 bytes at 256). The
// bias, (Gm, L, L) in the inputs' dtype, has no room in shared memory at
// D = 256: each score reads its bias from device memory, and the keep mask
// is computed in registers from (row, column, pair) by the hash the forward
// uses (azula::PairMask). Blocks form a one-dimensional grid, (pair, tile)
// with the tiles of a pair together, so any number of pairs fits. Tensor
// cores (wgmma) and TMA are later work.
#include "common.cuh"

namespace {

namespace flash_bwd = azula::flash_bwd;

// `l` is unused: the statistics are the log-sum-exp alone
template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(flash_bwd::kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ o, const T* __restrict__ g, const float* __restrict__ lse,
                        const float* __restrict__ l, T* __restrict__ dq, float* __restrict__ delta, int L, int H,
                        float scale, azula::MaskArgs mask) {
  flash_bwd::dq_block<T, D, true, kDropout>(q, k, v, o, g, lse, l, dq, delta, L, H, scale, mask);
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(flash_bwd::kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ l,
                         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int L, int H,
                         float scale, azula::MaskArgs mask) {
  flash_bwd::dkv_block<T, D, true, kDropout>(q, k, v, g, lse, l, delta, dk, dv, L, H, scale, mask);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, int BH, int L, float scale,
                   const azula::MaskArgs& mask, cudaStream_t s) {
  // (B H, L, D) is the (B, L, H D) layout with one head per batch row
  if (mask.seed != nullptr) {
    return flash_bwd::launch<T, D>(attention_bwd_dq_kernel<T, D, true>, attention_bwd_dkv_kernel<T, D, true>, q, k,
                                   v, o, g, lse, nullptr, dq, dk, dv, delta, BH, L, 1, scale, s, mask);
  }
  return flash_bwd::launch<T, D>(attention_bwd_dq_kernel<T, D, false>, attention_bwd_dkv_kernel<T, D, false>, q, k, v,
                                 o, g, lse, nullptr, dq, dk, dv, delta, BH, L, 1, scale, s, mask);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                     void* dq, void* dk, void* dv, float* delta, int BH, int L, int D, float scale,
                     const azula::MaskArgs& mask, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, mask, s);
    case 64: return launch<T, 64>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, mask, s);
    case 128: return launch<T, 128>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, mask, s);
    case 192: return launch<T, 192>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, mask, s);
    case 256: return launch<T, 256>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, mask, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, g, dq, dk, dv: (BH, L, D) contiguous; lse: float32 (BH, L)
// from azula_attention_fwd_lse; delta: float32 (BH, L) scratch; dtype 0 =
// float32, 1 = bfloat16; D in {32, 64, 128, 192, 256}. bias: null or
// (Gm, L, L) in the dtype, pair p reading group (p / bias_div) % bias_mod;
// seed: null (no dropout) or two int32 words, keeping where the hash is at
// least `threshold` and scaling by 1 / retain, as the forward did. Launches
// two kernels on `stream`. Returns cudaGetLastError().
extern "C" int azula_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
                                   const void* lse, void* dq, void* dk, void* dv, void* delta, int BH, int L, int D,
                                   float scale, int dtype, void* stream, const void* bias, int bias_div, int bias_mod,
                                   const void* seed, int threshold, float retain) {
  if (BH <= 0 || L <= 0 || bias_div <= 0 || bias_mod <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  const azula::MaskArgs mask = azula::mask_args(bias, bias_div, bias_mod, seed, threshold, retain);
  if (dtype == azula::kBFloat16) {
    return dispatch<__nv_bfloat16>(q, k, v, o, g, lf, dq, dk, dv, df, BH, L, D, scale, mask, s);
  }
  if (dtype == azula::kFloat32) return dispatch<float>(q, k, v, o, g, lf, dq, dk, dv, df, BH, L, D, scale, mask, s);
  return cudaErrorInvalidValue;
}
