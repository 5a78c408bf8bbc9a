// Flash-attention backward on (B, H, L, D): dq, dk, dv of
// o = softmax(q k^T * scale) v per (batch, head) pair, given the cotangent g
// of o and the float32 log-sum-exp of each query row.
//
// Replaces: azula_tpu/ops/attention.py:1102 (_pallas_attention_bwd: dq_kernel
// at :1200 and dkv_kernel at :1275, which rebuild p = exp(s - lse) in _p_ds at
// :1159), without its bias and dropout, and azula_tpu/ops/attention.py:966
// (_pallas_attention_batched_bwd), the same function for L <= 512. q, k, v,
// o, g, dq, dk and dv are (B H, L, D); lse is the float32 (B H, L) row
// log-sum-exp m + log l that attention_fwd.cu's LSE entry wrote (the TPU
// kernels read it lane-replicated, (B H, L, 128)). Inputs and outputs are
// bf16 or float32; D is 32, 64 or 128; any L is taken. The arithmetic is the
// JAX kernels', with their rounding points (azula::flash_bwd in common.cuh):
// p = exp(s - lse) and delta = sum of g o from the stored o in float32,
// ds = T(p (dp - delta) scale), dq = T(ds) k, dk = T(ds)^T q and
// dv = T(p)^T g, each summed in float32. The batched TPU kernel recomputes
// the softmax when its forward wrote no LSE (lse=None, L <= 512); the port's
// forward writes the LSE at every L whenever autograd records the call, so
// these kernels take every length.
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
// bytes of shared memory (one block per SM), at D = 64 105,216 (two).
// Tensor cores (wgmma) and TMA are later work.
#include "common.cuh"

namespace {

namespace flash_bwd = azula::flash_bwd;

// `l` is unused: the statistics are the log-sum-exp alone
template <typename T, int D>
__global__ void __launch_bounds__(flash_bwd::kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ o, const T* __restrict__ g, const float* __restrict__ lse,
                        const float* __restrict__ l, T* __restrict__ dq, float* __restrict__ delta, int L, int H,
                        float scale) {
  flash_bwd::dq_block<T, D, true>(q, k, v, o, g, lse, l, dq, delta, L, H, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(flash_bwd::kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ l,
                         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int L, int H,
                         float scale) {
  flash_bwd::dkv_block<T, D, true>(q, k, v, g, lse, l, delta, dk, dv, L, H, scale);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, int BH, int L, float scale, cudaStream_t s) {
  // (B H, L, D) is the (B, L, H D) layout with one head per batch row
  return flash_bwd::launch<T, D>(attention_bwd_dq_kernel<T, D>, attention_bwd_dkv_kernel<T, D>, q, k, v, o, g, lse,
                                 nullptr, dq, dk, dv, delta, BH, L, 1, scale, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                     void* dq, void* dk, void* dv, float* delta, int BH, int L, int D, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, g, lse, dq, dk, dv, delta, BH, L, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, g, dq, dk, dv: (BH, L, D) contiguous; lse: float32 (BH, L)
// from azula_attention_fwd_lse; delta: float32 (BH, L) scratch; dtype 0 =
// float32, 1 = bfloat16; D in {32, 64, 128}; BH <= 65535. Launches two
// kernels on `stream`. Returns cudaGetLastError().
extern "C" int azula_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
                                   const void* lse, void* dq, void* dk, void* dv, void* delta, int BH, int L, int D,
                                   float scale, int dtype, void* stream) {
  if (BH <= 0 || L <= 0 || BH > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  if (dtype == azula::kBFloat16) return dispatch<__nv_bfloat16>(q, k, v, o, g, lf, dq, dk, dv, df, BH, L, D, scale, s);
  if (dtype == azula::kFloat32) return dispatch<float>(q, k, v, o, g, lf, dq, dk, dv, df, BH, L, D, scale, s);
  return cudaErrorInvalidValue;
}
