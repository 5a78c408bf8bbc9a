// Flash-attention backward on the projection layout: dq, dk, dv of
// o = softmax(q k^T * scale) v per head, given the cotangent g of o.
//
// Replaces: azula_tpu/ops/attention.py:836 (_flash_blhd_bwd, whose Pallas body
// is _flash_blhd_bwd_kernel at :748). q, k, v, o, g, dq, dk and dv are
// (B, L, C) with C = H D and head h at columns h D; m and l are the float32
// (B, H, L) row max and denominator that flash_blhd_fwd.cu wrote. Inputs and
// outputs are bf16 or float32; D is 64, 128, 192 or 256; any L is taken. The
// arithmetic is the JAX body's, with its rounding points, p = exp(s - m) / l
// (azula::flash_bwd in common.cuh). The JAX body rebuilds m and l from the
// scores; here they come from the forward, whose online softmax summed the
// same exp-weights in another order.
//
// Bound on the H100: a (b, h) pair reads 5 L D and writes 3 L D elements and
// does 10 L^2 D operations (the JAX cost estimate), 5 L / 8 operations per
// byte in bf16; at dit32's L = 256 that is 160, below the ~295 of the bf16
// tensor cores, so the ideal kernel is bound by bytes (0.060 ms per call at
// B = 128, H = 6, D = 64). These kernels run their products on the float32
// CUDA cores and recompute the scores and dp twice (14 L^2 D operations), so
// they are bound by operations.
//
// Design: the TPU body held a whole (L, L) float32 tile per head in VMEM; at
// L = 256 that is 256 KB, more than the 227 KB of shared memory a block may
// use. The work is split in two kernels instead (the FlashAttention-2 split
// of azula::flash_bwd, shared with attention_bwd.cu): dq per query tile, then
// dk and dv per key tile, no atomics. The head's columns are read in place
// with the row stride C, so no head transpose goes through memory. Tensor
// cores, TMA and a single-pass dq by atomics are later work.
#include "common.cuh"

namespace {

namespace flash_bwd = azula::flash_bwd;

template <typename T, int D>
__global__ void __launch_bounds__(flash_bwd::kThreads)
flash_blhd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ o, const T* __restrict__ g, const float* __restrict__ m,
                     const float* __restrict__ l, T* __restrict__ dq, float* __restrict__ delta, int L, int H,
                     float scale, azula::MaskArgs mask) {
  flash_bwd::dq_block<T, D, false, false>(q, k, v, o, g, m, l, dq, delta, L, H, scale, mask);
}

template <typename T, int D>
__global__ void __launch_bounds__(flash_bwd::kThreads)
flash_blhd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int L, int H,
                      float scale, azula::MaskArgs mask) {
  flash_bwd::dkv_block<T, D, false, false>(q, k, v, g, m, l, delta, dk, dv, L, H, scale, mask);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* g, const float* m,
                   const float* l, void* dq, void* dk, void* dv, float* delta, int B, int L, int H, float scale,
                   cudaStream_t s) {
  return flash_bwd::launch<T, D>(flash_blhd_dq_kernel<T, D>, flash_blhd_dkv_kernel<T, D>, q, k, v, o, g, m, l, dq,
                                 dk, dv, delta, B, L, H, scale, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* g, const float* m,
                     const float* l, void* dq, void* dk, void* dv, float* delta, int B, int L, int H, int D,
                     float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, g, m, l, dq, dk, dv, delta, B, L, H, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, g, m, l, dq, dk, dv, delta, B, L, H, scale, s);
    case 192: return launch<T, 192>(q, k, v, o, g, m, l, dq, dk, dv, delta, B, L, H, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, g, m, l, dq, dk, dv, delta, B, L, H, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, g, dq, dk, dv: (B, L, H D) contiguous; m, l: float32 (B, H, L)
// from azula_flash_blhd_fwd; delta: float32 (B, H, L) scratch; dtype 0 =
// float32, 1 = bfloat16; D in {64, 128, 192, 256}; B * H <= 65535. Launches
// two kernels on `stream`. Returns cudaGetLastError().
extern "C" int azula_flash_blhd_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
                                    const void* m, const void* l, void* dq, void* dk, void* dv, void* delta, int B,
                                    int L, int H, int D, float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || B * H > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* df = static_cast<float*>(delta);
  if (dtype == azula::kBFloat16) {
    return dispatch<__nv_bfloat16>(q, k, v, o, g, mf, lf, dq, dk, dv, df, B, L, H, D, scale, s);
  }
  if (dtype == azula::kFloat32) return dispatch<float>(q, k, v, o, g, mf, lf, dq, dk, dv, df, B, L, H, D, scale, s);
  return cudaErrorInvalidValue;
}
