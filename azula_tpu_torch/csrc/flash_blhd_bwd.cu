// Flash-attention backward on the projection layout: dq, dk, dv of
// o = softmax(q k^T * scale) v per head, given the cotangent g of o.
//
// Replaces: azula_tpu/ops/attention.py:836 (_flash_blhd_bwd, whose Pallas body
// is _flash_blhd_bwd_kernel at :748). q, k, v, o, g, dq, dk and dv are
// (B, L, C) with C = H D and head h at columns h D; lse is the float32
// (B, H, L) row log-sum-exp m + log l that flash_blhd_fwd.cu wrote. Inputs
// and outputs are bf16 or float32; D is 64, 128, 192 or 256; any L is
// taken. The arithmetic is the JAX body's, with its rounding points, with
// p = exp(s - lse): the JAX body rebuilds the softmax from the scores; here
// its statistics come from the forward, whose online softmax summed the
// same exp-weights in another order.
//
// Bound on the H100: a (b, h) pair reads 5 L D and writes 3 L D elements and
// does 10 L^2 D operations (the JAX cost estimate), 5 L / 8 operations per
// byte in bf16; at dit32's L = 256 that is 160, below the ~295 of the bf16
// tensor cores, so the ideal kernel is bound by bytes (0.060 ms per call at
// B = 128, H = 6, D = 64).
//
// Design, bf16: the one-pass tensor-core backward of attention_bwd.cu
// (attention_bwd_tc.cuh, the plain form), with the heads read in place: its
// rows policy `HeadsLayout` maps q, k, v and g as (C, L, B) tensors, so that
// TMA loads head h's 64-column panels at columns h D + 64 p (32-column ones
// at D = 64) with the row stride C, and places dk, dv, the float32 dq
// accumulator (B, L, C) and the pre-kernel's reads of o and g at row stride
// C; no head transpose goes through memory. Three launches: delta and the
// zeroed accumulator, the kernel (a block per 128-key tile of a pair at
// D <= 128, 64 keys above; dq by float32 atomics, so its sums run in an
// order that changes from run to run), dq's rounding.
//
// Design, float32: the CUDA-core FlashAttention-2 split of azula::flash_bwd
// (common.cuh, shared with attention_bwd.cu's float32 form): dq per query
// tile, then dk and dv per key tile, no atomics, products by plain FMA
// (TF32 would break the float32 gates).
//
// Both forms take their blocks on a one-dimensional grid, so any number of
// (batch, head) pairs fits.
#include "attention_bwd_tc.cuh"
#include "common.cuh"

namespace {

namespace flash_bwd = azula::flash_bwd;

template <int D>
__global__ void __launch_bounds__(flash_bwd::kThreads)
flash_blhd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ o, const float* __restrict__ g, const float* __restrict__ lse,
                     float* __restrict__ dq, float* __restrict__ delta, int L, int H, float scale,
                     azula::MaskArgs mask) {
  flash_bwd::dq_block<float, D, false>(q, k, v, o, g, lse, dq, delta, L, H, scale, mask);
}

template <int D>
__global__ void __launch_bounds__(flash_bwd::kThreads)
flash_blhd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int L, int H, float scale,
                      azula::MaskArgs mask) {
  flash_bwd::dkv_block<float, D, false>(q, k, v, g, lse, delta, dk, dv, L, H, scale, mask);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, float* dq_acc, int B, int L, int H, float scale,
                   bool is_bf16, cudaStream_t s) {
  if (is_bf16) {
    const azula::hopper::HeadsLayout<D> heads{L, H};
    return azula::attention_bwd_tc::launch<D, false, false>(heads, q, k, v, o, g, lse, dq, dk, dv, delta, dq_acc,
                                                            B * H, scale, azula::MaskArgs(), s);
  }
  return flash_bwd::launch<float, D>(flash_blhd_dq_kernel<D>, flash_blhd_dkv_kernel<D>, q, k, v, o, g, lse, dq, dk,
                                     dv, delta, B, L, H, scale, s);
}

}  // namespace

// q, k, v, o, g, dq, dk, dv: (B, L, H D) contiguous, 16-byte aligned; lse:
// float32 (B, H, L) from azula_flash_blhd_fwd; dtype 0 = float32, 1 =
// bfloat16; D in {64, 128, 192, 256}. Scratch: delta, float32, B H 2
// ceil(L / 64) 64 floats (the float32 kernels use its first B H L);
// dq_acc, float32, B L H D (bf16 only; null for float32). Launches three
// kernels on `stream` in bf16, two in float32. Returns cudaGetLastError().
extern "C" int azula_flash_blhd_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
                                    const void* lse, void* dq, void* dk, void* dv, void* delta, void* dq_acc, int B,
                                    int L, int H, int D, float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (dtype != azula::kBFloat16 && dtype != azula::kFloat32) return cudaErrorInvalidValue;
  const bool is_bf16 = dtype == azula::kBFloat16;
  if (is_bf16 && dq_acc == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  switch (D) {
    case 64: return launch<64>(q, k, v, o, g, l, dq, dk, dv, d, acc, B, L, H, scale, is_bf16, s);
    case 128: return launch<128>(q, k, v, o, g, l, dq, dk, dv, d, acc, B, L, H, scale, is_bf16, s);
    case 192: return launch<192>(q, k, v, o, g, l, dq, dk, dv, d, acc, B, L, H, scale, is_bf16, s);
    case 256: return launch<256>(q, k, v, o, g, l, dq, dk, dv, d, acc, B, L, H, scale, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}
