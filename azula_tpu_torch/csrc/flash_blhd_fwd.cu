// Flash-attention forward on the projection layout:
// o[b, :, h] = softmax(q[b, :, h] k[b, :, h]^T * scale) v[b, :, h] per head.
//
// Replaces: azula_tpu/ops/attention.py:798 (_flash_blhd, whose Pallas body is
// _flash_blhd_fwd_kernel at :717). q, k, v and o are (B, L, C) with C = H D
// and head h at columns h D, the layout the fused QKV projection produces,
// so no head transpose goes through memory. Inputs and output are bf16 or
// float32; D is 64, 128, 192 or 256; any L is taken (the ragged last tile is
// masked). As in the JAX body, the division by the denominator comes after
// the value product in both dtypes, and in bf16 the exp-weights are rounded
// to bf16 before it. Besides o, the kernel writes each row's float32 max and
// denominator, (B, H, L) each, as the residual of the backward
// (flash_blhd_bwd.cu); the JAX kernel recomputes them there instead.
//
// Bound on the H100: a (b, h) pair reads 3 L D and writes L D elements and
// does 4 L^2 D operations, L / 2 operations per byte in bf16. At dit32's
// L = 256 that is 128, below the ~295 where the bf16 tensor cores would
// limit, so the ideal kernel is bound by bytes (0.030 ms per call at B = 128,
// H = 6, D = 64). This kernel runs its products on the float32 CUDA cores
// (67 TFLOP/s, ~20 operations per byte), so it is bound by operations.
//
// Design: the TPU kernel held G batch rows' whole (L, C) slabs in VMEM and
// looped over heads inside one program. Here one block of 256 threads takes
// one (b, h, 64-query tile), reads its head's columns in place with the row
// stride C, and runs the flash step of common.cuh (azula::flash, shared with
// attention_fwd.cu and fused_msa.cu) over 64-key tiles: float32 scores, a
// running row max and denominator, a float32 (64, D) accumulator in
// registers, divided once at the end. This is fused_msa.cu's loop with stride
// C in place of 3 C and no norm or rotation. Tensor cores and TMA are later
// work.
#include "common.cuh"

namespace {

namespace flash = azula::flash;

template <typename T, int D>
__global__ void __launch_bounds__(flash::kThreads)
flash_blhd_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ m, float* __restrict__ l, int L, int H, float scale) {
  extern __shared__ float4 smem4[];
  const flash::Tiles<D> s(reinterpret_cast<float*>(smem4));

  const int C = H * D;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t base = static_cast<size_t>(b) * L * C + h * D;
  const int q0 = blockIdx.x * flash::BQ;

  float acc[4][D / 16];
  flash::load_tile<T, D>(q + base, C, s.Q, q0, L);
  flash::start_rows<D>(s, acc);

  for (int k0 = 0; k0 < L; k0 += flash::BK) {
    __syncthreads();  // the previous tile's readers are done
    flash::load_tile<T, D>(k + base, C, s.K, k0, L);
    flash::load_tile<T, D>(v + base, C, s.V, k0, L);
    __syncthreads();
    flash::attend_tile<T, D, true>(s, acc, k0, L, scale);
  }

  flash::store_rows<T, D>(s, acc, o + base, C, q0, L);

  // the rows' final max and denominator, (b, h) row-major over L
  const int i = threadIdx.x;
  if (i < flash::BQ && q0 + i < L) {
    const size_t row = static_cast<size_t>(blockIdx.y) * L + q0 + i;
    m[row] = s.m[i];
    l[row] = s.l[i];
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* m, float* l, int B, int L, int H,
                   float scale, cudaStream_t s) {
  // the limit is an attribute of the device's copy of the kernel, so it is
  // set on every launch: the current device may differ from the last one
  constexpr int bytes = flash::Tiles<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_blhd_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;

  const dim3 grid((L + flash::BQ - 1) / flash::BQ, B * H);
  flash_blhd_fwd_kernel<T, D><<<grid, flash::kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), m, l, L, H,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* m, float* l, int B, int L, int H,
                     int D, float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, m, l, B, L, H, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, m, l, B, L, H, scale, s);
    case 192: return launch<T, 192>(q, k, v, o, m, l, B, L, H, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, m, l, B, L, H, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (B, L, H D) contiguous; m, l: float32 (B, H, L); dtype 0 =
// float32, 1 = bfloat16; D in {64, 128, 192, 256}; B * H <= 65535. Returns
// cudaGetLastError().
extern "C" int azula_flash_blhd_fwd(const void* q, const void* k, const void* v, void* o, void* m, void* l, int B,
                                    int L, int H, int D, float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || B * H > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  if (dtype == azula::kBFloat16) return dispatch<__nv_bfloat16>(q, k, v, o, mf, lf, B, L, H, D, scale, s);
  if (dtype == azula::kFloat32) return dispatch<float>(q, k, v, o, mf, lf, B, L, H, D, scale, s);
  return cudaErrorInvalidValue;
}
