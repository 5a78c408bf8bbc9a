// Fused multi-head self-attention forward on the QKV projection layout:
// o[b, :, h] = softmax(rope(norm(q)) rope(norm(k))^T * scale) v per head.
//
// Replaces: azula_tpu/ops/fused_msa.py:200 (_kernel_call). It computes the
// function of that file's `_reference` (fused_msa.py:88-144), not the
// arithmetic of the Pallas body, which defers the RMS-norm to the logits and
// so rounds elsewhere. qkv is (B, L, 3 C) with C = H D, q of head h at
// columns h D, k at C + h D, v at 2 C + h D; the output is (B, L, C) with head
// h at columns h D. Inputs and output are bf16 or float32; D is 64, 128, 192
// or 256; any L is taken (the ragged last tile is masked). The RMS-norm (eps)
// and the rotation (cos2 / sin2 from `rope_tables`, float32 (L, C)) are each
// optional.
//
// Bound on the H100: a (b, h) pair reads 3 L D and writes L D elements and
// does 4 L^2 D operations, L / 2 operations per byte in bf16. At dit32's
// L = 256 that is 128, below the ~295 where the bf16 tensor cores would
// limit, so the ideal kernel is bound by bytes (0.030 ms per call at B = 128,
// H = 6, D = 64). This kernel runs its products on the float32 CUDA cores
// (67 TFLOP/s, ~20 operations per byte), so it is bound by operations.
//
// Design: the TPU kernel held a batch row's whole (L, 3 C) slab in VMEM and
// looped over heads inside one program. Here one block of 256 threads takes
// one (b, h, 64-query tile) and reads its head's columns in place, with the
// row stride 3 C, so no head transpose goes through memory. Following
// `_reference`, q and k are normalized first: each 64-row tile is loaded to
// shared memory as float32, each row's mean square is summed by four threads
// (float32), the row is scaled by rsqrt(mean + eps), rotated as
// z cos2 + swap(z) sin2 (products and sum rounded separately, as the plain
// version's elementwise ops are) and rounded to the input dtype. K rows are
// prepared this way as each 64-key tile streams in, so a K tile is prepared
// once per query tile (four times per head at L = 256). The attention is the
// flash step of common.cuh (azula::flash), shared with `attention_fwd.cu`:
// float32 scores, a running row max and denominator, a float32 (64, D)
// accumulator in registers, divided once at the end. In bf16 the exp-weights
// are rounded to bf16 before the value product (as `_reference` rounds
// them), while the denominator sums them unrounded. The products use plain
// FMA; tensor cores (mma.sync / wgmma), TMA and head-pair packing are later
// work.
#include "common.cuh"

namespace {

namespace flash = azula::flash;

using azula::round_to;

// In place on a loaded q or k tile, four threads per row: RMS-normalize the
// row (has_eps), rotate its lane pairs by the rope tables (cos2 != nullptr;
// the tables point at this head's columns, rows C apart) and round to T.
template <typename T, int D>
__device__ __forceinline__ void prepare_tile(float* tile, int row0, int L, const float* __restrict__ cos2,
                                             const float* __restrict__ sin2, int C, bool has_eps, float eps) {
  static_assert(flash::kThreads == 4 * 64, "four threads per tile row");
  const int r = threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  const bool valid = row0 + r < L;
  float2* row = reinterpret_cast<float2*>(tile + r * (D + 4));

  float factor = 1.f;
  if (has_eps) {
    float ss = 0.f;
    for (int j = part; j < D / 2; j += 4) {
      const float2 z = row[j];
      ss = fmaf(z.x, z.x, ss);
      ss = fmaf(z.y, z.y, ss);
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    factor = rsqrtf(ss / D + eps);
  }

  const bool rope = cos2 != nullptr && valid;
  const float2* c2 = rope ? reinterpret_cast<const float2*>(cos2 + static_cast<size_t>(row0 + r) * C) : nullptr;
  const float2* s2 = rope ? reinterpret_cast<const float2*>(sin2 + static_cast<size_t>(row0 + r) * C) : nullptr;

  if (!valid) return;  // padding rows stay zero

  for (int j = part; j < D / 2; j += 4) {
    float2 z = row[j];
    if (has_eps) {
      z.x = __fmul_rn(z.x, factor);
      z.y = __fmul_rn(z.y, factor);
    }
    if (rope) {
      // sin2 carries the sign: -sin on even lanes, +sin on odd ones
      const float2 c = c2[j];
      const float2 s = s2[j];
      z = make_float2(__fadd_rn(__fmul_rn(z.x, c.x), __fmul_rn(z.y, s.x)),
                      __fadd_rn(__fmul_rn(z.y, c.y), __fmul_rn(z.x, s.y)));
    }
    row[j] = make_float2(round_to<T>(z.x), round_to<T>(z.y));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(flash::kThreads)
fused_msa_kernel(const T* __restrict__ qkv, const float* __restrict__ cos2, const float* __restrict__ sin2,
                 T* __restrict__ o, int L, int H, int has_eps, float eps, float scale) {
  static_assert(D % 64 == 0, "D is a multiple of 64");

  extern __shared__ float4 smem4[];
  const flash::Tiles<D> s(reinterpret_cast<float*>(smem4));

  const int C = H * D;
  const int ld = 3 * C;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const T* q = qkv + static_cast<size_t>(b) * L * ld + h * D;
  const T* k = q + C;
  const T* v = q + 2 * C;
  const float* c2 = cos2 == nullptr ? nullptr : cos2 + h * D;
  const float* s2 = sin2 == nullptr ? nullptr : sin2 + h * D;
  T* out = o + static_cast<size_t>(b) * L * C + h * D;

  const int q0 = blockIdx.x * flash::BQ;

  float acc[4][D / 16];
  flash::load_tile<T, D>(q, ld, s.Q, q0, L);
  flash::start_rows<D>(s, acc);
  __syncthreads();
  prepare_tile<T, D>(s.Q, q0, L, c2, s2, C, has_eps != 0, eps);

  for (int k0 = 0; k0 < L; k0 += flash::BK) {
    __syncthreads();  // Q is prepared; the previous tile's readers are done
    flash::load_tile<T, D>(k, ld, s.K, k0, L);
    flash::load_tile<T, D>(v, ld, s.V, k0, L);
    __syncthreads();
    prepare_tile<T, D>(s.K, k0, L, c2, s2, C, has_eps != 0, eps);
    __syncthreads();
    flash::attend_tile<T, D, true>(s, acc, k0, L, scale);
  }

  flash::store_rows<T, D>(s, acc, out, C, q0, L);
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const float* cos2, const float* sin2, void* o, int B, int L, int H,
                   int has_eps, float eps, float scale, cudaStream_t s) {
  // the limit is an attribute of the device's copy of the kernel, so it is
  // set on every launch: the current device may differ from the last one
  constexpr int bytes = flash::Tiles<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_msa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;

  const dim3 grid((L + flash::BQ - 1) / flash::BQ, B * H);
  fused_msa_kernel<T, D><<<grid, flash::kThreads, bytes, s>>>(
      static_cast<const T*>(qkv), cos2, sin2, static_cast<T*>(o), L, H, has_eps, eps, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* qkv, const float* cos2, const float* sin2, void* o, int B, int L, int H, int D,
                     int has_eps, float eps, float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    case 128: return launch<T, 128>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    case 192: return launch<T, 192>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    case 256: return launch<T, 256>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv: (B, L, 3 H D) contiguous; o: (B, L, H D); cos2, sin2: float32 (L, H D)
// or both null (no rope); dtype 0 = float32, 1 = bfloat16; D in {64, 128,
// 192, 256}; B * H <= 65535. has_eps = 0 skips the RMS-norm. Returns
// cudaGetLastError().
extern "C" int azula_fused_msa(const void* qkv, const void* cos2, const void* sin2, void* o, int B, int L, int H,
                               int D, float eps, int has_eps, float scale, int dtype, void* stream) {
  if ((cos2 == nullptr) != (sin2 == nullptr) || B <= 0 || L <= 0 || H <= 0 || B * H > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos2);
  const float* sn = static_cast<const float*>(sin2);
  if (dtype == azula::kBFloat16) return dispatch<__nv_bfloat16>(qkv, c, sn, o, B, L, H, D, has_eps, eps, scale, s);
  if (dtype == azula::kFloat32) return dispatch<float>(qkv, c, sn, o, B, L, H, D, has_eps, eps, scale, s);
  return cudaErrorInvalidValue;
}
