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
// limit, so the kernel is bound by bytes (0.030 ms per call at B = 128,
// H = 6, D = 64). float32 runs on the CUDA cores (67 TFLOP/s, ~20
// operations per byte) and is bound by operations.
//
// Design, bf16: the warp-specialised tensor-core forward of
// attention_fwd.cu (attention_tc.cuh's forward_block, described there), with
// its tiling, producer, two-stage K/V ring and online softmax, reading the
// projection in place through one four-dimensional tensor map over qkv,
// dimensions (D, 3 H, L, B): head h's q is at coordinate h of the second
// dimension, its k at H + h and its v at 2 H + h, so a box of (64 columns,
// 1, rows, 1) is a panel of one head's rows with the row stride 3 C, and
// rows past L arrive as zeros. The preparation of `_reference` runs in
// shared memory between a tile's arrival and the scores: the consumer
// threads normalize and rotate the Q tile once, and each K tile as it
// arrives, in place in its 128-byte swizzle (two threads per row, each on
// half of every panel's 16-byte chunks, so that a row's mean square sums
// over all panels and a (2 j, 2 j + 1) lane pair, inside one chunk, is
// rotated where it lies), rounding to bf16; then a proxy fence and a named
// barrier of the consumers hand the tile to wgmma. V goes to the value
// product untouched. The weights enter the value product rounded to bf16
// against the running max of each 128-key tile (64 at D = 192, 256), the
// denominator sums them unrounded and o = acc / l at the end
// (`_fused_msa_tiled_plain` repeats this arithmetic); each row of o goes
// to (b, row, h D) by the consumers' stores, so no head transpose goes
// through memory. The TPU kernel's head-pair packing and max-free shortcut
// are TPU devices and are not carried over.
//
// Design, float32: the TPU kernel held a batch row's whole (L, 3 C) slab in
// VMEM and looped over heads inside one program. Here one block of 256
// threads takes one (b, h, 64-query tile) and reads its head's columns in
// place, with the row stride 3 C. Following `_reference`, q and k are
// normalized first: each 64-row tile is loaded to shared memory as
// float32, each row's mean square is summed by four threads (float32), the
// row is scaled by rsqrt(mean + eps), rotated as z cos2 + swap(z) sin2
// (products and sum rounded separately, as the plain version's elementwise
// ops are). K rows are prepared this way as each 64-key tile streams in.
// The attention is the flash step of common.cuh (azula::flash), shared
// with `attention_fwd.cu`: float32 scores, a running row max and
// denominator, a float32 (64, D) accumulator in registers, divided once at
// the end, with plain FMA (no TF32, which would break the float32 gates).
#include <climits>

#include "attention_tc.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace flash = azula::flash;

// The float32 form on the CUDA cores.

// In place on a loaded q or k tile, four threads per row: RMS-normalize the
// row (has_eps) and rotate its lane pairs by the rope tables (cos2 !=
// nullptr; the tables point at this head's columns, rows C apart).
template <int D>
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
    row[j] = z;
  }
}

template <int D>
__global__ void __launch_bounds__(flash::kThreads)
fused_msa_kernel(const float* __restrict__ qkv, const float* __restrict__ cos2, const float* __restrict__ sin2,
                 float* __restrict__ o, int L, int H, int has_eps, float eps, float scale) {
  static_assert(D % 64 == 0, "D is a multiple of 64");

  extern __shared__ float4 smem4[];
  const flash::Tiles<D> s(reinterpret_cast<float*>(smem4));

  const int C = H * D;
  const int ld = 3 * C;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const float* q = qkv + static_cast<size_t>(b) * L * ld + h * D;
  const float* k = q + C;
  const float* v = q + 2 * C;
  const float* c2 = cos2 == nullptr ? nullptr : cos2 + h * D;
  const float* s2 = sin2 == nullptr ? nullptr : sin2 + h * D;
  float* out = o + static_cast<size_t>(b) * L * C + h * D;

  const int q0 = blockIdx.x * flash::BQ;

  float acc[4][D / 16];
  flash::load_tile<float, D>(q, ld, s.Q, q0, L);
  flash::start_rows<D>(s, acc);
  __syncthreads();
  prepare_tile<D>(s.Q, q0, L, c2, s2, C, has_eps != 0, eps);

  for (int k0 = 0; k0 < L; k0 += flash::BK) {
    __syncthreads();  // Q is prepared; the previous tile's readers are done
    flash::load_tile<float, D>(k, ld, s.K, k0, L);
    flash::load_tile<float, D>(v, ld, s.V, k0, L);
    __syncthreads();
    prepare_tile<D>(s.K, k0, L, c2, s2, C, has_eps != 0, eps);
    __syncthreads();
    flash::attend_tile<float, D, true>(s, acc, k0, L, scale);
  }

  flash::store_rows<float, D>(s, acc, out, C, q0, L);
}

template <int D>
cudaError_t launch_float(const void* qkv, const float* cos2, const float* sin2, void* o, int B, int L, int H,
                   int has_eps, float eps, float scale, cudaStream_t s) {
  // the limit is an attribute of the device's copy of the kernel, so it is
  // set on every launch: the current device may differ from the last one
  constexpr int bytes = flash::Tiles<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_msa_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;

  const dim3 grid((L + flash::BQ - 1) / flash::BQ, B * H);
  fused_msa_kernel<D><<<grid, flash::kThreads, bytes, s>>>(
      static_cast<const float*>(qkv), cos2, sin2, static_cast<float*>(o), L, H, has_eps, eps, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_float(const void* qkv, const float* cos2, const float* sin2, void* o, int B, int L, int H,
                           int D, int has_eps, float eps, float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch_float<64>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    case 128: return launch_float<128>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    case 192: return launch_float<192>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    case 256: return launch_float<256>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 form on the tensor cores.
namespace tc {

using namespace azula::attention_tc;

// The rows of one (b, h) pair read in place from qkv through one map, with
// the preparation of q and k, and its rows of o (the Io of forward_block).
template <int D>
struct QkvIo {
  using T = Tiling<D>;
  static constexpr bool kPrepare = true;
  const CUtensorMap* map;
  int pair, b, h, H;
  bf16* o;
  size_t ld;
  float* lse = nullptr;
  const float* cos2;  // this head's column 0 of row 0, rows ld apart; or null (no rope)
  const float* sin2;
  bool has_eps;
  float eps;
  bool prepares;      // has_eps or rope: else the tiles go to the products as they arrive

  // `rows` rows from row0 of q (which = 0), k (1) or v (2): one box per
  // panel, panel p at dst + p rows kRow
  __device__ __forceinline__ void load(int which, uint32_t dst, uint32_t bar, int row0, int rows) const {
    for (int p = 0; p < T::kPanels; ++p) {
      hw::tma_load(dst + p * rows * T::kRow, map, bar, p * T::kPanel, which * H + h, row0, b);
    }
  }

  // In place on a tile of `rows` rows from position row0, in the 128-byte
  // swizzle (logical 16-byte chunk j of row r at physical chunk j ^ r % 8),
  // by its 2 rows consumer threads: thread t takes row t / 2 and chunks
  // 4 (t % 2) to 4 (t % 2) + 3 of every panel (the threads of four rows read
  // eight distinct chunks, all 32 banks, at a time). RMS-normalize the row
  // (has_eps), rotate its lane pairs (cos2 != null) and round to bf16, in
  // `_reference`'s order: z * factor, then z cos2 + swap(z) sin2 with
  // products and sum rounded separately. Rows past L, zeros, stay zeros.
  __device__ __forceinline__ void prepare(uint32_t tile, int rows, int row0, int L) const {
    constexpr int kChunks = 4;
    const int r = threadIdx.x / 2;
    const int part = threadIdx.x % 2;
    const int pos = row0 + r;
    const uint32_t row = tile + r * T::kRow;

    float factor = 1.f;
    if (has_eps) {
      float ss = 0.f;
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p) {
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
          const int j = kChunks * part + i;
          const uint4 w = hw::load_shared_v4(row + p * rows * T::kRow + ((j ^ (r % 8)) * 16));
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float lo = __uint_as_float(words[x] << 16);
            const float hi = __uint_as_float(words[x] & 0xFFFF0000u);
            ss = fmaf(lo, lo, ss);
            ss = fmaf(hi, hi, ss);
          }
        }
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      factor = rsqrtf(ss / D + eps);
    }
    if (pos >= L) return;

    const float* c2 = cos2 == nullptr ? nullptr : cos2 + static_cast<size_t>(pos) * ld;
    const float* s2 = sin2 == nullptr ? nullptr : sin2 + static_cast<size_t>(pos) * ld;
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int j = kChunks * part + i;
        const uint32_t addr = row + p * rows * T::kRow + ((j ^ (r % 8)) * 16);
        const uint4 w = hw::load_shared_v4(addr);
        uint32_t words[4] = {w.x, w.y, w.z, w.w};
        const int col = p * T::kPanel + 8 * j;  // the chunk's first column in the head
        float4 cs[2], sn[2];
        if (c2 != nullptr) {
          cs[0] = __ldg(reinterpret_cast<const float4*>(c2 + col));
          cs[1] = __ldg(reinterpret_cast<const float4*>(c2 + col + 4));
          sn[0] = __ldg(reinterpret_cast<const float4*>(s2 + col));
          sn[1] = __ldg(reinterpret_cast<const float4*>(s2 + col + 4));
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float lo = __uint_as_float(words[x] << 16);
          float hi = __uint_as_float(words[x] & 0xFFFF0000u);
          if (has_eps) {
            lo = __fmul_rn(lo, factor);
            hi = __fmul_rn(hi, factor);
          }
          if (c2 != nullptr) {
            // sin2 carries the sign: -sin on even lanes, +sin on odd ones
            const float4 c = cs[x / 2];
            const float4 sv = sn[x / 2];
            const float ce = x % 2 ? c.z : c.x, co = x % 2 ? c.w : c.y;
            const float se = x % 2 ? sv.z : sv.x, so = x % 2 ? sv.w : sv.y;
            const float a = __fadd_rn(__fmul_rn(lo, ce), __fmul_rn(hi, se));
            hi = __fadd_rn(__fmul_rn(hi, co), __fmul_rn(lo, so));
            lo = a;
          }
          words[x] = hw::pack_bf16(lo, hi);
        }
        hw::store_shared_v4(addr, make_uint4(words[0], words[1], words[2], words[3]));
      }
    }
  }
};

// The consumer warpgroups of a block at head dim D: the attention forward's
// (two up to D = 128, whose 128 query rows match the 128-key tiles, so that
// one box serves Q, K and V).
template <int D>
constexpr int kWarpgroups = D <= 128 ? 2 : 1;

// One block: BM = 64 NW query rows of one (b, h) pair (the query tiles of a
// pair together in the one-dimensional grid).
template <int D>
__global__ void __launch_bounds__(Layout<D, kWarpgroups<D>>::kThreads, 1)
fused_msa_tc_kernel(const __grid_constant__ CUtensorMap qkv_map, const float* __restrict__ cos2,
                    const float* __restrict__ sin2, bf16* __restrict__ o, int L, int H, int has_eps, float eps,
                    float scale) {
  constexpr int NW = kWarpgroups<D>;
  constexpr int BM = Layout<D, NW>::BM;
  const int C = H * D;
  const int q_tiles = (L + BM - 1) / BM;
  const int pair = blockIdx.x / q_tiles;

  QkvIo<D> io;
  io.map = &qkv_map;
  io.pair = pair;
  io.b = pair / H;
  io.h = pair % H;
  io.H = H;
  io.o = o + static_cast<size_t>(io.b) * L * C + io.h * D;
  io.ld = C;
  io.cos2 = cos2 == nullptr ? nullptr : cos2 + io.h * D;
  io.sin2 = sin2 == nullptr ? nullptr : sin2 + io.h * D;
  io.has_eps = has_eps != 0;
  io.eps = eps;
  io.prepares = io.has_eps || cos2 != nullptr;
  forward_block<D, NW, false, false, false>(io, (blockIdx.x % q_tiles) * BM, L, scale, azula::MaskArgs());
}

template <int D>
cudaError_t launch(const void* qkv, const float* cos2, const float* sin2, void* o, int B, int L, int H, int has_eps,
                   float eps, float scale, cudaStream_t s) {
  using T = Tiling<D>;
  using S = Layout<D, kWarpgroups<D>>;
  static_assert(S::BM == T::BK, "one box serves the Q and the K/V tiles");
  const long long blocks = static_cast<long long>(B) * H * ((L + S::BM - 1) / S::BM);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;

  // (D, 3 H, L, B): the columns of one head's q, k or v, the 3 H heads, the
  // rows, the batch
  const int64_t C = static_cast<int64_t>(H) * D;
  const int64_t dims[4] = {D, 3 * H, L, B};
  const int64_t strides[3] = {2 * D, 2 * 3 * C, 2 * 3 * C * L};
  const int box[4] = {T::kPanel, 1, S::BM, 1};
  CUtensorMap map;
  if (!hw::encode_map(&map, qkv, 4, dims, strides, box)) return cudaErrorInvalidValue;

  constexpr auto kernel = fused_msa_tc_kernel<D>;
  const cudaError_t e = hw::allow_shared_memory<kernel>(S::kBytes);
  if (e != cudaSuccess) return e;

  kernel<<<static_cast<unsigned>(blocks), S::kThreads, S::kBytes, s>>>(map, cos2, sin2, static_cast<bf16*>(o), L, H,
                                                                        has_eps, eps, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* qkv, const float* cos2, const float* sin2, void* o, int B, int L, int H, int D,
                     int has_eps, float eps, float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch<64>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    case 128: return launch<128>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    case 192: return launch<192>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    case 256: return launch<256>(qkv, cos2, sin2, o, B, L, H, has_eps, eps, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// qkv: (B, L, 3 H D) contiguous, 16-byte aligned; o: (B, L, H D); cos2,
// sin2: float32 (L, H D), 16-byte aligned, or both null (no rope); dtype 0 =
// float32 (the CUDA-core form), 1 = bfloat16 (the tensor-core form); D in
// {64, 128, 192, 256}; B * H <= 65535. has_eps = 0 skips the RMS-norm.
// Returns cudaGetLastError().
extern "C" int azula_fused_msa(const void* qkv, const void* cos2, const void* sin2, void* o, int B, int L, int H,
                               int D, float eps, int has_eps, float scale, int dtype, void* stream) {
  if ((cos2 == nullptr) != (sin2 == nullptr) || B <= 0 || L <= 0 || H <= 0 || B * H > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos2);
  const float* sn = static_cast<const float*>(sin2);
  if (dtype == azula::kBFloat16) return tc::dispatch(qkv, c, sn, o, B, L, H, D, has_eps, eps, scale, s);
  if (dtype == azula::kFloat32) return dispatch_float(qkv, c, sn, o, B, L, H, D, has_eps, eps, scale, s);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory of a block of the bf16 tensor-core form at head
// dim D (0 if there is none).
extern "C" int azula_fused_msa_tc_shared_bytes(int D) {
  switch (D) {
    case 64: return tc::Layout<64, tc::kWarpgroups<64>>::kBytes;
    case 128: return tc::Layout<128, tc::kWarpgroups<128>>::kBytes;
    case 192: return tc::Layout<192, tc::kWarpgroups<192>>::kBytes;
    case 256: return tc::Layout<256, tc::kWarpgroups<256>>::kBytes;
    default: return 0;
  }
}
