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
// to bf16 before it (against the running max of the key tiles). Besides o,
// the kernel writes each row's float32 log-sum-exp m + log l, (B, H, L), as
// the residual of the backward (flash_blhd_bwd.cu); the JAX kernel
// recomputes the softmax there instead.
//
// Bound on the H100: a (b, h) pair reads 3 L D and writes L D elements and
// does 4 L^2 D operations, L / 2 operations per byte in bf16. At dit32's
// L = 256 that is 128, below the ~295 where the bf16 tensor cores would
// limit, so the ideal kernel is bound by bytes (0.030 ms per call at B = 128,
// H = 6, D = 64).
//
// Design, bf16: the Hopper flash forward of attention_tc.cuh
// (`forward_items`, shared with attention_fwd.cu and fused_msa.cu), given
// the heads in place by `BlhdIo` through the rows policy
// `hopper::HeadsLayout` (shared with flash_blhd_bwd.cu): one tensor map per
// input, q, k and v as (C, L, B), so that the producer's TMA boxes are head
// h's 64-column panels at columns h D + 64 p, rows past L filled with zeros;
// o is written with the row stride C. A query tile is 128 rows of one (b, h) pair on two
// consumer warpgroups up to D = 128 (64 rows on one above, and at L <= 64),
// as attention_fwd.cu chooses them, with key tiles of 128 (64 at D >= 192)
// in a two-stage ring. At dit32's L = 256 a tile has only two key tiles, so
// a block's prologue (barriers, the maps, the first loads) and epilogue
// weigh on it: so one block per SM takes an even, contiguous share of the
// tiles, the tiles of a pair together, with two Q buffers, its producer
// loading the next tile's Q, K and V under this tile's products and output.
// Any number of pairs fits.
//
// Design, float32: the CUDA-core flash step of common.cuh (azula::flash,
// shared with attention_fwd.cu and fused_msa.cu): one block of 256 threads
// per (pair, 64-query tile) reads its head's columns in place with the row
// stride C and walks 64-key tiles through shared memory, products by plain
// FMA (no TF32, which would break the float32 gates).
#include <algorithm>
#include <climits>

#include "attention_tc.cuh"
#include "common.cuh"

namespace {

namespace flash = azula::flash;

// float32: one block is one 64-query tile of one (b, h) pair.
template <int D>
__global__ void __launch_bounds__(flash::kThreads)
flash_blhd_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      float* __restrict__ o, float* __restrict__ lse, int L, int H, float scale) {
  extern __shared__ float4 smem4[];
  const flash::Tiles<D> s(reinterpret_cast<float*>(smem4));

  const int C = H * D;
  const int tiles = (L + flash::BQ - 1) / flash::BQ;
  const int pair = blockIdx.x / tiles;
  const size_t base = static_cast<size_t>(pair / H) * L * C + pair % H * D;
  const int q0 = (blockIdx.x % tiles) * flash::BQ;

  float acc[4][D / 16];
  flash::load_tile<float, D>(q + base, C, s.Q, q0, L);
  flash::start_rows<D>(s, acc);

  for (int k0 = 0; k0 < L; k0 += flash::BK) {
    __syncthreads();  // the previous tile's readers are done
    flash::load_tile<float, D>(k + base, C, s.K, k0, L);
    flash::load_tile<float, D>(v + base, C, s.V, k0, L);
    __syncthreads();
    flash::attend_tile<float, D, true>(s, acc, k0, L, scale);
  }

  flash::store_rows<float, D>(s, acc, o + base, C, q0, L);

  // the rows' final max and denominator were written before the last tile's
  // second barrier
  const int i = threadIdx.x;
  if (i < flash::BQ && q0 + i < L) lse[static_cast<size_t>(pair) * L + q0 + i] = s.m[i] + logf(s.l[i]);
}

template <int D>
cudaError_t launch_float(const void* q, const void* k, const void* v, void* o, float* lse, int B, int L, int H,
                         float scale, cudaStream_t s) {
  const long long blocks = static_cast<long long>(B) * H * ((L + flash::BQ - 1) / flash::BQ);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;

  // the limit is an attribute of the device's copy of the kernel, so it is
  // set on every launch: the current device may differ from the last one
  constexpr int bytes = flash::Tiles<D>::kBytes;
  const cudaError_t e =
      cudaFuncSetAttribute(flash_blhd_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;

  flash_blhd_fwd_kernel<D><<<static_cast<unsigned>(blocks), flash::kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(o),
      lse, L, H, scale);
  return cudaGetLastError();
}

// The bf16 forward on the tensor cores (attention_tc.cuh).
namespace tc {

using namespace azula::attention_tc;

// The maps of q, k and v, each (C, L, B), and the rows of one (b, h)
// pair's o and LSE: the Io of forward_items.
template <int D>
struct BlhdIo {
  static constexpr bool kPrepare = false;
  const CUtensorMap* maps[3];
  hw::HeadsLayout<D> heads;
  int pair;
  bf16* o;
  size_t ld;
  float* lse;

  // `rows` rows from row0 of q (which = 0), k (1) or v (2): the pair's
  // panel p at dst + p rows kRow
  __device__ __forceinline__ void load(int which, uint32_t dst, uint32_t bar, int row0, int rows) const {
    using T = Tiling<D>;
    for (int p = 0; p < T::kPanels; ++p) {
      heads.load(dst + p * rows * T::kRow, maps[which], bar, pair, p * T::kPanel, row0);
    }
  }
};

// A block's query tiles: the run [first, first + n) of the B H q_tiles
// tiles of the call, the tiles of a pair together, and each tile's Io.
template <int D, int NW>
struct BlhdTiles {
  static constexpr int BM = Layout<D, NW>::BM;
  const CUtensorMap* maps[3];
  bf16* o;
  float* lse;
  int L, H, q_tiles, first, n;

  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ int q0(int i) const { return (first + i) % q_tiles * BM; }
  __device__ __forceinline__ BlhdIo<D> io(int i) const {
    BlhdIo<D> tile;
    tile.maps[0] = maps[0];
    tile.maps[1] = maps[1];
    tile.maps[2] = maps[2];
    tile.heads = {L, H};
    tile.pair = (first + i) / q_tiles;
    tile.ld = static_cast<size_t>(H) * D;
    tile.o = o + tile.heads.offset(tile.pair, 0);
    tile.lse = lse + static_cast<size_t>(tile.pair) * L;
    return tile;
  }
};

// One block: an even share of the call's `tiles` query tiles of BM = 64 NW
// rows, a contiguous run, in turn (one tile when there are no more tiles
// than SMs), with two Q buffers so that the next tile's loads run under this
// one's products and output.
template <int D, int NW>
__global__ void __launch_bounds__(Layout<D, NW, 2>::kThreads, 1)
flash_blhd_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, float* __restrict__ lse,
                         int L, int H, int tiles, float scale) {
  const int first = static_cast<int>(static_cast<long long>(tiles) * blockIdx.x / gridDim.x);
  const int last = static_cast<int>(static_cast<long long>(tiles) * (blockIdx.x + 1) / gridDim.x);
  using Items = BlhdTiles<D, NW>;
  const Items items{{&q_map, &k_map, &v_map}, o, lse, L, H, (L + Items::BM - 1) / Items::BM, first, last - first};
  forward_items<D, NW, false, false, false, 2>(items, L, scale, azula::MaskArgs());
}

// The launch over B H pairs: one block per SM (one fits, by its
// registers), each walking an even share of the query tiles.
template <int D, int NW>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int L, int H, float scale,
                   cudaStream_t s) {
  using S = Layout<D, NW, 2>;
  using T = Tiling<D>;
  const long long tiles = static_cast<long long>(B) * H * ((L + S::BM - 1) / S::BM);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long blocks = std::min<long long>(tiles, sms);

  const hw::HeadsLayout<D> heads{L, H};
  CUtensorMap q_map, k_map, v_map;
  if (!heads.encode(&q_map, q, B * H, T::kPanel, S::BM) || !heads.encode(&k_map, k, B * H, T::kPanel, T::BK) ||
      !heads.encode(&v_map, v, B * H, T::kPanel, T::BK)) {
    return cudaErrorInvalidValue;
  }

  constexpr auto kernel = flash_blhd_fwd_tc_kernel<D, NW>;
  e = hw::allow_shared_memory<kernel>(S::kBytes);
  if (e != cudaSuccess) return e;

  kernel<<<static_cast<unsigned>(blocks), S::kThreads, S::kBytes, s>>>(q_map, k_map, v_map, static_cast<bf16*>(o), lse,
                                                                        L, H, static_cast<int>(tiles), scale);
  return cudaGetLastError();
}

// Two warpgroups up to D = 128 (for the registers of the (64, D)
// accumulator, one above) and one at L <= 64, as attention_fwd.cu's
// unmasked forms choose.
template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int L, int H,
                     float scale, cudaStream_t s) {
  constexpr int NW = D <= 128 ? 2 : 1;
  if (L <= 64) return launch<D, 1>(q, k, v, o, lse, B, L, H, scale, s);
  return launch<D, NW>(q, k, v, o, lse, B, L, H, scale, s);
}

}  // namespace tc

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int L, int H,
                     float scale, bool is_bf16, cudaStream_t s) {
  return is_bf16 ? tc::dispatch<D>(q, k, v, o, lse, B, L, H, scale, s)
                 : launch_float<D>(q, k, v, o, lse, B, L, H, scale, s);
}

}  // namespace

// q, k, v, o: (B, L, H D) contiguous, 16-byte aligned; lse: float32
// (B, H, L); dtype 0 = float32 (the CUDA-core form), 1 = bfloat16 (the
// tensor-core form); D in {64, 128, 192, 256}. Returns cudaGetLastError().
extern "C" int azula_flash_blhd_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int L,
                                    int H, int D, float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (dtype != azula::kBFloat16 && dtype != azula::kFloat32) return cudaErrorInvalidValue;
  const bool is_bf16 = dtype == azula::kBFloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64: return dispatch<64>(q, k, v, o, l, B, L, H, scale, is_bf16, s);
    case 128: return dispatch<128>(q, k, v, o, l, B, L, H, scale, is_bf16, s);
    case 192: return dispatch<192>(q, k, v, o, l, B, L, H, scale, is_bf16, s);
    case 256: return dispatch<256>(q, k, v, o, l, B, L, H, scale, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}


// The dynamic shared memory of a block of the bf16 tensor-core form at head
// dim D with 1 or 2 consumer warpgroups (0 if there is no such block).
extern "C" int azula_flash_blhd_fwd_tc_shared_bytes(int D, int warpgroups) {
  const bool two = warpgroups == 2;
  if (warpgroups != 1 && !(two && D <= 128)) return 0;
  switch (D) {
    case 64: return two ? tc::Layout<64, 2, 2>::kBytes : tc::Layout<64, 1, 2>::kBytes;
    case 128: return two ? tc::Layout<128, 2, 2>::kBytes : tc::Layout<128, 1, 2>::kBytes;
    case 192: return tc::Layout<192, 1, 2>::kBytes;
    case 256: return tc::Layout<256, 1, 2>::kBytes;
    default: return 0;
  }
}
