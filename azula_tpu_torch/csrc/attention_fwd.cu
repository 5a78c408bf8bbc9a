// Flash-attention forward: o = softmax(q k^T * scale) v on (B, H, L, D).
//
// Replaces: azula_tpu/ops/attention.py:92, _pallas_attention (512 <= L <=
// 2048), and :566, _pallas_attention_batched (L <= 512), with their additive
// bias, and the dropout form of :337, _pallas_attention_blocked. Any L is
// taken; D is 32, 64, 128, 192 or 256. Inputs and output are bf16 or
// float32.
//
// The bias is the TPU kernels' b_ref: (Gm, L, L) in the inputs' dtype, 0
// where a boolean mask keeps and -1e30 where it masks (`_mask_to_bias`),
// pair p = b H + h reading group (p / bias_div) % bias_mod (the "full",
// "batch", "head" and "one" modes of `_bias_group_fn`); it is added to the
// scaled scores. A row masked everywhere gives the mean of v, as on the TPU
// (the -inf of the XLA path gives NaN). Dropout is the blocked kernel's: the
// keep mask is the coordinate hash of azula::PairMask over (row, column,
// pair) and two seed words read from the device, kept weights p / (1 - r)
// rounded to the input dtype against the running max enter the value
// product, while the denominator, and so the LSE, stay those of the
// undropped softmax. The exact and LSE entries take both; the max-free
// entry takes neither (JAX ignores max_free under a mask or dropout).
//
// The LSE entry is the same forward with the TPU kernels' with_lse=True
// output, the residual of the backward (attention_bwd.cu): each row's float32
// log-sum-exp m + log l, (B H, L), from the online softmax's final row max m
// and denominator l (the TPU kernels write it lane-replicated, (B H, L, 128)).
// The inference entry writes no LSE, as JAX's primal path writes none. In
// bf16 every entry rounds its exp-weights to bf16 before the value product,
// as the TPU kernels do (in float32 that rounding is the identity).
//
// The max-free entry replaces _pallas_attention_blocked (L > 2048) and
// _pallas_attention's max_free option, in the same unmasked inference form:
// no row max and no rescale, p = exp(min(s, 80)) rounded to the input dtype
// before the value product, the denominator summed from the unrounded p, and
// o = acc / l at the end. The Python wrapper takes it where the JAX package's
// TPU dispatch threads max_free (L > 512, L % 128 == 0, D % 64 == 0).
//
// Bound on the H100: a (b, h) pair does 4 L^2 D operations on 8 L D bytes
// (bf16), L / 2 operations per byte, against the ~295 at which the bf16
// tensor cores (989 TFLOP/s) rather than memory (3.35 TB/s) limit: bound by
// operations from L ~ 600 (ADM's L = 1024, dit64's 1024, FLUX.1's 4608), by
// bytes below (ADM's L = 64 and 256). float32 runs on the CUDA cores (67
// TFLOP/s, ~20 operations per byte) and is bound by operations at every
// length.
//
// Design, bf16 (every form): the Hopper flash forward, warp-specialised.
// One block takes 64 or 128 query rows of one pair, one consumer
// warpgroup per 64 rows, and a producer (a warp beside one consumer
// warpgroup; a warpgroup that hands its registers to two, see tc::Layout).
// The producer's one thread loads the Q tile once and then the K and V
// tiles of 128 keys (64 at D = 192, 256) by TMA into a ring of two stages,
// each tile as 64-column panels in the 128-byte swizzle (D = 32: one
// 32-column panel in the 64-byte swizzle), signalling mbarriers; a stage is
// reloaded once every consumer thread has released it, so the loads of the
// next tile run under the products of this one. Each consumer computes the
// tile's scores S = Q K^T by wgmma (m64 n128 k16 steps over D, both
// operands K-major in shared memory, float32 accumulators), the online
// softmax in registers (each row's max and denominator reduced over the four
// threads that share it by shuffles; no score tile in shared memory and no
// barrier but the ring's), and O += P V by wgmma with P, rounded to bf16,
// as the register A operand (the float32 accumulator layout is the A
// fragment layout) and V read MN-major from shared memory. Within a
// warpgroup the two products and the softmax run in turn; the two
// warpgroups of a block interleave. The bias is read per score from device
// memory, its loads issued under the score product; the keep mask is
// hashed per score at its absolute (row, column). The weights enter the
// value product rounded to bf16 against the running max of the key tiles
// in every form, the exact inference entry included (as JAX's kernels round
// them against the row max), while the denominator sums them unrounded and
// o = acc / l at the end; `_attention_tiled_plain` repeats this arithmetic.
// A block at L <= 64 takes one warpgroup, so that half its rows do not
// idle. Blocks form a one-dimensional grid, (pair, query tile) with the
// tiles of a pair together. The block itself (its tiling, layout, softmax
// step and products: forward_block) is in attention_tc.cuh, which
// fused_msa.cu shares; this file gives it the maps of q, k and v.
//
// Design, float32: the CUDA-core flash step of common.cuh (azula::flash),
// unchanged: one block of 256 threads per (pair, 64-query tile) walks 64-key
// tiles through shared memory as float32 with plain FMA (no TF32, which
// would break the float32 gates); the exact inference entry keeps its
// weights unrounded.
#include <climits>

#include "attention_tc.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace flash = azula::flash;

// float32: one block is one 64-query tile of one pair (the tiles of a pair
// together in the one-dimensional grid). With kDropout the value product
// takes the dropped-out weights (rounding the weights to float32 is the
// identity, so every entry computes the same o). Unless lse is null, each
// row's log-sum-exp goes to lse.
template <int D, bool kMaxFree, bool kDropout>
__global__ void __launch_bounds__(flash::kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, float* __restrict__ lse, int L, float scale, azula::MaskArgs args) {
  extern __shared__ float4 smem4[];
  const flash::Tiles<D> s(reinterpret_cast<float*>(smem4));

  const int tiles = (L + flash::BQ - 1) / flash::BQ;
  const int pair = blockIdx.x / tiles;
  const size_t base = static_cast<size_t>(pair) * L * D;
  const int q0 = (blockIdx.x % tiles) * flash::BQ;
  const azula::PairMask<float> mask(args, pair, L);

  float acc[4][D / 16];
  flash::load_tile<float, D>(q + base, D, s.Q, q0, L);
  flash::start_rows<D>(s, acc);

  for (int k0 = 0; k0 < L; k0 += flash::BK) {
    __syncthreads();  // the previous tile's readers are done
    flash::load_tile<float, D>(k + base, D, s.K, k0, L);
    flash::load_tile<float, D>(v + base, D, s.V, k0, L);
    __syncthreads();
    flash::attend_tile<float, D, false, kMaxFree, kDropout>(s, acc, k0, L, scale, q0, mask);
  }

  flash::store_rows<float, D>(s, acc, o + base, D, q0, L);

  // the rows' final max and denominator were written before the last tile's
  // second barrier
  const int i = threadIdx.x;
  if (lse != nullptr && i < flash::BQ && q0 + i < L) {
    lse[static_cast<size_t>(pair) * L + q0 + i] = s.m[i] + logf(s.l[i]);
  }
}

// The three entries: the exact inference forward, the max-free forward and
// the exact forward with the LSE output.
enum class Form { kExact, kMaxFree, kLse };

template <int D, Form F>
cudaError_t launch_float(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int L, float scale,
                         const azula::MaskArgs& mask, cudaStream_t s) {
  auto* const kernel = mask.seed != nullptr  ? attention_fwd_kernel<D, false, true>
                       : F == Form::kMaxFree ? attention_fwd_kernel<D, true, false>
                                             : attention_fwd_kernel<D, false, false>;

  const long long blocks = static_cast<long long>(BH) * ((L + flash::BQ - 1) / flash::BQ);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;

  // the limit is an attribute of the device's copy of the kernel, so it is
  // set on every launch: the current device may differ from the last one
  constexpr int bytes = flash::Tiles<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;

  kernel<<<static_cast<unsigned>(blocks), flash::kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(o),
      lse, L, scale, mask);
  return cudaGetLastError();
}

// The bf16 forward on the tensor cores (attention_tc.cuh).
namespace tc {

using namespace azula::attention_tc;

// The maps of q, k and v, (B H, L, D) each, and the pair's rows of o and
// the LSE: the Io of forward_block.
template <int D>
struct PairIo {
  static constexpr bool kPrepare = false;
  const CUtensorMap* maps[3];
  int pair;
  bf16* o;
  size_t ld;
  float* lse;

  __device__ __forceinline__ void load(int which, uint32_t dst, uint32_t bar, int row0, int rows) const {
    using T = Tiling<D>;
    for (int p = 0; p < T::kPanels; ++p) {
      hw::tma_load(dst + p * rows * T::kRow, maps[which], bar, p * T::kPanel, row0, pair);
    }
  }
};

// One block: BM = 64 NW query rows of one pair (the query tiles of a pair
// together in the one-dimensional grid). Unless lse is null, each row's
// log-sum-exp goes to lse.
template <int D, int NW, bool kMaxFree, bool kBias, bool kDropout>
__global__ void __launch_bounds__(Layout<D, NW>::kThreads, 1)
attention_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, float* __restrict__ lse,
                        int L, float scale, azula::MaskArgs args) {
  constexpr int BM = Layout<D, NW>::BM;
  const int q_tiles = (L + BM - 1) / BM;
  const int pair = blockIdx.x / q_tiles;
  PairIo<D> io;
  io.maps[0] = &q_map;
  io.maps[1] = &k_map;
  io.maps[2] = &v_map;
  io.pair = pair;
  io.o = o + static_cast<size_t>(pair) * L * D;
  io.ld = D;
  io.lse = lse == nullptr ? nullptr : lse + static_cast<size_t>(pair) * L;
  forward_block<D, NW, kMaxFree, kBias, kDropout>(io, (blockIdx.x % q_tiles) * BM, L, scale, args);
}

template <int D, int NW, bool kMaxFree, bool kBias, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int L, float scale,
                   const azula::MaskArgs& mask, cudaStream_t s) {
  using S = Layout<D, NW>;
  using T = Tiling<D>;
  const long long blocks = static_cast<long long>(BH) * ((L + S::BM - 1) / S::BM);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;

  CUtensorMap q_map, k_map, v_map;
  if (!hw::encode_panels(&q_map, q, BH, L, D, T::kPanel, S::BM) ||
      !hw::encode_panels(&k_map, k, BH, L, D, T::kPanel, T::BK) ||
      !hw::encode_panels(&v_map, v, BH, L, D, T::kPanel, T::BK)) {
    return cudaErrorInvalidValue;
  }

  constexpr auto kernel = attention_fwd_tc_kernel<D, NW, kMaxFree, kBias, kDropout>;
  const cudaError_t e = hw::allow_shared_memory<kernel>(S::kBytes);
  if (e != cudaSuccess) return e;

  kernel<<<static_cast<unsigned>(blocks), S::kThreads, S::kBytes, s>>>(q_map, k_map, v_map, static_cast<bf16*>(o), lse,
                                                                        L, scale, mask);
  return cudaGetLastError();
}

// The kernel of a bf16 call: two warpgroups up to D = 128, one above (for
// the registers of the (64, D) accumulator) and, for the unmasked exact
// forms, at L <= 64.
template <int D, Form F>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int L, float scale,
                     const azula::MaskArgs& mask, cudaStream_t s) {
  constexpr int NW = D <= 128 ? 2 : 1;
  const bool bias = mask.bias != nullptr;
  const bool dropout = mask.seed != nullptr;
  if (F == Form::kMaxFree) return launch<D, NW, true, false, false>(q, k, v, o, lse, BH, L, scale, mask, s);
  if (bias && dropout) return launch<D, NW, false, true, true>(q, k, v, o, lse, BH, L, scale, mask, s);
  if (bias) return launch<D, NW, false, true, false>(q, k, v, o, lse, BH, L, scale, mask, s);
  if (dropout) return launch<D, NW, false, false, true>(q, k, v, o, lse, BH, L, scale, mask, s);
  if (L <= 64) return launch<D, 1, false, false, false>(q, k, v, o, lse, BH, L, scale, mask, s);
  return launch<D, NW, false, false, false>(q, k, v, o, lse, BH, L, scale, mask, s);
}

}  // namespace tc

template <Form F>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int L, int D,
                     float scale, bool is_bf16, const azula::MaskArgs& mask, cudaStream_t s) {
  switch (D) {
    case 32:
      return is_bf16 ? tc::dispatch<32, F>(q, k, v, o, lse, BH, L, scale, mask, s)
                  : launch_float<32, F>(q, k, v, o, lse, BH, L, scale, mask, s);
    case 64:
      return is_bf16 ? tc::dispatch<64, F>(q, k, v, o, lse, BH, L, scale, mask, s)
                  : launch_float<64, F>(q, k, v, o, lse, BH, L, scale, mask, s);
    case 128:
      return is_bf16 ? tc::dispatch<128, F>(q, k, v, o, lse, BH, L, scale, mask, s)
                  : launch_float<128, F>(q, k, v, o, lse, BH, L, scale, mask, s);
    case 192:
      return is_bf16 ? tc::dispatch<192, F>(q, k, v, o, lse, BH, L, scale, mask, s)
                  : launch_float<192, F>(q, k, v, o, lse, BH, L, scale, mask, s);
    case 256:
      return is_bf16 ? tc::dispatch<256, F>(q, k, v, o, lse, BH, L, scale, mask, s)
                  : launch_float<256, F>(q, k, v, o, lse, BH, L, scale, mask, s);
    default: return cudaErrorInvalidValue;
  }
}

template <Form F>
int entry(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int L, int D, float scale,
          int dtype, void* stream, const azula::MaskArgs& mask) {
  if (BH <= 0 || L <= 0 || mask.bias_div <= 0 || mask.bias_mod <= 0) return cudaErrorInvalidValue;
  if (F == Form::kMaxFree && (mask.bias != nullptr || mask.seed != nullptr)) return cudaErrorInvalidValue;
  if (dtype != azula::kBFloat16 && dtype != azula::kFloat32) return cudaErrorInvalidValue;
  return dispatch<F>(q, k, v, o, lse, BH, L, D, scale, dtype == azula::kBFloat16, mask,
                     static_cast<cudaStream_t>(stream));
}

}  // namespace

// q, k, v, o: (BH, L, D) contiguous, dtype 0 = float32, 1 = bfloat16;
// D in {32, 64, 128, 192, 256}. bias: null or (Gm, L, L) in the dtype, pair
// p reading group (p / bias_div) % bias_mod; seed: null (no dropout) or two
// int32 words on the device, keeping where the hash is at least `threshold`
// and scaling kept weights by 1 / retain. Returns cudaGetLastError().
extern "C" int azula_attention_fwd(const void* q, const void* k, const void* v, void* o, int BH, int L, int D,
                                   float scale, int dtype, void* stream, const void* bias, int bias_div,
                                   int bias_mod, const void* seed, int threshold, float retain) {
  return entry<Form::kExact>(q, k, v, o, nullptr, BH, L, D, scale, dtype, stream,
                             azula::mask_args(bias, bias_div, bias_mod, seed, threshold, retain));
}

// The max-free form, unmasked: q, k, v, o, BH, L, D, scale, dtype and stream
// as above.
extern "C" int azula_attention_fwd_max_free(const void* q, const void* k, const void* v, void* o, int BH, int L,
                                            int D, float scale, int dtype, void* stream) {
  return entry<Form::kMaxFree>(q, k, v, o, nullptr, BH, L, D, scale, dtype, stream, azula::MaskArgs());
}

// The exact form with the LSE output, lse: float32 (BH, L) contiguous; the
// other arguments as azula_attention_fwd's.
extern "C" int azula_attention_fwd_lse(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                                       int L, int D, float scale, int dtype, void* stream, const void* bias,
                                       int bias_div, int bias_mod, const void* seed, int threshold, float retain) {
  return entry<Form::kLse>(q, k, v, o, static_cast<float*>(lse), BH, L, D, scale, dtype, stream,
                           azula::mask_args(bias, bias_div, bias_mod, seed, threshold, retain));
}

// The dynamic shared memory of a block of the bf16 tensor-core forward at
// head dim D with 1 or 2 consumer warpgroups (0 if there is no such block).
extern "C" int azula_attention_fwd_tc_shared_bytes(int D, int warpgroups) {
  const bool two = warpgroups == 2;
  if (warpgroups != 1 && !(two && D <= 128)) return 0;
  switch (D) {
    case 32: return two ? tc::Layout<32, 2>::kBytes : tc::Layout<32, 1>::kBytes;
    case 64: return two ? tc::Layout<64, 2>::kBytes : tc::Layout<64, 1>::kBytes;
    case 128: return two ? tc::Layout<128, 2>::kBytes : tc::Layout<128, 1>::kBytes;
    case 192: return tc::Layout<192, 1>::kBytes;
    case 256: return tc::Layout<256, 1>::kBytes;
    default: return 0;
  }
}
