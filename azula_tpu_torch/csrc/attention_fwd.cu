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
// tiles of a pair together.
//
// Design, float32: the CUDA-core flash step of common.cuh (azula::flash),
// unchanged: one block of 256 threads per (pair, 64-query tile) walks 64-key
// tiles through shared memory as float32 with plain FMA (no TF32, which
// would break the float32 gates); the exact inference entry keeps its
// weights unrounded.
#include <climits>

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

// The bf16 forward on the tensor cores.
namespace tc {

namespace hw = azula::hopper;
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;  // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The tiling of head dim D: keys per tile, and the column panels in which
// TMA lays out a tile's rows in shared memory (64 bf16, 128 bytes, in the
// 128-byte swizzle; at D = 32 one 64-byte panel in the 64-byte swizzle).
template <int D>
struct Tiling {
  static constexpr int BK = D <= 128 ? 128 : 64;
  static constexpr int kPanel = D < 64 ? D : 64;                  // columns per panel
  static constexpr int kPanels = D / kPanel;
  static constexpr int kRow = 2 * kPanel;                         // bytes of a panel row
  static constexpr uint32_t kSwizzle = kRow == 128 ? 1 : 2;       // descriptor layout: 128 or 64 B
  static constexpr int kAtom = 8 * kRow;                          // bytes of 8 panel rows
  static constexpr int kSteps = kPanel / 16;                      // k16 steps of the scores in a panel
};

// A block: NW consumer warpgroups and a producer. With one consumer
// warpgroup the producer is one warp, and every thread may hold 255
// registers. With two, the producer is a warpgroup that hands its registers
// to the consumers (setmaxnreg): the launch gives every thread 168 (65,536
// registers over 384 threads), then the producer drops to 24 and the
// consumers rise to 240 (as FlashAttention-3 splits them), where a ninth
// warp alone would cap every thread at 168.
//
// Its shared memory, from a 1024-byte boundary: the Q tile (BM rows),
// kStages K tiles and kStages V tiles (BK rows each), then the barriers: Q
// arrived, K of stage s arrived, V of stage s arrived, stage s released.
template <int D, int NW>
struct Layout {
  static constexpr int kThreads = NW == 2 ? 3 * 128 : 128 + 32;
  static constexpr int kLaunchRegisters = 65536 / kThreads / 8 * 8;  // per thread, in units of 8
  static constexpr int kProducerRegisters = 24;
  static constexpr int kConsumerRegisters = 240;
  // setmaxnreg moves registers within the block only: what the producer
  // warpgroup releases must cover what the two consumer warpgroups claim,
  // or their claim waits forever
  static_assert(NW == 1 || 128 * (kLaunchRegisters - kProducerRegisters) >=
                               256 * (kConsumerRegisters - kLaunchRegisters),
                "the producer releases the registers that the consumers claim");
  static constexpr int BM = 64 * NW;
  static constexpr int kQ = BM * D * 2;
  static constexpr int kKV = Tiling<D>::BK * D * 2;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBar = kV + kStages * kKV;
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // with the alignment slack
};

static_assert(Layout<128, 2>::kBytes <= 232448 && Layout<256, 1>::kBytes <= 232448, "the tiles fit");

// The softmax step of one key tile [k0, k0 + BK) for one consumer thread
// (see the kernel for its rows r, r + 8 and columns c, c + 1 of every
// 8-column chunk).
template <int BK, bool kMaxFree, bool kBias, bool kDropout>
struct Tile {
  float scale;
  const azula::PairMask<bf16>& mask;
  const uint32_t (&rows)[2];  // the dropout hash's terms of the thread's rows
  int keys;                   // keys from k0 to L (the tile is ragged if fewer than BK)
  int c;
  int k0;

  // In place, the tile's scores sc (the 64 x BK accumulator) become its
  // weights: the scores times the scale, plus the bias, in log2 units (-inf
  // past L, which only a ragged last tile has); with kMaxFree exp2 of them
  // clamped at 80 log2(e), else the online softmax's new row max m and the
  // rescale alpha of the old sums. l sums the weights unrounded; the
  // weights stay in sc unrounded, or with kDropout the kept p / (1 - rate):
  // `pack_weights` rounds them.
  __device__ __forceinline__ void weights(float (&sc)[BK / 2], const uint32_t (&bias2)[kBias ? BK / 4 : 1],
                                          float (&m)[2], float (&l)[2], float (&alpha)[2]) const {
    if (keys >= BK) {
      weights<false>(sc, bias2, m, l, alpha);
    } else {
      weights<true>(sc, bias2, m, l, alpha);
    }
  }

  template <bool kRagged>
  __device__ __forceinline__ void weights(float (&sc)[BK / 2], const uint32_t (&bias2)[kBias ? BK / 4 : 1],
                                          float (&m)[2], float (&l)[2], float (&alpha)[2]) const {
    const float scale_log2 = scale * kLog2e;
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i / 2) % 2;
      float x;
      if constexpr (kBias) {
        const uint32_t w = bias2[2 * (i / 4) + h];
        x = __fadd_rn(__fmul_rn(sc[i], scale), __uint_as_float(i % 2 ? w & 0xFFFF0000u : w << 16)) * kLog2e;
      } else {
        x = sc[i] * scale_log2;
      }
      if constexpr (kMaxFree) x = fminf(x, flash::kMaxFreeClamp * kLog2e);
      if constexpr (kRagged) x = 8 * (i / 4) + c + i % 2 < keys ? x : -INFINITY;
      sc[i] = x;
      tile_max[h] = fmaxf(tile_max[h], x);
    }

    alpha[0] = alpha[1] = 1.f;
    if constexpr (!kMaxFree) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
        tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
        // every tile holds a key < L, so the new max is finite
        const float m_new = fmaxf(m[h], tile_max[h]);
        alpha[h] = hw::exp2_approx(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
    }

    const uint32_t col = azula::PairMask<bf16>::col_term(k0 + c);
    const float inv_retain = 1.f / mask.retain;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i / 2) % 2;
      const float p = hw::exp2_approx(kMaxFree ? sc[i] : sc[i] - m[h]);
      l[h] += p;
      float w = p;
      if constexpr (kDropout) {
        const uint32_t col_i = col + azula::PairMask<bf16>::col_term(8 * (i / 4) + i % 2);
        w = mask.keep_terms(rows[h], col_i) ? hw::divide(p, mask.retain, inv_retain) : 0.f;
      }
      sc[i] = w;
    }
  }
};

// The bias of key tile k0's scores for a consumer thread, as bf16 pairs
// (rows past L read row L - 1, keys past L nothing): word 2 n + h holds
// columns 8 n + c, 8 n + c + 1 of row r + 8 h.
template <int BK, bool kBias>
__device__ __forceinline__ void load_bias(uint32_t (&bias2)[kBias ? BK / 4 : 1], const azula::PairMask<bf16>& mask,
                                          int r, int c, int k0, int L) {
  if constexpr (kBias) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned short* row = static_cast<const unsigned short*>(static_cast<const void*>(mask.bias)) +
                                  static_cast<size_t>(min(r + 8 * h, L - 1)) * L;
      if (L % 2 == 0) {
        // row * L + col is even: the pair is one aligned 4-byte load
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const int col = k0 + 8 * n + c;
          bias2[2 * n + h] = col < L ? __ldg(reinterpret_cast<const unsigned int*>(row + col)) : 0u;
        }
      } else {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const int col = k0 + 8 * n + c;
          const uint32_t lo = col < L ? __ldg(row + col) : 0u;
          const uint32_t hi = col + 1 < L ? __ldg(row + col + 1) : 0u;
          bias2[2 * n + h] = lo | hi << 16;
        }
      }
    }
  }
}

// The weights of a tile (the 64 x BK accumulator) rounded to bf16 in the A
// fragment layout of the value product: the fragment of k16 step kk is the
// accumulator's elements 8 kk to 8 kk + 7, two per word.
template <int BK>
__device__ __forceinline__ void pack_weights(const float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = hw::pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
  }
}

// sc = Q K^T for the warpgroup's 64 rows and a BK-key tile, issued and
// committed as one wgmma group: k16 steps over D, panel by panel.
template <int D, int BM>
__device__ __forceinline__ void issue_scores(float (&sc)[Tiling<D>::BK / 2], uint32_t q_tile, uint32_t k_tile) {
  using T = Tiling<D>;
  hw::fence_registers(sc);
  hw::mma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % T::kSteps) * 32;
    const uint32_t panel = kk / T::kSteps;
    const uint64_t a = hw::descriptor(q_tile + panel * BM * T::kRow + step, 16, T::kAtom, T::kSwizzle);
    const uint64_t b = hw::descriptor(k_tile + panel * T::BK * T::kRow + step, 16, T::kAtom, T::kSwizzle);
    hw::mma_ss<T::BK>(sc, a, b, kk > 0);
  }
  hw::mma_commit();
}

// acc += P V for the tile's weights pa and a BK-key V tile, issued and
// committed as one wgmma group: k16 steps over the keys, N = D.
template <int D>
__device__ __forceinline__ void issue_values(float (&acc)[D / 2], const uint32_t (&pa)[Tiling<D>::BK / 16][4],
                                             uint32_t v_tile) {
  using T = Tiling<D>;
  hw::fence_registers(acc);
  hw::mma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
    const uint64_t b = hw::descriptor(v_tile + kk * 16 * T::kRow, T::BK * T::kRow, T::kAtom, T::kSwizzle);
    hw::mma_rs<D>(acc, pa[kk], b);
  }
  hw::mma_commit();
}

// One block: BM = 64 NW query rows of one pair, NW consumer warpgroups and a
// producer (see Layout). With kMaxFree the max-free softmax; with kBias the pair's
// bias is added to the scaled scores; with kDropout the value product takes
// the dropped-out weights. Unless lse is null, each row's log-sum-exp goes
// to lse.
//
// Thread t of a consumer warpgroup holds, in the m64 accumulator layout,
// rows r and r + 8 (r = 16 (t / 32) + t % 32 / 4 of the warpgroup's 64) and
// in every 8-column chunk n the columns 8 n + c and 8 n + c + 1
// (c = 2 (t % 4)): element i of an accumulator is at row r + 8 ((i / 2) % 2),
// column 8 (i / 4) + c + i % 2. The four threads of a row differ in t % 4.
template <int D, int NW, bool kMaxFree, bool kBias, bool kDropout>
__global__ void __launch_bounds__(Layout<D, NW>::kThreads, 1)
attention_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, float* __restrict__ lse,
                        int L, float scale, azula::MaskArgs args) {
  using T = Tiling<D>;
  using S = Layout<D, NW>;
  constexpr int BM = S::BM;
  constexpr int BK = T::BK;
  static_assert(!(kMaxFree && (kBias || kDropout)), "the max-free form is unmasked");

  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const uint32_t base = (hw::smem_addr(tc_smem) + 1023) & ~1023u;
  const uint32_t q_full = base + S::kBar;
  const uint32_t k_full = q_full + 8;              // + 8 s for stage s
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int q_tiles = (L + BM - 1) / BM;
  const int pair = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int k_tiles = (L + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hw::barrier_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hw::barrier_init(k_full + 8 * s, 1);
      hw::barrier_init(v_full + 8 * s, 1);
      hw::barrier_init(empty + 8 * s, 128 * NW);
    }
    hw::barrier_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp >= 4 * NW) {
    // the producer: one thread loads Q, then key tile j into stage j % 2 as
    // soon as the consumers have released that stage's tile j - 2. Rows past
    // L arrive as zeros.
    if constexpr (NW == 2) hw::release_registers<Layout<D, NW>::kProducerRegisters>();
    if (warp == 4 * NW && lane == 0) {
      hw::barrier_expect(q_full, S::kQ);
      for (int p = 0; p < T::kPanels; ++p) {
        hw::tma_load(base + p * BM * T::kRow, &q_map, q_full, p * T::kPanel, q0, pair);
      }
      for (int j = 0; j < k_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) hw::barrier_wait(empty + 8 * s, (j / kStages - 1) & 1);
        const uint32_t kt = base + S::kK + s * S::kKV;
        const uint32_t vt = base + S::kV + s * S::kKV;
        hw::barrier_expect(k_full + 8 * s, S::kKV);
        for (int p = 0; p < T::kPanels; ++p) {
          hw::tma_load(kt + p * BK * T::kRow, &k_map, k_full + 8 * s, p * T::kPanel, j * BK, pair);
        }
        hw::barrier_expect(v_full + 8 * s, S::kKV);
        for (int p = 0; p < T::kPanels; ++p) {
          hw::tma_load(vt + p * BK * T::kRow, &v_map, v_full + 8 * s, p * T::kPanel, j * BK, pair);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows [q0 + 64 wg, q0 + 64 wg + 64)
  if constexpr (NW == 2) hw::claim_registers<Layout<D, NW>::kConsumerRegisters>();
  const int wg = warp / 4;
  const int r = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // absolute row of half 0
  const int c = 2 * (lane % 4);
  const azula::PairMask<bf16> mask(args, pair, L);
  const uint32_t q_tile = base + 64 * wg * T::kRow;  // the warpgroup's rows in each Q panel

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max, in log2 units (unused by max-free)
  float l[2] = {0.f, 0.f};              // this thread's part of the row denominators
  const uint32_t rows[2] = {mask.row_term(r), mask.row_term(r + 8)};  // the dropout hash's row terms

  float sc[BK / 2];                     // a tile's scores, then its weights
  uint32_t pa[BK / 16][4];              // the weights in bf16, the value product's A operand
  uint32_t bias2[kBias ? BK / 4 : 1];   // the tile's bias in bf16 pairs
  float alpha[2];                       // the rescale of the rows' old sums
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;

  // Per key tile: the scores (K arrived), the softmax in registers, the
  // value product (V arrived), then the stage is released to the producer,
  // which has the next tile's loads in flight meanwhile.
  hw::barrier_wait(q_full, 0);
  for (int j = 0; j < k_tiles; ++j) {
    const int stage = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    hw::barrier_wait(k_full + 8 * stage, parity);
    issue_scores<D, BM>(sc, q_tile, base + S::kK + stage * S::kKV);
    load_bias<BK, kBias>(bias2, mask, r, c, j * BK, L);
    hw::mma_wait<0>();
    hw::fence_registers(sc);

    Tile<BK, kMaxFree, kBias, kDropout>{scale, mask, rows, L - j * BK, c, j * BK}.weights(sc, bias2, m, l, alpha);
    if constexpr (!kMaxFree) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
    }
    pack_weights<BK>(sc, pa);

    hw::barrier_wait(v_full + 8 * stage, parity);
    issue_values<D>(acc, pa, base + S::kV + stage * S::kKV);
    hw::mma_wait<0>();
    hw::fence_registers(acc);
    hw::barrier_arrive(empty + 8 * stage);
  }

  // the rows' denominators, o = acc / l rounded to bf16, and the LSE
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = r + 8 * h;
    if (row < L) {
      bf16* dst = o + (static_cast<size_t>(pair) * L + row) * D + c;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * h] / l[h], acc[4 * n + 2 * h + 1] / l[h]);
      }
      if constexpr (!kMaxFree) {
        if (lse != nullptr && lane % 4 == 0) lse[static_cast<size_t>(pair) * L + row] = m[h] * kLn2 + logf(l[h]);
      }
    }
  }
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
