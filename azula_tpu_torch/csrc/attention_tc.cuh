// The bf16 flash-attention forward on Hopper's tensor cores, shared by
// attention_fwd.cu (q, k, v as (B H, L, D)) and fused_msa.cu (q, k, v read
// in place from the (B, L, 3 H D) projection, q and k normalized and
// rotated in shared memory): the tiling, the block's layout, the softmax
// step, the two wgmma products and the warp-specialised block itself
// (`forward_block`), which reads its tiles and writes its rows through an
// `Io` policy. attention_fwd.cu describes the design.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace azula {
namespace attention_tc {

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
      if constexpr (kMaxFree) x = fminf(x, azula::flash::kMaxFreeClamp * kLog2e);
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


// One block: BM = 64 NW query rows [q0, q0 + BM) of one pair, NW consumer
// warpgroups and a producer (see Layout). With kMaxFree the max-free
// softmax; with kBias the pair's bias is added to the scaled scores; with
// kDropout the value product takes the dropped-out weights.
//
// `io` is where the tiles come from and the rows go:
// - io.pair, the pair's index (its mask and dropout hash);
// - io.load(which, dst, bar, row0, rows): the TMA loads of `rows` rows from
//   row0 of q (which = 0), k (1) or v (2), panel p at dst + p rows kRow,
//   completing on barrier `bar`;
// - Io::kPrepare and io.prepare(tile, rows, row0, L), run by every consumer
//   thread on the Q tile once and on each K tile as it arrives (while
//   io.prepares is true), in place in shared memory; the block fences the
//   writes for wgmma and synchronises its consumers after it;
// - io.o and io.ld: row 0 of the pair's output and the stride of its rows;
//   io.lse: the pair's row log-sum-exps, or null.
//
// Thread t of a consumer warpgroup holds, in the m64 accumulator layout,
// rows r and r + 8 (r = 16 (t / 32) + t % 32 / 4 of the warpgroup's 64) and
// in every 8-column chunk n the columns 8 n + c and 8 n + c + 1
// (c = 2 (t % 4)): element i of an accumulator is at row r + 8 ((i / 2) % 2),
// column 8 (i / 4) + c + i % 2. The four threads of a row differ in t % 4.
template <int D, int NW, bool kMaxFree, bool kBias, bool kDropout, class Io>
__device__ __forceinline__ void forward_block(const Io& io, int q0, int L, float scale, const MaskArgs& args) {
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
    if constexpr (NW == 2) hw::release_registers<S::kProducerRegisters>();
    if (warp == 4 * NW && lane == 0) {
      hw::barrier_expect(q_full, S::kQ);
      io.load(0, base, q_full, q0, BM);
      for (int j = 0; j < k_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) hw::barrier_wait(empty + 8 * s, (j / kStages - 1) & 1);
        hw::barrier_expect(k_full + 8 * s, S::kKV);
        io.load(1, base + S::kK + s * S::kKV, k_full + 8 * s, j * BK, BK);
        hw::barrier_expect(v_full + 8 * s, S::kKV);
        io.load(2, base + S::kV + s * S::kKV, v_full + 8 * s, j * BK, BK);
      }
    }
    return;
  }

  // a consumer warpgroup: query rows [q0 + 64 wg, q0 + 64 wg + 64)
  if constexpr (NW == 2) hw::claim_registers<S::kConsumerRegisters>();
  const int wg = warp / 4;
  const int r = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // absolute row of half 0
  const int c = 2 * (lane % 4);
  const PairMask<bf16> mask(args, io.pair, L);
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

  // the preparation of a tile by all consumer threads, made visible to the
  // wgmma reads of both warpgroups
  const auto prepare = [&](uint32_t tile, int rows_in_tile, int row0) {
    if constexpr (Io::kPrepare) {
      if (io.prepares) {
        io.prepare(tile, rows_in_tile, row0, L);
        hw::fence_async_shared();
        hw::sync_threads(1, 128 * NW);
      }
    }
  };

  // Per key tile: the scores (K arrived), the softmax in registers, the
  // value product (V arrived), then the stage is released to the producer,
  // which has the next tile's loads in flight meanwhile.
  hw::barrier_wait(q_full, 0);
  prepare(base, BM, q0);
  for (int j = 0; j < k_tiles; ++j) {
    const int stage = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    hw::barrier_wait(k_full + 8 * stage, parity);
    prepare(base + S::kK + stage * S::kKV, BK, j * BK);
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
      bf16* dst = io.o + static_cast<size_t>(row) * io.ld + c;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * h] / l[h], acc[4 * n + 2 * h + 1] / l[h]);
      }
      if constexpr (!kMaxFree) {
        if (io.lse != nullptr && lane % 4 == 0) io.lse[row] = m[h] * kLn2 + logf(l[h]);
      }
    }
  }
}

}  // namespace attention_tc
}  // namespace azula
