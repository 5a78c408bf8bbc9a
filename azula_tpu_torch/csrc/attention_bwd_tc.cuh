// The bf16 one-pass flash-attention backward on Hopper's tensor cores,
// shared by attention_bwd.cu (q, k, v, o, g as (B H, L, D), every mask and
// dropout form) and flash_blhd_bwd.cu (heads read in place from (B, L, H D),
// the plain form): the tiling, the block's layout, the loads, one
// warpgroup's share of a key tile (`consume`), the kernel, and its delta
// pre-kernel and dq-rounding post-kernel, all templated on a `Layout`
// policy that says where a pair's rows lie (hopper.cuh's PairLayout,
// HeadsLayout).
// attention_bwd.cu describes the design.
#pragma once

#include <algorithm>
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace azula {
namespace attention_bwd_tc {

namespace hw = azula::hopper;
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;   // query tiles in flight
constexpr int BM = 64;       // queries per tile
constexpr int kRowWords = 2 * BM;  // a tile's rows: BM LSEs, then BM deltas, float32
constexpr float kLog2e = 1.4426950408889634f;

// The rows policies of hopper.cuh: pairs of (B H, L, D), or heads in place
// in (B, L, H D).
using hw::HeadsLayout;
using hw::PairLayout;

// The tiling of head dim D: keys per block, and the column panels in which
// TMA lays out a tile's rows in shared memory (64 bf16, 128 bytes, in the
// 128-byte swizzle; at D <= 64 32 bf16 in the 64-byte swizzle, so that each
// warpgroup's half of dQ's columns is a whole panel).
template <int D>
struct Tiling {
  static constexpr bool kSplitKeys = D <= 128;        // the warpgroups own different 64-key halves
  static constexpr int BN = kSplitKeys ? 128 : 64;    // keys per block
  static constexpr int kPanel = D <= 64 ? 32 : 64;    // columns per panel
  static constexpr int kPanels = D / kPanel;
  static constexpr int kRow = 2 * kPanel;             // bytes of a panel row
  static constexpr uint32_t kSwizzle = kRow == 128 ? 1 : 2;  // descriptor layout: 128 or 64 B
  static constexpr int kAtom = 8 * kRow;              // bytes of 8 panel rows
  static constexpr int kSteps = kPanel / 16;          // k16 steps of the scores in a panel
};

// What warpgroup W computes: the scores of keys [kKeys, kKeys + 64)
// of the block, dK's and dV's columns [kKvCol, kKvCol + kKvN) and dQ's
// columns [kDqCol, kDqCol + kDqN) (none for the second warpgroup at D = 32);
// kWritesDs: it writes its dS^T rows to the shared tile (at D >= 192 both
// hold the same rows).
template <int D, int W>
struct Share {
  using T = Tiling<D>;
  static constexpr int kKeys = T::kSplitKeys ? 64 * W : 0;
  static constexpr int kKvN = T::kSplitKeys ? D : (W == 0 ? 128 : D - 128);
  static constexpr int kKvCol = T::kSplitKeys ? 0 : 128 * W;
  static constexpr int kDqN = T::kSplitKeys ? (D == 32 ? (W == 0 ? 32 : 0) : D / 2) : kKvN;
  static constexpr int kDqCol = T::kSplitKeys ? (D == 32 ? 0 : W * D / 2) : kKvCol;
  static constexpr bool kWritesDs = T::kSplitKeys || W == 0;
  static_assert(kKvCol % T::kPanel == 0 && kDqCol % T::kPanel == 0, "column shares start on panels");
};

// A block: two warpgroups, eight warps, so that every thread may hold 255
// registers (a (64, 128) dK and dV pair and the scores need ~200; a ninth
// warp would put three warps on an SM sub-partition and cap them at 168).
// Thread 0 also issues the loads. Its shared memory, from a 1024-byte
// boundary: the K and V tiles (BN rows), kStages Q and G tiles (BM rows),
// kStages dS^T tiles (BN rows of BM bf16), kStages tiles' rows (LSE and
// delta), then the barriers: K and V arrived, stage s arrived, stage s
// released.
template <int D>
struct Layout {
  using T = Tiling<D>;
  static constexpr int kThreads = 2 * 128;
  static constexpr int kKV = T::BN * D * 2;
  static constexpr int kQ = BM * D * 2;
  static constexpr int kDs = T::BN * BM * 2;
  static constexpr int kRows = kRowWords * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQs = kV + kKV;
  static constexpr int kGs = kQs + kStages * kQ;
  static constexpr int kDss = kGs + kStages * kQ;
  static constexpr int kRowss = kDss + kStages * kDs;
  static constexpr int kBar = kRowss + kStages * kRows;
  static constexpr int kStageBytes = 2 * kQ + kRows;  // the TMA bytes of a stage
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // with the alignment slack
};

static_assert(Layout<128>::kBytes <= 232448 && Layout<192>::kBytes <= 232448 && Layout<256>::kBytes <= 232448,
              "the tiles fit");

// X^T (64 keys x BM queries) = A B^T for the warpgroup's key rows `a_tile`
// (K or V) and a query tile `b_tile` (Q or G), both K-major: k16 steps over
// D, panel by panel, issued and committed as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_scores(float (&x)[BM / 2], uint32_t a_tile, uint32_t b_tile) {
  using T = Tiling<D>;
  hw::fence_registers(x);
  hw::mma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % T::kSteps) * 32;
    const uint32_t panel = kk / T::kSteps;
    const uint64_t a = hw::descriptor(a_tile + panel * T::BN * T::kRow + step, 16, T::kAtom, T::kSwizzle);
    const uint64_t b = hw::descriptor(b_tile + panel * BM * T::kRow + step, 16, T::kAtom, T::kSwizzle);
    hw::mma_ss<BM>(x, a, b, kk > 0);
  }
  hw::mma_commit();
}

// acc (64 keys x N) += X^T B for a tile's P~^T or dS^T in registers (four
// k16 steps over the queries) and N columns of a query tile (G or Q) from
// panel `b_tile`, MN-major; one wgmma group.
template <int D, int N>
__device__ __forceinline__ void issue_grads(float (&acc)[N / 2], const uint32_t (&x)[BM / 16][4], uint32_t b_tile) {
  using T = Tiling<D>;
  hw::fence_registers(acc);
  hw::mma_fence();
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk) {
    const uint64_t b = hw::descriptor(b_tile + kk * 16 * T::kRow, BM * T::kRow, T::kAtom, T::kSwizzle);
    hw::mma_rs<N>(acc, x[kk], b);
  }
  hw::mma_commit();
}

// dq (BM queries x N) = dS K for the tile's dS^T in shared memory (BN rows
// of BM queries, 128-byte rows: dS MN-major) and N columns of the K tile
// from panel `k_tile` (MN-major); one wgmma group that overwrites dq.
template <int D, int N>
__device__ __forceinline__ void issue_dq(float (&dq)[N / 2], uint32_t ds_tile, uint32_t k_tile) {
  using T = Tiling<D>;
  hw::fence_registers(dq);
  hw::mma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BN / 16; ++kk) {
    const uint64_t a = hw::descriptor(ds_tile + kk * 16 * 128, T::BN * 128, 8 * 128, 1);
    const uint64_t b = hw::descriptor(k_tile + kk * 16 * T::kRow, T::BN * T::kRow, T::kAtom, T::kSwizzle);
    hw::mma_ss<N, 1, 1>(dq, a, b, kk > 0);
  }
  hw::mma_commit();
}

// The bias of a tile's scores for a thread, as bf16 pairs: word
// 2 n + h holds queries q + 8 n and q + 8 n + 1 of key `key` + 8 h, the
// elements 4 n + 2 h and 4 n + 2 h + 1 of its accumulators (rows and keys
// past L read row and key L - 1).
template <bool kBias>
__device__ __forceinline__ void load_bias(uint32_t (&bias2)[kBias ? BM / 4 : 1], const azula::PairMask<bf16>& mask,
                                          int key, int q, int L) {
  if constexpr (kBias) {
    const unsigned short* bias = static_cast<const unsigned short*>(static_cast<const void*>(mask.bias));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned short* col = bias + min(key + 8 * h, L - 1);
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
        const uint32_t lo = __ldg(col + static_cast<size_t>(min(q + 8 * n, L - 1)) * L);
        const uint32_t hi = __ldg(col + static_cast<size_t>(min(q + 8 * n + 1, L - 1)) * L);
        bias2[2 * n + h] = lo | hi << 16;
      }
    }
  }
}

// The loads of a block's query tiles: tile j into stage j % kStages, its Q
// and G panels by TMA and its rows (LSE and delta) by a bulk copy, all
// completing on the stage's barrier. Rows past L arrive as zeros (their LSE
// and delta are zeros too).
template <int D, class Rows>
struct Loader {
  const CUtensorMap* q_map;
  const CUtensorMap* g_map;
  const float* rows;  // the pair's tiles' rows
  uint32_t base;
  int pair;
  Rows layout;

  __device__ __forceinline__ void load(int j) const {
    using T = Tiling<D>;
    using S = Layout<D>;
    const int s = j % kStages;
    const uint32_t bar = base + S::kBar + 8 + 8 * s;
    hw::barrier_expect(bar, S::kStageBytes);
    for (int p = 0; p < T::kPanels; ++p) {
      layout.load(base + S::kQs + s * S::kQ + p * BM * T::kRow, q_map, bar, pair, p * T::kPanel, j * BM);
      layout.load(base + S::kGs + s * S::kQ + p * BM * T::kRow, g_map, bar, pair, p * T::kPanel, j * BM);
    }
    hw::bulk_load(base + S::kRowss + s * S::kRows, rows + j * kRowWords, S::kRows, bar);
  }
};

// One warpgroup's share (see Share) of a block's work: the loop
// over the query tiles, then dK and dV to device memory.
//
// Thread t holds, in the m64 accumulator layout, rows r and r + 8
// (r = 16 (t / 32) + t % 32 / 4) and in every 8-column chunk n the columns
// 8 n + c and 8 n + c + 1 (c = 2 (t % 4)): element i of an accumulator is
// at row r + 8 ((i / 2) % 2), column 8 (i / 4) + c + i % 2. In S^T and dP^T
// the rows are keys and the columns queries, so the key mask, the bias, the
// keep mask and the LSE and delta of a score are read at (query, key) =
// (column, row); in dQ the rows are queries.
template <int D, int W, bool kBias, bool kDropout, class Rows>
__device__ __forceinline__ void consume(uint32_t base, const uint8_t* tiles, const Loader<D, Rows>& loader, int pair,
                                        int k0, int L, float scale, const azula::MaskArgs& args,
                                        bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dq_acc) {
  using T = Tiling<D>;
  using S = Layout<D>;
  using C = Share<D, W>;
  const uint32_t full = base + S::kBar + 8;  // + 8 s for stage s
  const uint32_t empty = full + 8 * kStages;
  const int t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + t % 32 / 4;
  const int c = 2 * (t % 4);
  const int key = k0 + C::kKeys + r;  // the thread's key of half 0 (half 1: key + 8)
  const azula::PairMask<bf16> mask(args, pair, L);
  const bool key_valid[2] = {key < L, key + 8 < L};
  const uint32_t key_terms[2] = {azula::PairMask<bf16>::col_term(key), azula::PairMask<bf16>::col_term(key + 8)};
  const float inv_retain = 1.f / mask.retain;
  const uint32_t k_rows = base + S::kK + C::kKeys * T::kRow;  // the warpgroup's keys in each K, V panel
  const uint32_t v_rows = base + S::kV + C::kKeys * T::kRow;

  float dk_acc[C::kKvN / 2], dv_acc[C::kKvN / 2];
#pragma unroll
  for (int i = 0; i < C::kKvN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hw::barrier_wait(base + S::kBar, 0);  // K and V
  const int q_tiles = (L + BM - 1) / BM;
  for (int j = 0; j < q_tiles; ++j) {
    const int stage = j % kStages;
    const int q0 = j * BM;
    const uint32_t q_tile = base + S::kQs + stage * S::kQ;
    const uint32_t g_tile = base + S::kGs + stage * S::kQ;
    const uint32_t ds_tile = base + S::kDss + stage * S::kDs;
    const float* lse = reinterpret_cast<const float*>(tiles + S::kRowss + stage * S::kRows);
    const float* delta = lse + BM;

    float st[BM / 2], dpt[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) st[i] = dpt[i] = 0.f;
    uint32_t bias2[kBias ? BM / 4 : 1];

    hw::barrier_wait(full + 8 * stage, (j / kStages) & 1);
    issue_scores<D>(st, k_rows, q_tile);   // S^T = K Q^T
    issue_scores<D>(dpt, v_rows, g_tile);  // dP^T = V G^T
    load_bias<kBias>(bias2, mask, key, q0 + c, L);
    hw::mma_wait<0>();
    hw::fence_registers(st);
    hw::fence_registers(dpt);

    // p, p~ and ds of the 32 scores, as the A fragments of the gradient
    // products: the fragment of k16 step kk is elements 8 kk to 8 kk + 7
    uint32_t pa[BM / 16][4], dsa[BM / 16][4];
#pragma unroll
    for (int n = 0; n < BM / 8; ++n) {
      const float2 lse2 = *reinterpret_cast<const float2*>(lse + 8 * n + c);
      const float2 delta2 = *reinterpret_cast<const float2*>(delta + 8 * n + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pt[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n + 2 * h + e;
          const int query = q0 + 8 * n + c + e;
          float x = __fmul_rn(st[i], scale);
          if constexpr (kBias) {
            const uint32_t w = bias2[2 * n + h];
            x = __fadd_rn(x, __uint_as_float(e ? w & 0xFFFF0000u : w << 16));
          }
          // exp(x - lse); the difference first, exact where a row is masked
          // everywhere and x = lse = -1e30
          float p = hw::exp2_approx(__fsub_rn(x, e ? lse2.y : lse2.x) * kLog2e);
          p = key_valid[h] && query < L ? p : 0.f;
          float dp = dpt[i];
          pt[e] = p;
          if constexpr (kDropout) {
            const bool kept = mask.keep_terms(mask.row_term(query), key_terms[h]);
            pt[e] = kept ? hw::divide(p, mask.retain, inv_retain) : 0.f;
            dp = kept ? hw::divide(dp, mask.retain, inv_retain) : 0.f;
          }
          ds[e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, e ? delta2.y : delta2.x)), scale);
        }
        pa[n / 2][2 * (n % 2) + h] = hw::pack_bf16(pt[0], pt[1]);
        dsa[n / 2][2 * (n % 2) + h] = hw::pack_bf16(ds[0], ds[1]);
        if constexpr (C::kWritesDs) {
          // dS^T row (key) of 64 queries, 16-byte chunk n swizzled by the row
          const int row = C::kKeys + r + 8 * h;
          hw::store_shared(ds_tile + row * 128 + ((n ^ (row & 7)) << 4) + c * 2, dsa[n / 2][2 * (n % 2) + h]);
        }
      }
    }
    if constexpr (C::kWritesDs) hw::fence_async_shared();

    // dV += P~^T G, dK += dS^T Q over the warpgroup's columns
    issue_grads<D, C::kKvN>(dv_acc, pa, g_tile + C::kKvCol / T::kPanel * BM * T::kRow);
    issue_grads<D, C::kKvN>(dk_acc, dsa, q_tile + C::kKvCol / T::kPanel * BM * T::kRow);
    hw::sync_threads(1, 256);  // both warpgroups' dS^T rows are in the shared tile
    hw::mma_wait<0>();
    hw::fence_registers(dv_acc);
    hw::fence_registers(dk_acc);
    hw::fence_registers(pa);
    hw::fence_registers(dsa);
    hw::barrier_arrive(empty + 8 * stage);  // Q, G and the rows are read
    if (W == 0 && t == 0 && j + kStages < q_tiles) {
      // the stage's next tile, once the other warpgroup has released it
      // too (it passed this tile's barrier, so it is close behind)
      hw::barrier_wait(empty + 8 * stage, (j / kStages) & 1);
      loader.load(j + kStages);
    }
    __syncwarp();

    // this tile's dQ over the block's keys, added to the accumulator; the
    // dS^T tile of this stage is rewritten two tiles on, after the other
    // warpgroup has passed the next tile's barrier, so after its product
    if constexpr (C::kDqN > 0) {
      float dq[C::kDqN / 2];
#pragma unroll
      for (int i = 0; i < C::kDqN / 2; ++i) dq[i] = 0.f;
      issue_dq<D, C::kDqN>(dq, ds_tile, base + S::kK + C::kDqCol / T::kPanel * T::BN * T::kRow);
      hw::mma_wait<0>();
      hw::fence_registers(dq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int query = q0 + r + 8 * h;
        if (query < L) {
          float* row = dq_acc + loader.layout.offset(pair, query) + C::kDqCol + c;
#pragma unroll
          for (int n = 0; n < C::kDqN / 8; ++n) {
            atomicAdd(reinterpret_cast<float2*>(row + 8 * n), make_float2(dq[4 * n + 2 * h], dq[4 * n + 2 * h + 1]));
          }
        }
      }
    }
  }

  // dK and dV rounded to bf16, rows past L not written
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key_valid[h]) {
      const size_t offset = loader.layout.offset(pair, key + 8 * h) + C::kKvCol + c;
#pragma unroll
      for (int n = 0; n < C::kKvN / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk + offset + 8 * n) =
            __floats2bfloat162_rn(dk_acc[4 * n + 2 * h], dk_acc[4 * n + 2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + offset + 8 * n) =
            __floats2bfloat162_rn(dv_acc[4 * n + 2 * h], dv_acc[4 * n + 2 * h + 1]);
      }
    }
  }
}

// One block: the key tile [k0, k0 + BN) of one pair (see attention_bwd.cu's
// head), the pairs' rows in `layout`. `rows` holds each query tile's LSE and
// delta (the pre-kernel's), dq_acc the float32 dq accumulator, zeroed.
template <int D, bool kBias, bool kDropout, class Rows>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
backward_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap g_map,
                const float* __restrict__ rows, bf16* __restrict__ dk, bf16* __restrict__ dv,
                float* __restrict__ dq_acc, Rows layout, float scale, azula::MaskArgs args) {
  using T = Tiling<D>;
  using S = Layout<D>;

  extern __shared__ __align__(1024) uint8_t bwd_smem[];
  const uint32_t base = (hw::smem_addr(bwd_smem) + 1023) & ~1023u;
  const uint8_t* tiles = bwd_smem + (base - hw::smem_addr(bwd_smem));
  const uint32_t kv_full = base + S::kBar;
  const uint32_t full = kv_full + 8;  // + 8 s for stage s
  const uint32_t empty = full + 8 * kStages;

  const int L = layout.L;
  const int k_tiles = (L + T::BN - 1) / T::BN;
  const int pair = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * T::BN;
  const int q_tiles = (L + BM - 1) / BM;
  const Loader<D, Rows> loader{&q_map, &g_map, rows + static_cast<size_t>(pair) * q_tiles * kRowWords, base, pair,
                               layout};

  if (threadIdx.x == 0) {
    hw::barrier_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hw::barrier_init(full + 8 * s, 1);
      hw::barrier_init(empty + 8 * s, 256);
    }
    hw::barrier_init_fence();
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // K and V once, then the first kStages query tiles; thread 0 loads each
    // later tile as its stage is released (see consume)
    hw::barrier_expect(kv_full, 2 * S::kKV);
    for (int p = 0; p < T::kPanels; ++p) {
      layout.load(base + S::kK + p * T::BN * T::kRow, &k_map, kv_full, pair, p * T::kPanel, k0);
      layout.load(base + S::kV + p * T::BN * T::kRow, &v_map, kv_full, pair, p * T::kPanel, k0);
    }
    for (int j = 0; j < kStages && j < q_tiles; ++j) loader.load(j);
  }
  __syncwarp();

  if (threadIdx.x < 128) {
    consume<D, 0, kBias, kDropout>(base, tiles, loader, pair, k0, L, scale, args, dk, dv, dq_acc);
  } else {
    consume<D, 1, kBias, kDropout>(base, tiles, loader, pair, k0, L, scale, args, dk, dv, dq_acc);
  }
}

// The pre-kernel's threads per row: a power of two, so that a row's threads
// share a warp (4, 8, 16, 8, 32 at D = 32, 64, 128, 192, 256), each taking
// runs of 8 elements.
__host__ __device__ constexpr int delta_lanes(int D) { return (D / 8) & -(D / 8); }

// The pre-kernel: row `row` of the (BH, Lp) padded rows (Lp = L rounded up
// to BM) gets delta = sum of g o in float32; the LSE and delta of each
// query tile go to `rows` as kRowWords floats (zeros past L), and the
// row's dq accumulator is zeroed. kDropout only names the form, for a
// profile.
template <int D, bool kDropout, class Rows>
__global__ void __launch_bounds__(256)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g, const float* __restrict__ lse,
             float* __restrict__ rows, float* __restrict__ dq_acc, long long padded_rows, Rows layout) {
  constexpr int kLanes = delta_lanes(D);
  constexpr int kChunks = D / 8 / kLanes;
  const int L = layout.L;
  const long long index = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  const int Lp = (L + BM - 1) / BM * BM;
  const long long pair = index / Lp;
  const int row = static_cast<int>(index % Lp);
  const bool valid = index < padded_rows && row < L;

  float sum = 0.f;
  if (valid) {
    const size_t start = layout.offset(static_cast<int>(pair), row);
#pragma unroll
    for (int chunk = 0; chunk < kChunks; ++chunk) {
      const size_t offset = start + (chunk * kLanes + part) * 8;
      float of[8], gf[8];
      azula::load<bf16, 8>(o + offset, of);
      azula::load<bf16, 8>(g + offset, gf);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum = fmaf(of[i], gf[i], sum);
      float4* acc = reinterpret_cast<float4*>(dq_acc + offset);
      acc[0] = acc[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int w = 1; w < kLanes; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);

  if (part == 0 && index < padded_rows) {
    float* tile = rows + (pair * (Lp / BM) + row / BM) * kRowWords;
    tile[row % BM] = valid ? lse[static_cast<size_t>(pair) * L + row] : 0.f;
    tile[BM + row % BM] = valid ? sum : 0.f;
  }
}

// The post-kernel: dq = the accumulator rounded to bf16, four elements a
// thread per step (the accumulator has dq's layout). kDropout and Rows only
// name the form, for a profile.
template <bool kDropout, class Rows>
__global__ void __launch_bounds__(256)
dq_round_kernel(const float4* __restrict__ acc, uint2* __restrict__ dq, long long quads) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < quads;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 a = acc[i];
    dq[i] = make_uint2(hw::pack_bf16(a.x, a.y), hw::pack_bf16(a.z, a.w));
  }
}

// The three launches of a bf16 call over BH pairs in `layout`: q, k, v, o,
// g, dq, dk, dv as the layout places them; lse float32 (BH, L); `rows`
// float32 scratch of BH ceil(L / BM) kRowWords floats, dq_acc of BH L D
// floats (in dq's layout).
template <int D, bool kBias, bool kDropout, class Rows>
cudaError_t launch(const Rows& layout, const void* q, const void* k, const void* v, const void* o, const void* g,
                   const float* lse, void* dq, void* dk, void* dv, float* rows, float* dq_acc, int BH, float scale,
                   const azula::MaskArgs& mask, cudaStream_t s) {
  using T = Tiling<D>;
  using S = Layout<D>;
  const int L = layout.L;
  const long long blocks = static_cast<long long>(BH) * ((L + T::BN - 1) / T::BN);
  const long long padded_rows = static_cast<long long>(BH) * ((L + BM - 1) / BM * BM);
  const long long delta_blocks = (padded_rows * delta_lanes(D) + 255) / 256;
  if (blocks > INT_MAX || delta_blocks > INT_MAX) return cudaErrorInvalidValue;

  CUtensorMap q_map, k_map, v_map, g_map;
  if (!layout.encode(&q_map, q, BH, T::kPanel, BM) || !layout.encode(&k_map, k, BH, T::kPanel, T::BN) ||
      !layout.encode(&v_map, v, BH, T::kPanel, T::BN) || !layout.encode(&g_map, g, BH, T::kPanel, BM)) {
    return cudaErrorInvalidValue;
  }

  delta_kernel<D, kDropout, Rows><<<static_cast<unsigned>(delta_blocks), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(g), lse, rows, dq_acc, padded_rows, layout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  constexpr auto kernel = backward_kernel<D, kBias, kDropout, Rows>;
  e = hw::allow_shared_memory<kernel>(S::kBytes);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), S::kThreads, S::kBytes, s>>>(
      q_map, k_map, v_map, g_map, rows, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dq_acc, layout, scale, mask);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const long long quads = static_cast<long long>(BH) * L * D / 4;
  const long long round_blocks = std::min<long long>((quads + 255) / 256, 132LL * 16);
  dq_round_kernel<kDropout, Rows><<<static_cast<unsigned>(round_blocks), 256, 0, s>>>(
      reinterpret_cast<const float4*>(dq_acc), static_cast<uint2*>(dq), quads);
  return cudaGetLastError();
}

}  // namespace attention_bwd_tc
}  // namespace azula
