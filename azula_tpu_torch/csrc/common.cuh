// Helpers shared by the kernels: conversion between the storage type and
// float32, vector loads and stores of N consecutive elements, the
// flash-attention tile step of the attention forward kernels, and the
// flash-attention backward of the two backward kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace azula {

// dtype codes passed by the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// N elements moved as one aligned access (16 bytes for 8 bf16 or 4 float).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&out)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(pk.v[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&in)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int i = 0; i < N; ++i) pk.v[i] = from_float<T>(in[i]);
  *reinterpret_cast<Pack<T, N>*>(p) = pk;
}

// x rounded to T and back, as a cast to T and back to float32 rounds it.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// The murmur3 finalizer of the TPU kernels' dropout hash (`_fmix32` in
// azula_tpu/ops/attention.py), on uint32: JAX's wrapping int32 products and
// logical shifts compute the same bits, and signed overflow is undefined in
// C++.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The bias and dropout of the masked and dropout attention forms, as a
// wrapper passes them to a launch: the TPU kernels' `b_ref` (an additive
// (Gm, L, L) bias in the inputs' dtype, the group of pair p being
// (p / bias_div) % bias_mod: "full", "batch", "head" or "one") and `s_ref`
// (two int32 seed words on the device), the signed keep threshold of
// `_dropout_threshold` and 1 - rate. Null pointers mean no bias, no dropout.
struct MaskArgs {
  const void* bias = nullptr;
  int bias_div = 1;
  int bias_mod = 1;
  const int* seed = nullptr;
  int threshold = 0;
  float retain = 1.f;
};

// The mask arguments of a C entry point, in the order the wrappers pass them.
inline MaskArgs mask_args(const void* bias, int bias_div, int bias_mod, const void* seed, int threshold,
                          float retain) {
  MaskArgs mask;
  mask.bias = bias;
  mask.bias_div = bias_div;
  mask.bias_mod = bias_mod;
  mask.seed = static_cast<const int*>(seed);
  mask.threshold = threshold;
  mask.retain = retain;
  return mask;
}

// MaskArgs resolved for one (batch, head) pair: its (L, L) bias and its
// dropout hash. `keep` is the TPU kernels' `_keep_mask` at the absolute
// (query, key) coordinates: murmur3 rounds of the coordinates, the pair
// index b H + h and the seed words, kept where the bits, read as int32, are
// at least the threshold. The forward and both backward kernels call it, so
// they drop the same weights whatever their tiling.
template <typename T>
struct PairMask {
  const T* bias = nullptr;  // row 0 of the pair's (L, L) bias, or null
  uint32_t pair_bits = 0;   // pair * 0x27D4EB2F ^ s0
  uint32_t s1 = 0;
  int threshold = 0;
  float retain = 1.f;

  PairMask() = default;

  __device__ PairMask(const MaskArgs& a, int pair, int L) : threshold(a.threshold), retain(a.retain) {
    if (a.bias != nullptr) {
      const int group = (pair / a.bias_div) % a.bias_mod;
      bias = static_cast<const T*>(a.bias) + static_cast<size_t>(group) * L * L;
    }
    if (a.seed != nullptr) {
      pair_bits = static_cast<uint32_t>(pair) * 0x27D4EB2Fu ^ static_cast<uint32_t>(a.seed[0]);
      s1 = static_cast<uint32_t>(a.seed[1]);
    }
  }

  // s + bias[row][col], rounded as the TPU kernels add the bias to the
  // scaled logit; s unchanged without a bias
  __device__ __forceinline__ float add_bias(float s, int row, int col, int L) const {
    return bias == nullptr ? s : __fadd_rn(s, to_float(bias[static_cast<size_t>(row) * L + col]));
  }

  __device__ __forceinline__ bool keep(int row, int col) const { return keep_terms(row_term(row), col_term(col)); }

  // The hash's row and column terms, for a caller that computes them once
  // per row and per tile: keep(row, col) = keep_terms(row_term(row),
  // col_term(col)), and col_term(a + b) = col_term(a) + col_term(b) mod 2^32.
  __device__ __forceinline__ uint32_t row_term(int row) const {
    return static_cast<uint32_t>(row) * 0x9E3779B1u ^ pair_bits;
  }

  __device__ __forceinline__ static uint32_t col_term(int col) { return static_cast<uint32_t>(col) * 1000003u; }

  __device__ __forceinline__ bool keep_terms(uint32_t row_term, uint32_t col_term) const {
    return static_cast<int32_t>(fmix32(fmix32(row_term ^ col_term) ^ s1)) >= threshold;
  }
};

// The flash-attention forward shared by attention_fwd.cu (float32),
// fused_msa.cu and flash_blhd_fwd.cu, and the tile products of
// flash_blhd_bwd.cu.
// One block of kThreads threads takes one 64-query tile of one (batch, head)
// pair and walks 64-key tiles of K and V through shared memory as float32
// (rows padded by 4 floats to keep vector reads free of bank conflicts),
// keeping an online softmax in float32: a running row max and denominator
// and a float32 (64, D) accumulator in registers, rescaled when the max grows
// and divided once at the end. Each thread computes a 4 x 4 block of scores
// and a 4 x (D / 16) block of the output. The products use plain FMA.
namespace flash {

constexpr int kThreads = 256;
constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per shared-memory tile
constexpr int LS = BK + 4;  // row stride of the score tile

// the logit clamp of the max-free softmax (`_MAX_FREE_CLAMP` of the TPU
// kernels): exp(80) ~ 5.5e34, so a row of up to ~6,000 saturated keys still
// sums below float32's 3.4e38
constexpr float kMaxFreeClamp = 80.f;

// A block's shared memory: the Q, K and V tiles (row stride LD), the score
// tile, and each query row's running max, denominator and rescale factor.
template <int D>
struct Tiles {
  static constexpr int LD = D + 4;
  static constexpr int kBytes = (3 * 64 * LD + BQ * LS + 3 * BQ) * static_cast<int>(sizeof(float));

  float* Q;
  float* K;
  float* V;
  float* S;
  float* m;
  float* l;
  float* alpha;

  __device__ explicit Tiles(float* base)
      : Q(base), K(Q + BQ * LD), V(K + BK * LD), S(V + BK * LD), m(S + BQ * LS), l(m + BQ), alpha(l + BQ) {}
};

// Rows [row0, row0 + ROWS) of a (L, D) matrix whose rows lie `ld` elements
// apart, into shared memory as float32 with row stride D + 4; zero past row L.
template <typename T, int D, int ROWS = 64>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int ld, float* dst, int row0, int L) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int cv = idx % PER_ROW;
    float v[VEC];
    if (row0 + r < L) {
      load<T, VEC>(src + static_cast<size_t>(row0 + r) * ld + cv * VEC, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * (D + 4) + cv * VEC);
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

// The running max and denominator of an empty row, and a zero accumulator.
template <int D>
__device__ __forceinline__ void start_rows(const Tiles<D>& s, float (&acc)[4][D / 16]) {
  if (threadIdx.x < BQ) {
    s.m[threadIdx.x] = -INFINITY;
    s.l[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[a][c] = 0.f;
}

// out[a][b] = sum over d of A[ty + 16 a][d] * B[tx + 16 b][d], for thread
// (tx, ty) = (t % 16, t / 16), a < RA and b < 4: one (16 RA, 64) tile of
// A B^T, for two tiles of rows D + 4 floats apart in shared memory. The sum
// runs over d in order, one FMA at a time, so the callers of this header get
// the same float32 score from the same rows; the bf16 forward of
// attention_fwd.cu sums its scores on the tensor cores in another order, so
// the backward's rebuilt scores differ from that forward's in the last bits
// of float32.
template <int RA, int D>
__device__ __forceinline__ void dot_rows(const float* A, const float* B, float (&out)[RA][4]) {
  constexpr int LD = D + 4;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) out[a][b] = 0.f;

#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 qa[RA], kb[4];
#pragma unroll
    for (int a = 0; a < RA; ++a) qa[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * LD + d);
#pragma unroll
    for (int b = 0; b < 4; ++b) kb[b] = *reinterpret_cast<const float4*>(B + (tx + 16 * b) * LD + d);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float acc_s = out[a][b];
        acc_s = fmaf(qa[a].x, kb[b].x, acc_s);
        acc_s = fmaf(qa[a].y, kb[b].y, acc_s);
        acc_s = fmaf(qa[a].z, kb[b].z, acc_s);
        acc_s = fmaf(qa[a].w, kb[b].w, acc_s);
        out[a][b] = acc_s;
      }
  }
}

// One 64-key step, once the Q tile and the K and V tiles of keys
// [k0, k0 + 64) are in shared memory behind a barrier: the scores (keys past
// L masked), the online-softmax update of each row's max and denominator, and
// acc = acc * alpha + P V. With kRoundWeights the value product takes the
// exp-weights rounded to T, while the denominator sums them unrounded. The
// caller puts a barrier before it overwrites the K, V or score tile.
// With kMaxFree there is no row max and no rescale: p = exp(min(s, 80)) and
// acc = acc + P V, the `max_free` form of the TPU kernels, for logits that
// are bounded by construction. The clamp keeps the denominator finite for
// L up to about 6,100 (L e^80 < FLT_MAX); the value accumulator, a sum of up
// to L e^80 |v|, is bounded only by |v|, as in the TPU kernel.
// Masked keys still give exp(min(-inf, 80)) = 0.
// The tile's queries start at row q0. `mask` adds the pair's bias to the
// scaled scores. With kDropout the value product takes the weights of the
// dropped-out softmax, p / (1 - rate) where `mask` keeps (q0 + i, k0 + j)
// and 0 elsewhere, rounded to T, while the denominator sums the undropped p
// (`_pallas_attention_blocked` with a seed).
template <typename T, int D, bool kRoundWeights, bool kMaxFree = false, bool kDropout = false>
__device__ __forceinline__ void attend_tile(const Tiles<D>& s, float (&acc)[4][D / 16], int k0, int L, float scale,
                                            int q0 = 0, const PairMask<T>& mask = PairMask<T>()) {
  static_assert(!(kMaxFree && kDropout), "dropout keeps the exact softmax");
  constexpr int LD = Tiles<D>::LD;
  constexpr int DC = D / 16;  // output columns per thread
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;

  // scores of query rows ty + 16 a against keys tx + 16 b
  float sc[4][4];
  dot_rows<4, D>(s.Q, s.K, sc);

#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = ty + 16 * a;
      const int j = tx + 16 * b;
      float x = -INFINITY;
      if (k0 + j < L) {
        x = __fmul_rn(sc[a][b], scale);
        if (q0 + i < L) x = mask.add_bias(x, q0 + i, k0 + j, L);
      }
      s.S[i * LS + j] = x;
    }
  __syncthreads();

  // online softmax: four threads per row, sixteen keys each
  if constexpr (kMaxFree) {
    const int i = t / 4;
    float* row = s.S + i * LS + (t % 4) * 16;

    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float p = expf(fminf(row[jj], kMaxFreeClamp));
      row[jj] = kRoundWeights ? round_to<T>(p) : p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);

    if (t % 4 == 0) s.l[i] += sum;
  } else {
    const int i = t / 4;
    const int part = t % 4;
    float* row = s.S + i * LS + part * 16;

    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) mx = fmaxf(mx, row[jj]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));

    // every tile holds at least one key < L, so m_new is finite
    const float m_old = s.m[i];
    const float m_new = fmaxf(m_old, mx);

    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float p = expf(row[jj] - m_new);
      if constexpr (kDropout) {
        const float kept = mask.keep(q0 + i, k0 + part * 16 + jj) ? __fdiv_rn(p, mask.retain) : 0.f;
        row[jj] = round_to<T>(kept);
      } else {
        row[jj] = kRoundWeights ? round_to<T>(p) : p;
      }
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);

    if (part == 0) {
      const float alpha = expf(m_old - m_new);
      s.alpha[i] = alpha;
      s.l[i] = s.l[i] * alpha + sum;
      s.m[i] = m_new;
    }
  }
  __syncthreads();

  // acc = acc * alpha + P V for rows ty + 16 a, columns tx * DC + c
  if constexpr (!kMaxFree) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float alpha = s.alpha[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
  }

  for (int j = 0; j < BK; j += 4) {
    float4 p4[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) p4[a] = *reinterpret_cast<const float4*>(s.S + (ty + 16 * a) * LS + j);

#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float vv[DC];
      const float* vrow = s.V + (j + jj) * LD + tx * DC;
      if constexpr (DC % 4 == 0) {
#pragma unroll
        for (int c = 0; c < DC; c += 4) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + c);
          vv[c] = w.x;
          vv[c + 1] = w.y;
          vv[c + 2] = w.z;
          vv[c + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < DC; c += 2) {
          const float2 w = *reinterpret_cast<const float2*>(vrow + c);
          vv[c] = w.x;
          vv[c + 1] = w.y;
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = jj == 0 ? p4[a].x : jj == 1 ? p4[a].y : jj == 2 ? p4[a].z : p4[a].w;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(p, vv[c], acc[a][c]);
      }
    }
  }
}

// The block's output rows q0 + i < L, divided by their denominators, to
// `out` (row 0 of this pair's columns, rows `ld` elements apart). The
// denominators were last written before the final tile's second barrier.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const Tiles<D>& s, const float (&acc)[4][D / 16], T* out, int ld, int q0,
                                           int L) {
  constexpr int DC = D / 16;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    if (q0 + i < L) {
      const float l = s.l[i];
      T* dst = out + static_cast<size_t>(q0 + i) * ld + tx * DC;
#pragma unroll
      for (int c = 0; c < DC; ++c) dst[c] = from_float<T>(acc[a][c] / l);
    }
  }
}

}  // namespace flash

// The flash-attention backward shared by flash_blhd_bwd.cu (the (B, L, H D)
// layout, statistics m and l) and attention_bwd.cu (the (B H, L, D) layout,
// the log-sum-exp): dq, dk, dv of o = softmax(q k^T * scale) v per (batch,
// head) pair, given the cotangent g of o. Rows of a pair's q, k, v, o and g
// lie C = H D elements apart and its columns start at h D; the (B, H, L, D)
// layout is the case H = 1 with the pairs as the batch. The arithmetic is the
// JAX bodies', with their rounding points:
//
//   p     = exp(s - m) / l, or exp(s - lse)   float32, s = (q k^T) * scale
//   dp    = g v^T                             float32
//   delta = sum over d of g * o               float32, of the stored (rounded) o and g
//   ds    = T(p * (dp - delta) * scale)       rounded to the input dtype T
//   dq    = T(ds k), dk = T(ds^T q), dv = T(T(p)^T g), each summed in float32
//
// The work is the FlashAttention-2 split into two kernels, launched in order
// on one stream; no block writes another's output, so no atomics are needed
// and the result does not depend on the order in which blocks run:
//
// 1. dq: one block per (pair, query tile). It keeps the Q and G tiles in
//    shared memory, computes each row's delta from o and g (and writes it to a
//    float32 (B, H, L) scratch), then streams 64-key tiles of K and V: the
//    scores and dp by the flash tile product, p rebuilt exactly from the
//    saved statistics, ds rounded to T in a shared tile, dq += ds K in
//    registers.
// 2. dk, dv: one block per (pair, 64-key tile). It keeps K and V, streams the
//    query tiles of Q and G with their statistics and delta, rebuilds p and
//    ds the same way, and accumulates dk += ds^T Q and dv += T(p)^T G in
//    registers.
//
// Tiles live in shared memory as float32, rows padded by 4 floats. A query
// tile has 64 rows for D <= 128 and 32 rows above, so that the four tiles
// fit (217,472 bytes at D = 256). Each file defines its own two __global__
// kernels over `dq_block` and `dkv_block` (so that a profile tells the
// routes apart) and launches them with `launch`.
namespace flash_bwd {

constexpr int kThreads = flash::kThreads;
constexpr int BK = 64;      // keys per tile
constexpr int LS = BK + 4;  // row stride of the p and ds tiles

// A block's shared memory: the query-side tiles Q and G (BQ rows), the
// key-side tiles K and V (BK rows), the rounded p and ds tiles, and each
// query row's statistics (m and l, or the log-sum-exp in m and 1 in l) and
// delta.
template <int D>
struct Tiles {
  static constexpr int BQ = D <= 128 ? 64 : 32;  // query rows per tile
  static constexpr int RA = BQ / 16;              // query rows per thread in a tile product
  static constexpr int LD = D + 4;
  static constexpr int kBytes =
      (2 * BQ * LD + 2 * BK * LD + 2 * BQ * LS + 3 * BQ) * static_cast<int>(sizeof(float));

  float* Q;
  float* G;
  float* K;
  float* V;
  float* P;
  float* dS;
  float* m;
  float* l;
  float* delta;

  __device__ explicit Tiles(float* base)
      : Q(base),
        G(Q + BQ * LD),
        K(G + BQ * LD),
        V(K + BK * LD),
        P(V + BK * LD),
        dS(P + BQ * LS),
        m(dS + BQ * LS),
        l(m + BQ),
        delta(l + BQ) {}
};

static_assert(Tiles<256>::kBytes <= 232448 && Tiles<128>::kBytes <= 232448, "the tiles fit in shared memory");

// Row `row` of a pair's statistics into shared slot r: (m, l), or (lse, 1)
// with kLse; rows past L get (0, 1).
template <int D, bool kLse>
__device__ __forceinline__ void load_stats(const Tiles<D>& s, int r, const float* m, const float* l, size_t row,
                                           bool valid) {
  s.m[r] = valid ? m[row] : 0.f;
  if constexpr (kLse) {
    s.l[r] = 1.f;
  } else {
    s.l[r] = valid ? l[row] : 1.f;
  }
}

// p and ds of the (BQ, 64) tile of query rows q0 + i and keys k0 + j, once
// Q, G, K, V and the rows' statistics and delta are in shared memory: p and
// ds of thread (tx, ty) at rows ty + 16 a and keys tx + 16 b. Rows or keys
// past L get p = ds = 0. `mask` adds the pair's bias to the scaled scores;
// with kDropout, p comes out as the dropped weights p~ = M p / (1 - rate)
// that the forward's value product took, and ds = T(p (M dp / (1 - rate) -
// delta) scale), `_p_ds` of `_pallas_attention_bwd`.
template <typename T, int D, bool kLse, bool kDropout = false>
__device__ __forceinline__ void p_and_ds(const Tiles<D>& s, int q0, int k0, int L, float scale,
                                         float (&p)[Tiles<D>::RA][4], float (&ds)[Tiles<D>::RA][4],
                                         const PairMask<T>& mask = PairMask<T>()) {
  constexpr int RA = Tiles<D>::RA;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float sc[RA][4], dp[RA][4];
  flash::dot_rows<RA, D>(s.Q, s.K, sc);
  flash::dot_rows<RA, D>(s.G, s.V, dp);

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tx + 16 * b;
      p[a][b] = 0.f;
      ds[a][b] = 0.f;
      if (q0 + i < L && k0 + j < L) {
        // the score rounded as the forward computed it, then exp(s - m) / l
        // or exp(s - lse)
        const float x = mask.add_bias(__fmul_rn(sc[a][b], scale), q0 + i, k0 + j, L);
        const float e = expf(x - s.m[i]);
        float pij;
        if constexpr (kLse) {
          pij = e;
        } else {
          pij = e / s.l[i];
        }
        float dpij = dp[a][b];
        p[a][b] = pij;
        if constexpr (kDropout) {
          const bool kept = mask.keep(q0 + i, k0 + j);
          p[a][b] = kept ? __fdiv_rn(pij, mask.retain) : 0.f;
          dpij = kept ? __fdiv_rn(dpij, mask.retain) : 0.f;
        }
        ds[a][b] = round_to<T>(__fmul_rn(__fmul_rn(pij, dpij - s.delta[i]), scale));
      }
    }
  }
}

// acc[a][c] += sum over r < R of X[r][ty + 16 a] * Y[r][tx * DC + c]: the
// (64, D) tile X^T Y of a (R, 64) tile X (row stride LS) and a (R, D) tile Y
// (row stride D + 4), rows ty + 16 a and columns tx * DC + c of thread
// (tx, ty).
template <int R, int D>
__device__ __forceinline__ void add_transposed_product(const float* X, const float* Y, float (&acc)[4][D / 16]) {
  constexpr int DC = D / 16;
  constexpr int LD = D + 4;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  for (int r = 0; r < R; ++r) {
    float x[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = X[r * LS + ty + 16 * a];
    const float* y = Y + r * LD + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float yc = y[c];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(x[a], yc, acc[a][c]);
    }
  }
}

// The rows [row0, row0 + 16 RA) of thread (tx, ty), ty + 16 a < L - row0,
// columns tx * DC + c, rounded to T, to `out` (row 0 of this head's columns,
// rows C apart).
template <typename T, int D, int RA>
__device__ __forceinline__ void store_tile(const float (&acc)[RA][D / 16], T* out, int C, int row0, int L) {
  constexpr int DC = D / 16;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int i = ty + 16 * a;
    if (row0 + i < L) {
      T* dst = out + static_cast<size_t>(row0 + i) * C + tx * DC;
#pragma unroll
      for (int c = 0; c < DC; ++c) dst[c] = from_float<T>(acc[a][c]);
    }
  }
}

// Kernel 1, the body of one block: dq of one query tile of one pair
// b H + h, and the tile rows' delta. The grid is one-dimensional, the tiles
// of pair 0 first, so that any number of pairs fits in it.
template <typename T, int D, bool kLse, bool kDropout>
__device__ __forceinline__ void dq_block(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                         const T* __restrict__ o, const T* __restrict__ g,
                                         const float* __restrict__ m, const float* __restrict__ l,
                                         T* __restrict__ dq, float* __restrict__ delta, int L, int H, float scale,
                                         const MaskArgs& args) {
  using S = Tiles<D>;
  constexpr int BQ = S::BQ;
  constexpr int RA = S::RA;
  constexpr int DC = D / 16;
  constexpr int LD = S::LD;

  extern __shared__ float4 smem4[];
  const S s(reinterpret_cast<float*>(smem4));

  const int tiles = (L + BQ - 1) / BQ;
  const int pair = blockIdx.x / tiles;
  const int C = H * D;
  const int b = pair / H;
  const int h = pair % H;
  const size_t base = static_cast<size_t>(b) * L * C + h * D;
  const size_t rows = static_cast<size_t>(pair) * L;  // this pair's statistics and delta
  const int q0 = (blockIdx.x % tiles) * BQ;
  const PairMask<T> mask(args, pair, L);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  flash::load_tile<T, D, BQ>(q + base, C, s.Q, q0, L);
  flash::load_tile<T, D, BQ>(g + base, C, s.G, q0, L);
  __syncthreads();

  // delta of each query row, kThreads / BQ threads per row
  {
    constexpr int TPR = kThreads / BQ;
    const int r = threadIdx.x / TPR;
    const int part = threadIdx.x % TPR;
    const bool valid = q0 + r < L;

    float sum = 0.f;
    if (valid) {
      const T* orow = o + base + static_cast<size_t>(q0 + r) * C;
      for (int d = part; d < D; d += TPR) sum = fmaf(to_float(orow[d]), s.G[r * LD + d], sum);
    }
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);

    if (part == 0) {
      s.delta[r] = sum;
      load_stats<D, kLse>(s, r, m, l, rows + q0 + r, valid);
      if (valid) delta[rows + q0 + r] = sum;
    }
  }

  float acc[RA][DC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done; the row stats are in
    flash::load_tile<T, D>(k + base, C, s.K, k0, L);
    flash::load_tile<T, D>(v + base, C, s.V, k0, L);
    __syncthreads();

    float p[RA][4], ds[RA][4];
    p_and_ds<T, D, kLse, kDropout>(s, q0, k0, L, scale, p, ds, mask);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) s.dS[(ty + 16 * a) * LS + tx + 16 * bb] = ds[a][bb];
    __syncthreads();

    // acc += ds K for rows ty + 16 a, columns tx * DC + c
    for (int j = 0; j < BK; ++j) {
      const float* krow = s.K + j * LD + tx * DC;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kc = krow[c];
#pragma unroll
        for (int a = 0; a < RA; ++a) acc[a][c] = fmaf(s.dS[(ty + 16 * a) * LS + j], kc, acc[a][c]);
      }
    }
  }

  store_tile<T, D, RA>(acc, dq + base, C, q0, L);
}

// Kernel 2, the body of one block: dk and dv of one key tile of one pair,
// from the deltas that kernel 1 wrote; the grid as kernel 1's.
template <typename T, int D, bool kLse, bool kDropout>
__device__ __forceinline__ void dkv_block(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                          const T* __restrict__ g, const float* __restrict__ m,
                                          const float* __restrict__ l, const float* __restrict__ delta,
                                          T* __restrict__ dk, T* __restrict__ dv, int L, int H, float scale,
                                          const MaskArgs& args) {
  using S = Tiles<D>;
  constexpr int BQ = S::BQ;
  constexpr int RA = S::RA;
  constexpr int DC = D / 16;

  extern __shared__ float4 smem4[];
  const S s(reinterpret_cast<float*>(smem4));

  const int tiles = (L + BK - 1) / BK;
  const int pair = blockIdx.x / tiles;
  const int C = H * D;
  const int b = pair / H;
  const int h = pair % H;
  const size_t base = static_cast<size_t>(b) * L * C + h * D;
  const size_t rows = static_cast<size_t>(pair) * L;
  const int k0 = (blockIdx.x % tiles) * BK;
  const PairMask<T> mask(args, pair, L);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  flash::load_tile<T, D>(k + base, C, s.K, k0, L);
  flash::load_tile<T, D>(v + base, C, s.V, k0, L);

  // key rows ty + 16 a, columns tx * DC + c
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk_acc[a][c] = 0.f;
      dv_acc[a][c] = 0.f;
    }

  for (int q0 = 0; q0 < L; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    flash::load_tile<T, D, BQ>(q + base, C, s.Q, q0, L);
    flash::load_tile<T, D, BQ>(g + base, C, s.G, q0, L);
    if (threadIdx.x < BQ) {
      const int r = threadIdx.x;
      const bool valid = q0 + r < L;
      load_stats<D, kLse>(s, r, m, l, rows + q0 + r, valid);
      s.delta[r] = valid ? delta[rows + q0 + r] : 0.f;
    }
    __syncthreads();

    float p[RA][4], ds[RA][4];
    p_and_ds<T, D, kLse, kDropout>(s, q0, k0, L, scale, p, ds, mask);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int idx = (ty + 16 * a) * LS + tx + 16 * bb;
        s.P[idx] = round_to<T>(p[a][bb]);
        s.dS[idx] = ds[a][bb];
      }
    __syncthreads();

    add_transposed_product<BQ, D>(s.P, s.G, dv_acc);
    add_transposed_product<BQ, D>(s.dS, s.Q, dk_acc);
  }

  store_tile<T, D, 4>(dk_acc, dk + base, C, k0, L);
  store_tile<T, D, 4>(dv_acc, dv + base, C, k0, L);
}

// The two kernels' signatures: (q, k, v, o, g, m, l, dq, delta, L, H, scale,
// mask) and (q, k, v, g, m, l, delta, dk, dv, L, H, scale, mask).
template <typename T>
using DqKernel = void (*)(const T*, const T*, const T*, const T*, const T*, const float*, const float*, T*, float*,
                          int, int, float, MaskArgs);
template <typename T>
using DkvKernel = void (*)(const T*, const T*, const T*, const T*, const float*, const float*, const float*, T*, T*,
                           int, int, float, MaskArgs);

// Launches dq_kernel, then dkv_kernel, on stream s over B * H pairs.
template <typename T, int D>
cudaError_t launch(DqKernel<T> dq_kernel, DkvKernel<T> dkv_kernel, const void* q, const void* k, const void* v,
                   const void* o, const void* g, const float* m, const float* l, void* dq, void* dk, void* dv,
                   float* delta, int B, int L, int H, float scale, cudaStream_t s, const MaskArgs& mask = MaskArgs()) {
  using S = Tiles<D>;
  constexpr int bytes = S::kBytes;
  const long long tiles_q = static_cast<long long>(B) * H * ((L + S::BQ - 1) / S::BQ);
  const long long tiles_k = static_cast<long long>(B) * H * ((L + BK - 1) / BK);
  if (tiles_q > 2147483647LL || tiles_k > 2147483647LL) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);

  // the limit is an attribute of the device's copy of each kernel, so it is
  // set on every launch: the current device may differ from the last one
  cudaError_t e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;

  // dq first: it writes the deltas that the dk, dv kernel reads
  dq_kernel<<<static_cast<unsigned>(tiles_q), kThreads, bytes, s>>>(qt, kt, vt, static_cast<const T*>(o), gt, m, l,
                                                                    static_cast<T*>(dq), delta, L, H, scale, mask);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  dkv_kernel<<<static_cast<unsigned>(tiles_k), kThreads, bytes, s>>>(qt, kt, vt, gt, m, l, delta, static_cast<T*>(dk),
                                                                     static_cast<T*>(dv), L, H, scale, mask);
  return cudaGetLastError();
}

}  // namespace flash_bwd

}  // namespace azula
