// Helpers shared by the kernels: conversion between the storage type and
// float32, vector loads and stores of N consecutive elements, and the
// flash-attention tile step of the two attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

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

// The flash-attention forward shared by attention_fwd.cu, fused_msa.cu and
// flash_blhd_fwd.cu, and the tile products of flash_blhd_bwd.cu.
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
// runs over d in order, one FMA at a time, so every caller gets the same
// float32 score from the same rows.
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
template <typename T, int D, bool kRoundWeights, bool kMaxFree = false>
__device__ __forceinline__ void attend_tile(const Tiles<D>& s, float (&acc)[4][D / 16], int k0, int L, float scale) {
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
      const int j = tx + 16 * b;
      s.S[(ty + 16 * a) * LS + j] = (k0 + j < L) ? sc[a][b] * scale : -INFINITY;
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
      row[jj] = kRoundWeights ? round_to<T>(p) : p;
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

}  // namespace azula
