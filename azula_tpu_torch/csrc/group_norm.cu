// Fused GroupNorm (+ per-batch modulation) (+ SiLU) forward, channels-last.
//
// Replaces: azula_tpu/ops/norm.py, _gn_fused_tpu (Pallas). It computes
//     y = silu?((x - mean) * A + Q),  A = P / sqrt(var + eps)
// (the TPU kernel's x * A + B with B = Q - mean * A, in a form whose float32
// rounding stays at the scale of y rather than of x)
// for x (B, HW, C) in bf16 or float32 and P, Q (B, C) float32, with the
// per-(batch, group) statistics taken as shifted moments about a pilot row
// K[b, c] = x[b, 0, c], exactly as the TPU kernel does. The shift keeps every
// term O(n * var), so the statistics stay exact when |mean| >> std; the raw
// E[x^2] - E[x]^2 fold is never formed. All arithmetic is float32; x and y
// stay in x's dtype.
//
// Bound on the H100: memory. About ten float32 operations per element meet
// 2-4 bytes of traffic, far below the ~20 operations per byte where float32
// compute would limit. The least traffic is one read of x and one write of
// y; the shifted statistics need x read twice (2R + 1W), as on the TPU.
//
// Design: the TPU kernel carried its sums along a sequential grid. Blocks on
// the card run in no order, so the work is split into three launches:
//   1. partial: grid (row tiles, B); threads run along C with 16-byte vector
//      loads, so a warp reads whole rows. Each block writes float32 sums of
//      d = x - K and d^2 for its rows, per channel, to (B, tiles, 2, C).
//      One shift per (b, c) makes the block partials simply add.
//   2. fold: grid (G, B); each block sums its group's partials over tiles,
//      forms mean and var, and writes A and the mean per channel (B, 2, C).
//   3. apply: y = silu?((x - mean) * A + Q) over the same tiles as launch 1.
// The partials are small (a tile covers at least 32 KiB of x).
#include "common.cuh"

namespace {

using azula::load;
using azula::store;
using azula::to_float;

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int HW, int C, int rows) {
  const int b = blockIdx.y;
  const int j = blockIdx.x;
  const int nblk = gridDim.x;
  const int nv = C / VEC;                    // vectors per row
  const int nvx = min(nv, kThreads);         // threads along C
  const int TY = kThreads / nvx;             // threads along rows
  const int tx = threadIdx.x % nvx;
  const int ty = threadIdx.x / nvx;
  const int r0 = j * rows;
  const int r1 = min(r0 + rows, HW);

  const T* xb = x + static_cast<size_t>(b) * HW * C;
  float* s1 = partial + (static_cast<size_t>(b) * nblk + j) * 2 * C;
  float* s2 = s1 + C;

  if (TY == 1) {
    // wide rows: each thread walks its vectors of C over every row of the tile
    if (ty > 0) return;
    for (int cv = tx; cv < nv; cv += nvx) {
      float k[VEC], a1[VEC] = {}, a2[VEC] = {};
      load<T, VEC>(xb + cv * VEC, k);
#pragma unroll 4
      for (int r = r0; r < r1; ++r) {
        float v[VEC];
        load<T, VEC>(xb + static_cast<size_t>(r) * C + cv * VEC, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = v[i] - k[i];
          a1[i] += d;
          a2[i] += d * d;
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1[cv * VEC + i] = a1[i];
        s2[cv * VEC + i] = a2[i];
      }
    }
    return;
  }

  // narrow rows: TY threads share a vector of C, then sum through shared memory
  // (TY * C = TY * nv * VEC <= kThreads * 8 floats for each of the two sums)
  __shared__ float sm[2 * kThreads * 8];
  const bool active = ty < TY;
  float a1[VEC] = {}, a2[VEC] = {};

  if (active) {
    float k[VEC];
    load<T, VEC>(xb + tx * VEC, k);
#pragma unroll 4
    for (int r = r0 + ty; r < r1; r += TY) {
      float v[VEC];
      load<T, VEC>(xb + static_cast<size_t>(r) * C + tx * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[i] - k[i];
        a1[i] += d;
        a2[i] += d * d;
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sm[ty * C + tx * VEC + i] = a1[i];
      sm[(TY + ty) * C + tx * VEC + i] = a2[i];
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < C; c += kThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int y = 0; y < TY; ++y) {
      t1 += sm[y * C + c];
      t2 += sm[(TY + y) * C + c];
    }
    s1[c] = t1;
    s2[c] = t2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_fold_kernel(const T* __restrict__ x, const float* __restrict__ partial, const float* __restrict__ P,
               float* __restrict__ ab, int HW, int C, int G, int nblk, float eps) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int cpg = C / G;                     // channels per group, <= kThreads
  const int TY = kThreads / cpg;
  const int tx = threadIdx.x % cpg;
  const int ty = threadIdx.x / cpg;
  const int c = g * cpg + tx;

  __shared__ float r1[kThreads], r2[kThreads];
  __shared__ float k_s[kThreads], t1_s[kThreads], t2_s[kThreads];
  __shared__ float mean_s, inv_s;

  float t1 = 0.f, t2 = 0.f;
  if (ty < TY) {
    for (int j = ty; j < nblk; j += TY) {
      const float* row = partial + (static_cast<size_t>(b) * nblk + j) * 2 * C;
      t1 += row[c];
      t2 += row[C + c];
    }
  }
  r1[threadIdx.x] = t1;
  r2[threadIdx.x] = t2;
  __syncthreads();

  if (threadIdx.x < cpg) {
    float a = 0.f, s = 0.f;
    for (int y = 0; y < TY; ++y) {
      a += r1[y * cpg + threadIdx.x];
      s += r2[y * cpg + threadIdx.x];
    }
    t1_s[threadIdx.x] = a;
    t2_s[threadIdx.x] = s;
    k_s[threadIdx.x] = to_float(x[static_cast<size_t>(b) * HW * C + c]);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // _stats_pilot's recombination, taken about the group's first pilot so
    // that every sum is O(n * std) and the mean is rounded once, at the end
    const float hw = static_cast<float>(HW);
    const float n = hw * static_cast<float>(cpg);
    const float kref = k_s[0];
    float sum = 0.f;
    for (int i = 0; i < cpg; ++i) sum += t1_s[i] + hw * (k_s[i] - kref);
    const float dm = sum / n;  // mean - kref
    const float mean = kref + dm;

    float v2 = 0.f, v1 = 0.f, v0 = 0.f;
    for (int i = 0; i < cpg; ++i) {
      const float e = (k_s[i] - kref) - dm;  // K_c - mean
      v2 += t2_s[i];
      v1 += e * t1_s[i];
      v0 += e * e;
    }
    const float var = fmaxf((v2 + 2.f * v1 + hw * v0) / n, 0.f);

    mean_s = mean;
    inv_s = 1.f / sqrtf(var + eps);
  }
  __syncthreads();

  if (threadIdx.x < cpg) {
    ab[static_cast<size_t>(b) * 2 * C + c] = inv_s * P[static_cast<size_t>(b) * C + c];
    ab[(static_cast<size_t>(b) * 2 + 1) * C + c] = mean_s;
  }
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ ab, const float* __restrict__ Q,
                T* __restrict__ y, int HW, int C, int rows) {
  // the partial kernel's tiling: each thread keeps its channels' A, mean and
  // Q in registers and walks the rows of its tile
  const int b = blockIdx.y;
  const int nv = C / VEC;
  const int nvx = min(nv, kThreads);
  const int TY = kThreads / nvx;
  const int tx = threadIdx.x % nvx;
  const int ty = threadIdx.x / nvx;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, HW);
  if (ty >= TY) return;

  const size_t base = static_cast<size_t>(b) * HW * C;

  for (int cv = tx; cv < nv; cv += nvx) {
    float A[VEC], M[VEC], Qc[VEC];
    load<float, VEC>(ab + static_cast<size_t>(b) * 2 * C + cv * VEC, A);
    load<float, VEC>(ab + (static_cast<size_t>(b) * 2 + 1) * C + cv * VEC, M);
    load<float, VEC>(Q + static_cast<size_t>(b) * C + cv * VEC, Qc);

#pragma unroll 4
    for (int r = r0 + ty; r < r1; r += TY) {
      const size_t off = base + static_cast<size_t>(r) * C + cv * VEC;
      float v[VEC];
      load<T, VEC>(x + off, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float t = (v[k] - M[k]) * A[k] + Qc[k];
        if (SILU) t = t * (1.f / (1.f + expf(-t)));
        v[k] = t;
      }
      store<T, VEC>(y + off, v);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* P, const void* Q, void* y, void* partial, void* ab,
                   int B, int HW, int C, int G, int rows, float eps, bool silu, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const int nblk = (HW + rows - 1) / rows;

  gn_partial_kernel<T, VEC><<<dim3(nblk, B), kThreads, 0, s>>>(
      xt, static_cast<float*>(partial), HW, C, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  gn_fold_kernel<T><<<dim3(G, B), kThreads, 0, s>>>(
      xt, static_cast<const float*>(partial), static_cast<const float*>(P),
      static_cast<float*>(ab), HW, C, G, nblk, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const float* abf = static_cast<const float*>(ab);
  const float* Qf = static_cast<const float*>(Q);
  T* yt = static_cast<T*>(y);
  if (silu) {
    gn_apply_kernel<T, VEC, true><<<dim3(nblk, B), kThreads, 0, s>>>(xt, abf, Qf, yt, HW, C, rows);
  } else {
    gn_apply_kernel<T, VEC, false><<<dim3(nblk, B), kThreads, 0, s>>>(xt, abf, Qf, yt, HW, C, rows);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* P, const void* Q, void* y, void* partial, void* ab,
                     int B, int HW, int C, int G, int rows, float eps, bool silu, cudaStream_t s) {
  // widest vector of at most 16 bytes that divides C
  constexpr int kMax = 16 / sizeof(T);
  if (C % kMax == 0) return launch<T, kMax>(x, P, Q, y, partial, ab, B, HW, C, G, rows, eps, silu, s);
  if (C % 4 == 0) return launch<T, 4>(x, P, Q, y, partial, ab, B, HW, C, G, rows, eps, silu, s);
  if (C % 2 == 0) return launch<T, 2>(x, P, Q, y, partial, ab, B, HW, C, G, rows, eps, silu, s);
  return launch<T, 1>(x, P, Q, y, partial, ab, B, HW, C, G, rows, eps, silu, s);
}

}  // namespace

// x, y: (B, HW, C) contiguous, dtype 0 = float32, 1 = bfloat16. P, Q: (B, C)
// float32. partial: (B, ceil(HW / rows), 2, C) float32 scratch; ab: (B, 2, C)
// float32 scratch. C % G == 0 and C / G <= 256. Returns cudaGetLastError().
extern "C" int azula_group_norm(const void* x, const void* P, const void* Q, void* y,
                                void* partial, void* ab, int B, int HW, int C, int G, int rows,
                                float eps, int silu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == azula::kBFloat16) {
    return dispatch<__nv_bfloat16>(x, P, Q, y, partial, ab, B, HW, C, G, rows, eps, silu != 0, s);
  }
  if (dtype == azula::kFloat32) {
    return dispatch<float>(x, P, Q, y, partial, ab, B, HW, C, G, rows, eps, silu != 0, s);
  }
  return cudaErrorInvalidValue;
}
