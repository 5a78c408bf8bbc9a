// Per-(batch, group) float32 mean and variance of a channels-last tensor.
//
// Replaces: azula_tpu/ops/norm.py:281 (_stats_pallas). It computes what the
// TPU kernel computes for x (B, HW, C) in bf16 or float32: per row tile and
// channel, the mean and the centered sum of squares (M2); the tiles and then
// the channels of each group combined by Chan et al.'s formula into
// per-group float32 (mean, var), var = M2 / n. Two departures, both the same
// function: the TPU kernel's tiles divide HW and its fold averages the tile
// means (`jnp.mean`); here the last tile may be short, and the fold weights
// every tile by its row count. And every moment is taken of x - K, K the
// pilot row x[b, 0, :] (as in `_stats_pilot` and group_norm.cu), so the tile
// means are O(std) and the fold stays exact when |mean| >> std, where
// averaging raw tile means of order |mean| would round at ulp(|mean|).
//
// Bound on the H100: memory. One read of x (2 or 4 bytes an element) against
// about eight float32 operations, far below the ~20 operations per byte at
// which float32 compute would limit; the partials are 8 bytes per channel
// per tile of at least 8 KiB of x.
//
// Design: the TPU grid ran (B, tiles) and left the fold to XLA. Here two
// launches, as group_norm.cu's statistics:
//   1. partial: grid (tiles, B); threads run along C with 16-byte vector
//      loads, TY threads along the rows. Each thread keeps a running
//      (Welford) mean and M2 of x - K over its rows, one division per row;
//      the TY threads of a channel are combined through shared memory by
//      Chan's formula, and the tile's (mean, M2) written to (B, tiles, 2, C).
//   2. fold: grid (G, B); each block combines its group's tiles per channel,
//      then the channels about the group's first pilot, and writes
//      (mean, var) to (2, B, G).
#include "common.cuh"

namespace {

using azula::load;

constexpr int kThreads = 256;

// (n, mean, M2) += (nb, mb, M2b), Chan et al.'s pairwise update
__device__ __forceinline__ void chan(float& n, float& m, float& M2, float nb, float mb, float M2b) {
  if (nb == 0.f) return;
  const float total = n + nb;
  const float delta = mb - m;
  const float w = nb / total;
  m += delta * w;
  M2 += M2b + delta * delta * n * w;
  n = total;
}

// rows r0 + ty, r0 + ty + TY, ... below r1
__device__ __forceinline__ float rows_of(int r0, int r1, int ty, int TY) {
  return r1 - r0 > ty ? static_cast<float>((r1 - r0 - ty + TY - 1) / TY) : 0.f;
}

template <typename T, int VEC>
__device__ __forceinline__ void welford(const T* xc, const float (&k)[VEC], int r0, int r1, int step, int C,
                                        float (&mean)[VEC], float (&m2)[VEC]) {
  float n = 0.f;
#pragma unroll 4
  for (int r = r0; r < r1; r += step) {
    float v[VEC];
    load<T, VEC>(xc + static_cast<size_t>(r) * C, v);
    n += 1.f;
    const float inv = 1.f / n;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float y = v[i] - k[i];
      const float d = y - mean[i];
      mean[i] += d * inv;
      m2[i] += d * (y - mean[i]);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gs_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int HW, int C, int rows) {
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
  float* mo = partial + (static_cast<size_t>(b) * nblk + j) * 2 * C;
  float* m2o = mo + C;

  if (TY == 1) {
    // wide rows: each thread walks its vectors of C over every row of the tile
    for (int cv = tx; cv < nv; cv += nvx) {
      float k[VEC], mean[VEC] = {}, m2[VEC] = {};
      load<T, VEC>(xb + cv * VEC, k);
      welford<T, VEC>(xb + cv * VEC, k, r0, r1, 1, C, mean, m2);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        mo[cv * VEC + i] = mean[i];
        m2o[cv * VEC + i] = m2[i];
      }
    }
    return;
  }

  // narrow rows: TY threads share a vector of C, then combine through shared
  // memory (TY * C = TY * nv * VEC <= kThreads * 8 floats for each moment)
  __shared__ float sm[2 * kThreads * 8];
  if (ty < TY) {
    float k[VEC], mean[VEC] = {}, m2[VEC] = {};
    load<T, VEC>(xb + tx * VEC, k);
    welford<T, VEC>(xb + tx * VEC, k, r0 + ty, r1, TY, C, mean, m2);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sm[ty * C + tx * VEC + i] = mean[i];
      sm[(TY + ty) * C + tx * VEC + i] = m2[i];
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < C; c += kThreads) {
    float n = 0.f, m = 0.f, M2 = 0.f;
    for (int y = 0; y < TY; ++y) {
      chan(n, m, M2, rows_of(r0, r1, y, TY), sm[y * C + c], sm[(TY + y) * C + c]);
    }
    mo[c] = m;
    m2o[c] = M2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gs_fold_kernel(const T* __restrict__ x, const float* __restrict__ partial, float* __restrict__ out,
               int HW, int C, int G, int nblk, int rows) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  const int cpg = C / G;                     // channels per group, <= kThreads
  const int TY = kThreads / cpg;
  const int tx = threadIdx.x % cpg;
  const int ty = threadIdx.x / cpg;
  const int c = g * cpg + tx;

  __shared__ float sn[kThreads], sm[kThreads], sq[kThreads];
  __shared__ float e_s[kThreads], q_s[kThreads];

  // tiles ty, ty + TY, ... of channel c
  float n = 0.f, m = 0.f, M2 = 0.f;
  if (ty < TY) {
    for (int j = ty; j < nblk; j += TY) {
      const float* tile = partial + (static_cast<size_t>(b) * nblk + j) * 2 * C;
      chan(n, m, M2, static_cast<float>(min(rows, HW - j * rows)), tile[c], tile[C + c]);
    }
  }
  sn[threadIdx.x] = n;
  sm[threadIdx.x] = m;
  sq[threadIdx.x] = M2;
  __syncthreads();

  if (threadIdx.x < cpg) {
    for (int y = 1; y < TY; ++y) {
      const int i = y * cpg + threadIdx.x;
      chan(n, m, M2, sn[i], sm[i], sq[i]);
    }
    // the channel's mean of x - K_c, moved to the group's first pilot
    const size_t row0 = static_cast<size_t>(b) * HW * C;
    const float kref = azula::to_float(x[row0 + g * cpg]);
    e_s[threadIdx.x] = (azula::to_float(x[row0 + c]) - kref) + m;
    q_s[threadIdx.x] = M2;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const float hw = static_cast<float>(HW);
    float sum = 0.f;
    for (int i = 0; i < cpg; ++i) sum += e_s[i];
    const float dm = sum / static_cast<float>(cpg);  // group mean - kref

    float m2 = 0.f, dev = 0.f;
    for (int i = 0; i < cpg; ++i) {
      const float e = e_s[i] - dm;
      m2 += q_s[i];
      dev += e * e;
    }
    const size_t bg = static_cast<size_t>(b) * G + g;
    out[bg] = azula::to_float(x[static_cast<size_t>(b) * HW * C + g * cpg]) + dm;
    out[static_cast<size_t>(B) * G + bg] = fmaxf((m2 + hw * dev) / (hw * static_cast<float>(cpg)), 0.f);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* partial, void* out, int B, int HW, int C, int G, int rows, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const int nblk = (HW + rows - 1) / rows;

  gs_partial_kernel<T, VEC><<<dim3(nblk, B), kThreads, 0, s>>>(xt, static_cast<float*>(partial), HW, C, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  gs_fold_kernel<T><<<dim3(G, B), kThreads, 0, s>>>(
      xt, static_cast<const float*>(partial), static_cast<float*>(out), HW, C, G, nblk, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* partial, void* out, int B, int HW, int C, int G, int rows, cudaStream_t s) {
  // widest vector of at most 16 bytes that divides C
  constexpr int kMax = 16 / sizeof(T);
  if (C % kMax == 0) return launch<T, kMax>(x, partial, out, B, HW, C, G, rows, s);
  if (C % 4 == 0) return launch<T, 4>(x, partial, out, B, HW, C, G, rows, s);
  if (C % 2 == 0) return launch<T, 2>(x, partial, out, B, HW, C, G, rows, s);
  return launch<T, 1>(x, partial, out, B, HW, C, G, rows, s);
}

}  // namespace

// x: (B, HW, C) contiguous, dtype 0 = float32, 1 = bfloat16. partial:
// (B, ceil(HW / rows), 2, C) float32 scratch; out: (2, B, G) float32, the
// means then the variances. C % G == 0 and C / G <= 256. Returns
// cudaGetLastError().
extern "C" int azula_group_stats(const void* x, void* partial, void* out, int B, int HW, int C, int G, int rows,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == azula::kBFloat16) return dispatch<__nv_bfloat16>(x, partial, out, B, HW, C, G, rows, s);
  if (dtype == azula::kFloat32) return dispatch<float>(x, partial, out, B, HW, C, G, rows, s);
  return cudaErrorInvalidValue;
}
