// Flash-attention backward on the projection layout: dq, dk, dv of
// o = softmax(q k^T * scale) v per head, given the cotangent g of o.
//
// Replaces: azula_tpu/ops/attention.py:836 (_flash_blhd_bwd, whose Pallas body
// is _flash_blhd_bwd_kernel at :748). q, k, v, o, g, dq, dk and dv are
// (B, L, C) with C = H D and head h at columns h D; m and l are the float32
// (B, H, L) row max and denominator that flash_blhd_fwd.cu wrote. Inputs and
// outputs are bf16 or float32; D is 64, 128, 192 or 256; any L is taken. The
// arithmetic is the JAX body's, with its rounding points:
//
//   p     = exp(s - m) / l                 float32, s = (q k^T) * scale
//   dp    = g v^T                          float32
//   delta = sum over d of g * o            float32, of the stored (rounded) o and g
//   ds    = T(p * (dp - delta) * scale)    rounded to the input dtype T
//   dq    = T(ds k), dk = T(ds^T q), dv = T(T(p)^T g), each summed in float32
//
// The JAX body rebuilds m and l from the scores; here they come from the
// forward, whose online softmax summed the same exp-weights in another order.
//
// Bound on the H100: a (b, h) pair reads 5 L D and writes 3 L D elements and
// does 10 L^2 D operations (the JAX cost estimate), 5 L / 8 operations per
// byte in bf16; at dit32's L = 256 that is 160, below the ~295 of the bf16
// tensor cores, so the ideal kernel is bound by bytes (0.060 ms per call at
// B = 128, H = 6, D = 64). These kernels run their products on the float32
// CUDA cores and recompute the scores and dp twice (14 L^2 D operations), so
// they are bound by operations.
//
// Design: the TPU body held a whole (L, L) float32 tile per head in VMEM; at
// L = 256 that is 256 KB, more than the 227 KB of shared memory a block may
// use. The work is split in two kernels instead (the FlashAttention-2 split),
// launched in order on one stream, and no block writes another's output, so
// no atomics are needed and the result does not depend on the order in which
// blocks run:
//
// 1. dq: one block per (b, h, query tile). It keeps the Q and G tiles in
//    shared memory, computes each row's delta from o and g (and writes it to a
//    float32 (B, H, L) scratch), then streams 64-key tiles of K and V: the
//    scores and dp by the common.cuh tile product, p rebuilt exactly from the
//    saved (m, l), ds rounded to T in a shared tile, dq += ds K in registers.
// 2. dk, dv: one block per (b, h, 64-key tile). It keeps K and V, streams the
//    query tiles of Q and G with their (m, l, delta), rebuilds p and ds the
//    same way, and accumulates dk += ds^T Q and dv += T(p)^T G in registers.
//
// Tiles live in shared memory as float32, rows padded by 4 floats. A query
// tile has 64 rows for D <= 128 and 32 rows above, so that the four tiles
// fit (217,472 bytes at D = 256). Tensor cores, TMA and a single-pass dq by
// atomics are later work.
#include "common.cuh"

namespace {

namespace flash = azula::flash;

using azula::from_float;
using azula::round_to;
using azula::to_float;

constexpr int kThreads = flash::kThreads;
constexpr int BK = 64;      // keys per tile
constexpr int LS = BK + 4;  // row stride of the p and ds tiles

// A block's shared memory: the query-side tiles Q and G (BQ rows), the
// key-side tiles K and V (BK rows), the rounded p and ds tiles, and each
// query row's max, denominator and delta.
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

// p and ds of the (BQ, 64) tile of query rows q0 + i and keys k0 + j, once
// Q, G, K, V and the rows' (m, l, delta) are in shared memory: p and ds of
// thread (tx, ty) at rows ty + 16 a and keys tx + 16 b. Rows or keys past L
// get p = ds = 0.
template <typename T, int D>
__device__ __forceinline__ void p_and_ds(const Tiles<D>& s, int q0, int k0, int L, float scale,
                                         float (&p)[Tiles<D>::RA][4], float (&ds)[Tiles<D>::RA][4]) {
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
        // the score rounded as the forward stored it, then exp(s - m) / l
        const float e = expf(__fmul_rn(sc[a][b], scale) - s.m[i]);
        p[a][b] = e / s.l[i];
        ds[a][b] = round_to<T>(__fmul_rn(__fmul_rn(p[a][b], dp[a][b] - s.delta[i]), scale));
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_blhd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ o, const T* __restrict__ g, const float* __restrict__ m,
                     const float* __restrict__ l, T* __restrict__ dq, float* __restrict__ delta, int L, int H,
                     float scale) {
  using S = Tiles<D>;
  constexpr int BQ = S::BQ;
  constexpr int RA = S::RA;
  constexpr int DC = D / 16;
  constexpr int LD = S::LD;

  extern __shared__ float4 smem4[];
  const S s(reinterpret_cast<float*>(smem4));

  const int C = H * D;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t base = static_cast<size_t>(b) * L * C + h * D;
  const size_t rows = static_cast<size_t>(blockIdx.y) * L;  // this pair's (m, l, delta)
  const int q0 = blockIdx.x * BQ;
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
      s.m[r] = valid ? m[rows + q0 + r] : 0.f;
      s.l[r] = valid ? l[rows + q0 + r] : 1.f;
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
    p_and_ds<T, D>(s, q0, k0, L, scale, p, ds);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_blhd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int L, int H,
                      float scale) {
  using S = Tiles<D>;
  constexpr int BQ = S::BQ;
  constexpr int RA = S::RA;
  constexpr int DC = D / 16;

  extern __shared__ float4 smem4[];
  const S s(reinterpret_cast<float*>(smem4));

  const int C = H * D;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t base = static_cast<size_t>(b) * L * C + h * D;
  const size_t rows = static_cast<size_t>(blockIdx.y) * L;
  const int k0 = blockIdx.x * BK;
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
      s.m[r] = valid ? m[rows + q0 + r] : 0.f;
      s.l[r] = valid ? l[rows + q0 + r] : 1.f;
      s.delta[r] = valid ? delta[rows + q0 + r] : 0.f;
    }
    __syncthreads();

    float p[RA][4], ds[RA][4];
    p_and_ds<T, D>(s, q0, k0, L, scale, p, ds);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* g, const float* m,
                   const float* l, void* dq, void* dk, void* dv, float* delta, int B, int L, int H, float scale,
                   cudaStream_t s) {
  using S = Tiles<D>;
  constexpr int bytes = S::kBytes;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);

  // the limit is an attribute of the device's copy of each kernel, so it is
  // set on every launch: the current device may differ from the last one
  cudaError_t e = cudaFuncSetAttribute(flash_blhd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_blhd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;

  // dq first: it writes the deltas that the dk, dv kernel reads
  const dim3 grid_q((L + S::BQ - 1) / S::BQ, B * H);
  flash_blhd_dq_kernel<T, D><<<grid_q, kThreads, bytes, s>>>(
      qt, kt, vt, static_cast<const T*>(o), gt, m, l, static_cast<T*>(dq), delta, L, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const dim3 grid_k((L + BK - 1) / BK, B * H);
  flash_blhd_dkv_kernel<T, D><<<grid_k, kThreads, bytes, s>>>(
      qt, kt, vt, gt, m, l, delta, static_cast<T*>(dk), static_cast<T*>(dv), L, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* g, const float* m,
                     const float* l, void* dq, void* dk, void* dv, float* delta, int B, int L, int H, int D,
                     float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, g, m, l, dq, dk, dv, delta, B, L, H, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, g, m, l, dq, dk, dv, delta, B, L, H, scale, s);
    case 192: return launch<T, 192>(q, k, v, o, g, m, l, dq, dk, dv, delta, B, L, H, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, g, m, l, dq, dk, dv, delta, B, L, H, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, g, dq, dk, dv: (B, L, H D) contiguous; m, l: float32 (B, H, L)
// from azula_flash_blhd_fwd; delta: float32 (B, H, L) scratch; dtype 0 =
// float32, 1 = bfloat16; D in {64, 128, 192, 256}; B * H <= 65535. Launches
// two kernels on `stream`. Returns cudaGetLastError().
extern "C" int azula_flash_blhd_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
                                    const void* m, const void* l, void* dq, void* dk, void* dv, void* delta, int B,
                                    int L, int H, int D, float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || B * H > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* df = static_cast<float*>(delta);
  if (dtype == azula::kBFloat16) {
    return dispatch<__nv_bfloat16>(q, k, v, o, g, mf, lf, dq, dk, dv, df, B, L, H, D, scale, s);
  }
  if (dtype == azula::kFloat32) return dispatch<float>(q, k, v, o, g, mf, lf, dq, dk, dv, df, B, L, H, D, scale, s);
  return cudaErrorInvalidValue;
}
