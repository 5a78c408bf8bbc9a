// Flash-attention forward: o = softmax(q k^T * scale) v on (B, H, L, D).
//
// Replaces: azula_tpu/ops/attention.py, _pallas_attention (512 <= L <= 2048)
// and _pallas_attention_batched (L <= 512), in their unmasked inference form:
// no bias, no dropout, no log-sum-exp output. Any L is taken; D is 32, 64 or
// 128. Inputs and output are bf16 or float32.
//
// Bound on the H100: a (b, h) pair does 4 L^2 D operations on 8 L D bytes
// (bf16), L / 2 operations per byte. At ADM's L = 1024 that is above the
// ~295 where even the bf16 tensor cores would limit, and this kernel runs its
// products on the float32 CUDA cores (67 TFLOP/s, ~20 operations per byte),
// so it is bound by operations at every main-path length (L = 64, 256, 1024).
//
// Design: the TPU kernel kept a pair's whole K and V resident in VMEM and
// ran one softmax over it. A block here has at most 227 KB of shared memory,
// so K and V are streamed instead: one block of 256 threads per (b * h,
// 64-query tile) walks 64-key tiles of K and V through shared memory (as
// float32, rows padded to keep vector reads free of bank conflicts) and
// keeps an online softmax in float32: a running row max, a running
// denominator and a float32 (64, D) accumulator in registers, rescaled when
// the max grows and divided once at the end. Each thread computes a 4 x 4
// block of scores and a 4 x (D / 16) block of the output. Keys and queries
// past L are masked in the ragged last tile, so no length gate is needed.
// The products use plain FMA; tensor cores (mma.sync / wgmma) and TMA are
// later work.
#include "common.cuh"

namespace {

using azula::from_float;
using azula::load;

constexpr int kThreads = 256;
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per shared-memory tile
constexpr int LS = BK + 4;   // row stride of the score tile

template <int D>
constexpr int smem_bytes() {
  // Q, K, V tiles; score tile; running max, denominator and rescale factor
  return (3 * 64 * (D + 4) + BQ * LS + 3 * BQ) * static_cast<int>(sizeof(float));
}

// Rows [row0, row0 + 64) of a contiguous (L, D) matrix into shared memory as
// float32 with row stride D + 4, zero past row L.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst, int row0, int L) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < 64 * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int cv = idx % PER_ROW;
    float v[VEC];
    if (row0 + r < L) {
      load<T, VEC>(src + static_cast<size_t>(row0 + r) * D + cv * VEC, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * (D + 4) + cv * VEC);
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int L, float scale) {
  constexpr int LD = D + 4;
  constexpr int DC = D / 16;  // output columns per thread

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ss = Vs + BK * LD;
  float* m_s = Ss + BQ * LS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const size_t base = static_cast<size_t>(blockIdx.y) * L * D;
  const int q0 = blockIdx.x * BQ;
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;

  load_tile<T, D>(q + base, Qs, q0, L);
  if (t < BQ) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k + base, Ks, k0, L);
    load_tile<T, D>(v + base, Vs, k0, L);
    __syncthreads();

    // scores of query rows ty + 16 a against keys tx + 16 b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;

#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * a) * LD + d);
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * b) * LD + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float acc_s = s[a][b];
          acc_s = fmaf(qa[a].x, kb[b].x, acc_s);
          acc_s = fmaf(qa[a].y, kb[b].y, acc_s);
          acc_s = fmaf(qa[a].z, kb[b].z, acc_s);
          acc_s = fmaf(qa[a].w, kb[b].w, acc_s);
          s[a][b] = acc_s;
        }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tx + 16 * b;
        Ss[(ty + 16 * a) * LS + j] = (k0 + j < L) ? s[a][b] * scale : -INFINITY;
      }
    __syncthreads();

    // online softmax: four threads per row, sixteen keys each
    {
      const int i = t / 4;
      const int part = t % 4;
      float* row = Ss + i * LS + part * 16;

      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) mx = fmaxf(mx, row[jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));

      // every tile holds at least one key < L, so m_new is finite
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);

      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const float p = expf(row[jj] - m_new);
        row[jj] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);

      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for rows ty + 16 a, columns tx * DC + c
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float alpha = a_s[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }

    for (int j = 0; j < BK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) p4[a] = *reinterpret_cast<const float4*>(Ss + (ty + 16 * a) * LS + j);

#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DC];
        const float* vrow = Vs + (j + jj) * LD + tx * DC;
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

  // l_s was last written before the final tile's second barrier
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    if (q0 + i < L) {
      const float l = l_s[i];
      T* dst = o + base + static_cast<size_t>(q0 + i) * D + tx * DC;
#pragma unroll
      for (int c = 0; c < DC; ++c) dst[c] = from_float<T>(acc[a][c] / l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int L, float scale,
                   cudaStream_t s) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }

  const dim3 grid((L + BQ - 1) / BQ, BH);
  attention_fwd_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), L, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int BH, int L, int D,
                     float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, BH, L, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, BH, L, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, BH, L, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (BH, L, D) contiguous, dtype 0 = float32, 1 = bfloat16;
// D in {32, 64, 128}; BH <= 65535. Returns cudaGetLastError().
extern "C" int azula_attention_fwd(const void* q, const void* k, const void* v, void* o, int BH,
                                   int L, int D, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == azula::kBFloat16) return dispatch<__nv_bfloat16>(q, k, v, o, BH, L, D, scale, s);
  if (dtype == azula::kFloat32) return dispatch<float>(q, k, v, o, BH, L, D, scale, s);
  return cudaErrorInvalidValue;
}
