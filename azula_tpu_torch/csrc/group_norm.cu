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
// y (1R + 1W).
//
// Design: one launch of thread-block clusters (group_stats.cuh). The N
// blocks of a cluster take one (batch row, band of whole groups) and split
// its rows. Each block sums d = x - K and d^2 per channel over its rows,
// copying them into shared memory by cp.async and keeping as many as its
// shared memory holds; the cluster folds the blocks' sums over distributed
// shared memory into the band's group statistics, every block the same
// bits; then each block writes y for its own rows, the kept ones from
// shared memory, the others streamed in again (last read first, under an
// L2 policy that keeps them, while y is stored under one that drops it).
// Where a block's rows all fit, x is read from device memory exactly once.
// The TPU kernel carried its sums along a sequential grid; the first port
// split that into three launches with partials in device memory, which
// this design has none of.
//
// A group wider than a band (C / G > Cb, as in the single-group norms of
// v-diffusion's 1024- and 2048-channel levels) stays one launch: its span
// bands' blocks make one cluster (at most 16 blocks, span * nr), each block
// folds every channel of the group over its band's nr blocks, then the
// whole block folds the group's channels, the same bits in every block of
// the cluster; the group's pilot is the one value x[b, 0, first channel of
// the group] in every band.
#include "group_stats.cuh"

namespace {

using namespace azula::gstats;
using azula::Pack;
using azula::load;

// group_norm's moments of one channel: the sums of d and d^2
struct Sums {
  float s1, s2;

  __device__ __forceinline__ void add(const Sums& o) {
    s1 += o.s1;
    s2 += o.s2;
  }

  __device__ __forceinline__ Sums shfl_xor(int m) const {
    return {__shfl_xor_sync(0xffffffffu, s1, m), __shfl_xor_sync(0xffffffffu, s2, m)};
  }
};

// the float32 values of the fold: t1, t2 per channel of the band (of the
// group where it spans bands), A, M, Q per channel of the band, a group's
// mean and 1/std per channel of the band; where the group spans bands, its
// pilot row and the scratch of the block's sums
__host__ __device__ constexpr int fold_floats(int Cb, int span) {
  return span > 1 ? 3 * span * Cb + 5 * Cb + 3 * kWarps : 7 * Cb;
}

// dynamic shared memory: the resident rows, the scratch, the published
// sums, the pilot row
template <typename T>
int shared_bytes(int Cb, int span, int resident, int vec) {
  return align16(resident * Cb * static_cast<int>(sizeof(T))) + scratch_bytes<Sums>(Cb, vec, fold_floats(Cb, span)) +
         align16(Cb * static_cast<int>(sizeof(Sums))) + align16(Cb * 4);
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kThreads, 2)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ P, const float* __restrict__ Q, T* __restrict__ y,
                  int HW, int C, int G, int Cb, int N, int rows, int resident, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cpg = C / G;
  const Unit u(cpg, Cb, N, rows, HW, static_cast<int>(cluster.block_rank()));
  const Lanes<VEC> L(Cb);
  // cp.async moves 4, 8 or 16 bytes: a band of odd bf16 channels goes
  // through registers, twice, and keeps nothing
  constexpr bool kAsync = VEC * sizeof(T) >= 4;
  // the rows kept in shared memory: all the block's where they fit; else two
  // slots of H rows (a multiple of TY), through which the others stream
  int Rs = kAsync ? min(resident, u.nrows) : 0;
  int H = Rs;
  if (Rs < u.nrows) {
    H = Rs / 2 - Rs / 2 % L.TY;
    Rs = 2 * H;
  }
  const int ns = Rs < u.nrows && kAsync ? (u.nrows - Rs + H - 1) / H : 0;  // chunks streamed
  auto streamed = [&](int j) { return make_int2(Rs + j * H, min(Rs + (j + 1) * H, u.nrows)); };

  T* stage = reinterpret_cast<T*>(smem);
  Sums* red = reinterpret_cast<Sums*>(smem + align16(resident * Cb * static_cast<int>(sizeof(T))));
  Sums* pub = reinterpret_cast<Sums*>(reinterpret_cast<unsigned char*>(red) +
                                      scratch_bytes<Sums>(Cb, VEC, fold_floats(Cb, u.span)));
  float* kp =  // the pilot row of the band
      reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(pub) + align16(Cb * static_cast<int>(sizeof(Sums))));

  const size_t row0 = static_cast<size_t>(u.b) * HW * C + u.c0;  // the pilot row of the band
  const T* xc = x + row0 + static_cast<size_t>(u.r0) * C + L.cv * VEC;
  T* yc = y + row0 + static_cast<size_t>(u.r0) * C + L.cv * VEC;
  T* sv = stage + L.cv * VEC;

  // 1. the block's sums of d = x - K per channel: the rows past Rs streamed
  // through the stage, then rows [0, Rs) copied in and kept (where all the
  // block's rows fit, one chunk)
  Sums acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = {0.f, 0.f};
  if (L.active) {
    float k[VEC];
    load<T, VEC>(x + row0 + L.cv * VEC, k);
    if (L.ty == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kp[L.cv * VEC + i] = k[i];
    }
    auto sum = [&](int, const Pack<T, VEC>& pk) {
      float v[VEC];
      unpack<T, VEC>(pk, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[i] - k[i];
        acc[i].s1 += d;
        acc[i].s2 += d * d;
      }
    };
    if constexpr (kAsync) {
      // the streamed chunks, then the kept ones, which land in slots 0, 1
      // (the streamed rows are read again after the fold: L2 keeps them)
      const uint64_t keep = l2_keep(), drop = l2_drop();
      stream_chunks<T, VEC>(
          xc, C, sv, Cb, L.ty, L.TY, H, ns + (ns ? 2 : 1), 0, ns & 1,
          [&](int i) { return i < ns ? streamed(i) : make_int2((i - ns) * H, (i - ns + 1) * H); },
          [&](int i) { return i < ns ? keep : drop; }, sum);
    } else {
      for_rows<T, VEC>(xc, C, L.ty, u.nrows, L.TY, sum);
    }
  }
  block_combine<Sums, VEC>(L, acc, red, pub, Cb);
  cluster.sync();

  // 2. the cluster's sums per channel, in rank order, then the group fold
  // (_stats_pilot's recombination about the group's first pilot, so that
  // every sum is O(n * std) and the mean is rounded once, at the end)
  const int F = u.span > 1 ? cpg : Cb;  // the channels folded: the band's, or the wide group's
  float* t1 = reinterpret_cast<float*>(red);  // t1, t2 per channel folded; A, M, Q per channel; mean, 1/std
  float* t2 = t1 + F;
  float* A = t2 + F;
  float* M = A + Cb;
  float* Qc = M + Cb;
  float* g_mean = Qc + Cb;
  float* g_inv = g_mean + Cb;
  float* kg = g_inv + Cb;  // a wide group's pilot row
  float* ws = kg + cpg;    // a wide group's block sums
  const size_t pilot = static_cast<size_t>(u.b) * HW * C + u.g0;
  for (int c = threadIdx.x; c < F; c += kThreads) {
    const int j = c / Cb;  // the band of channel c in the unit
    const Sums t = cluster_fold(cluster, pub, c - j * Cb, j * u.nr, u.nr);
    t1[c] = t.s1;
    t2[c] = t.s2;
    if (u.span > 1) kg[c] = azula::to_float(x[pilot + c]);
  }
  cluster_arrive();
  __syncthreads();

  const float hw = static_cast<float>(HW);
  const float n = hw * static_cast<float>(cpg);
  if (u.span == 1) {
    const int lane = threadIdx.x % 32;
    for (int g = threadIdx.x / 32; g < Cb / cpg; g += kWarps) {
      const int c0 = g * cpg;
      const float kref = kp[c0];
      float s = 0.f;
      for (int i = lane; i < cpg; i += 32) s += t1[c0 + i] + hw * (kp[c0 + i] - kref);
      const float dm = warp_sum(s) / n;  // mean - kref

      float v2 = 0.f, v1 = 0.f, v0 = 0.f;
      for (int i = lane; i < cpg; i += 32) {
        const float e = (kp[c0 + i] - kref) - dm;  // K_c - mean
        v2 += t2[c0 + i];
        v1 += e * t1[c0 + i];
        v0 += e * e;
      }
      const float var = fmaxf((warp_sum(v2) + 2.f * warp_sum(v1) + hw * warp_sum(v0)) / n, 0.f);
      if (lane == 0) {
        g_mean[g] = kref + dm;
        g_inv[g] = 1.f / sqrtf(var + eps);
      }
    }
  } else {
    // the wide group, folded by the whole block
    const float kref = kg[0];
    float s[1] = {0.f};
    for (int c = threadIdx.x; c < cpg; c += kThreads) s[0] += t1[c] + hw * (kg[c] - kref);
    block_sum<1>(s, ws);
    const float dm = s[0] / n;  // mean - kref

    float v[3] = {0.f, 0.f, 0.f};
    for (int c = threadIdx.x; c < cpg; c += kThreads) {
      const float e = (kg[c] - kref) - dm;  // K_c - mean
      v[0] += t2[c];
      v[1] += e * t1[c];
      v[2] += e * e;
    }
    block_sum<3>(v, ws);
    if (threadIdx.x == 0) {
      g_mean[0] = kref + dm;
      g_inv[0] = 1.f / sqrtf(fmaxf((v[0] + 2.f * v[1] + hw * v[2]) / n, 0.f) + eps);
    }
  }
  __syncthreads();

  const size_t pq = static_cast<size_t>(u.b) * C + u.c0;
  for (int c = threadIdx.x; c < Cb; c += kThreads) {
    const int g = u.span > 1 ? 0 : c / cpg;
    A[c] = g_inv[g] * P[pq + c];
    M[c] = g_mean[g];
    Qc[c] = Q[pq + c];
  }
  __syncthreads();

  // 3. y = silu?((x - M) A + Q) over the block's rows: the resident ones
  // from shared memory, then the others streamed again
  if (L.active) {
    float a[VEC], m[VEC], q[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      a[i] = A[L.cv * VEC + i];
      m[i] = M[L.cv * VEC + i];
      q[i] = Qc[L.cv * VEC + i];
    }
    const uint64_t drop = l2_drop();
    auto apply = [&](int l, const Pack<T, VEC>& pk) {
      float v[VEC];
      unpack<T, VEC>(pk, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float t = (v[i] - m[i]) * a[i] + q[i];
        if (SILU) t = __fdividef(t, 1.f + __expf(-t));
        v[i] = t;
      }
      store_hint<T, VEC>(yc + static_cast<size_t>(l) * C, v, drop);
    };
    if constexpr (kAsync) {
      // the kept chunks, then the others streamed into the slots they free,
      // the last read first (L2 holds the latest best)
      const int kept = ns ? 2 : 1;
      stream_chunks<T, VEC>(
          xc, C, sv, Cb, L.ty, L.TY, H, kept + ns, kept, 0,
          [&](int i) { return i < kept ? make_int2(i * H, (i + 1) * H) : streamed(ns - 1 - (i - kept)); },
          [&](int) { return drop; }, apply);
    } else {
      for_rows<T, VEC>(xc, C, L.ty, u.nrows, L.TY, apply);
    }
  }
  cluster_wait();
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* P, const void* Q, void* y, int B, int HW, int C, int G, int Cb, int N,
                   int rows, int resident, float eps, bool silu, cudaStream_t s) {
  const int span = span_of(C / G, Cb);
  const int smem = shared_bytes<T>(Cb, span, resident, VEC);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const float* Pf = static_cast<const float*>(P);
  const float* Qf = static_cast<const float*>(Q);
  T* yt = static_cast<T*>(y);
  const int units = C / Cb / span;
  if (silu) {
    return launch_clusters(group_norm_kernel<T, VEC, true>, units, N, B, smem, s, xt, Pf, Qf, yt, HW, C, G, Cb, N,
                           rows, resident, eps);
  }
  return launch_clusters(group_norm_kernel<T, VEC, false>, units, N, B, smem, s, xt, Pf, Qf, yt, HW, C, G, Cb, N,
                         rows, resident, eps);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* P, const void* Q, void* y, int B, int HW, int C, int G, int Cb, int N,
                     int rows, int resident, float eps, bool silu, cudaStream_t s) {
  switch (vector_of<T>(Cb)) {
    case 8:
      return launch<T, 16 / sizeof(T)>(x, P, Q, y, B, HW, C, G, Cb, N, rows, resident, eps, silu, s);
    case 4:
      return launch<T, 4>(x, P, Q, y, B, HW, C, G, Cb, N, rows, resident, eps, silu, s);
    case 2:
      return launch<T, 2>(x, P, Q, y, B, HW, C, G, Cb, N, rows, resident, eps, silu, s);
    default:
      return launch<T, 1>(x, P, Q, y, B, HW, C, G, Cb, N, rows, resident, eps, silu, s);
  }
}

}  // namespace

// x, y: (B, HW, C) contiguous, dtype 0 = float32, 1 = bfloat16, 16-byte
// aligned. P, Q: (B, C) float32. The plan: bands of `band` channels (whole
// groups, or 1 / span of a group of C / G = span * band channels), clusters
// of `cluster` blocks of `rows` rows each (span bands of cluster / span
// blocks where a group spans bands), the first `resident` rows of a block
// kept in shared memory. C % G == 0. Returns the launch's CUDA error.
extern "C" int azula_group_norm(const void* x, const void* P, const void* Q, void* y, int B, int HW, int C, int G,
                                int band, int cluster, int rows, int resident, float eps, int silu, int dtype,
                                void* stream) {
  if (!valid_plan(B, HW, C, G, band, cluster, rows) || resident > rows) return cudaErrorInvalidValue;
  const int vec = dtype == azula::kBFloat16 ? vector_of<__nv_bfloat16>(band) : vector_of<float>(band);
  const int ty_rows = 2 * kThreads / lanes_of(band, vec);  // rows of two passes of a block's threads
  if (resident < (rows < ty_rows ? rows : ty_rows)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == azula::kBFloat16) {
    return dispatch<__nv_bfloat16>(x, P, Q, y, B, HW, C, G, band, cluster, rows, resident, eps, silu != 0, s);
  }
  if (dtype == azula::kFloat32) {
    return dispatch<float>(x, P, Q, y, B, HW, C, G, band, cluster, rows, resident, eps, silu != 0, s);
  }
  return cudaErrorInvalidValue;
}

// The dynamic shared memory of a block of azula_group_norm with a band of
// `band` channels, groups of `span` bands (1 where a band holds whole
// groups) and `resident` rows, as the planner computes it.
extern "C" int azula_group_norm_shared_bytes(int band, int span, int resident, int dtype) {
  if (dtype == azula::kBFloat16) {
    return shared_bytes<__nv_bfloat16>(band, span, resident, vector_of<__nv_bfloat16>(band));
  }
  return shared_bytes<float>(band, span, resident, vector_of<float>(band));
}

// How many clusters of a plan of bands of whole groups the card holds at
// once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int azula_group_norm_active_clusters(int band, int cluster, int resident, int silu, int dtype) {
  auto query = [&](auto kernel, int smem) -> int {
    cudaError_t e = ensure_attributes(reinterpret_cast<const void*>(kernel), smem, cluster > 8);
    if (e != cudaSuccess) return -static_cast<int>(e);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int count = 0;
    e = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
    return e == cudaSuccess ? count : -static_cast<int>(e);
  };
  if (dtype == azula::kBFloat16) {
    using T = __nv_bfloat16;
    const int vec = vector_of<T>(band);
    const int smem = shared_bytes<T>(band, 1, resident, vec);
    // the bf16 form with the band's vector; registers differ little between forms
    if (vec == 8) {
      return silu ? query(group_norm_kernel<T, 8, true>, smem) : query(group_norm_kernel<T, 8, false>, smem);
    }
    return silu ? query(group_norm_kernel<T, 1, true>, smem) : query(group_norm_kernel<T, 1, false>, smem);
  }
  using T = float;
  const int smem = shared_bytes<T>(band, 1, resident, vector_of<T>(band));
  return silu ? query(group_norm_kernel<T, 4, true>, smem) : query(group_norm_kernel<T, 4, false>, smem);
}
