// Per-(batch, group) float32 mean and variance of a channels-last tensor.
//
// Replaces: azula_tpu/ops/norm.py:281 (_stats_pallas). It computes what the
// TPU kernel computes for x (B, HW, C) in bf16 or float32: per row tile and
// channel, the mean and the centered sum of squares (M2); the tiles and then
// the channels of each group combined by Chan et al.'s formula into
// per-group float32 (mean, var), var = M2 / n. Two departures, both the same
// function: the TPU kernel's tiles divide HW and its fold averages the tile
// means (`jnp.mean`); here the tiles are a cluster's blocks, the last maybe
// short, and the fold weights every tile by its row count. And every moment
// is taken of x - K, K the pilot row x[b, 0, :] (as in `_stats_pilot` and
// group_norm.cu), so the tile means are O(std) and the fold stays exact when
// |mean| >> std, where averaging raw tile means of order |mean| would round
// at ulp(|mean|).
//
// Bound on the H100: memory. One read of x (2 or 4 bytes an element) against
// about eight float32 operations, far below the ~20 operations per byte at
// which float32 compute would limit.
//
// Design: one launch of thread-block clusters (group_stats.cuh), with the
// plan of group_norm.cu at the same shape. The N blocks of a cluster split
// the rows of one (batch row, band of whole groups). Each thread keeps a
// running (Welford) mean and M2 of x - K over its rows, one division per
// row; the block's threads are combined by Chan's formula in a fixed order
// and published per channel in shared memory. The cluster's first block
// reads its peers' (mean, M2) over distributed shared memory, combines them
// in rank order, then the channels about the group's first pilot, and
// writes (mean, var) to (2, B, G). The TPU grid ran (B, tiles) and left the
// fold to XLA; the first port took two launches with the tiles' partials in
// device memory; here there is one launch and no partial leaves the chip.
// A group wider than a band takes one cluster of its span bands' blocks, as
// in group_norm.cu; the first block folds every channel of the group over
// its band's blocks, then the whole block folds the channels.
#include "group_stats.cuh"

namespace {

using namespace azula::gstats;
using azula::Pack;
using azula::load;

// a channel's running count, mean and centered sum of squares
struct Moments {
  float n, m, M2;

  // (n, m, M2) += (o.n, o.m, o.M2), Chan et al.'s pairwise update
  __device__ __forceinline__ void add(const Moments& o) {
    if (o.n == 0.f) return;
    const float total = n + o.n;
    const float delta = o.m - m;
    const float w = o.n / total;
    m += delta * w;
    M2 += o.M2 + delta * delta * n * w;
    n = total;
  }

  __device__ __forceinline__ Moments shfl_xor(int k) const {
    return {__shfl_xor_sync(0xffffffffu, n, k), __shfl_xor_sync(0xffffffffu, m, k),
            __shfl_xor_sync(0xffffffffu, M2, k)};
  }
};

// the float32 values of the fold: each channel's mean about the group's
// first pilot and its M2 (the group's channels where it spans bands, with
// the scratch of the block's sums)
__host__ __device__ constexpr int fold_floats(int Cb, int span) {
  return span > 1 ? 2 * span * Cb + 3 * kWarps : 2 * Cb;
}

// dynamic shared memory: the stage, the scratch, the published moments, the
// pilot row
template <typename T>
int shared_bytes(int Cb, int span, int stage, int vec) {
  return align16(stage * Cb * static_cast<int>(sizeof(T))) + scratch_bytes<Moments>(Cb, vec, fold_floats(Cb, span)) +
         align16(Cb * static_cast<int>(sizeof(Moments))) + align16(Cb * 4);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
group_stats_kernel(const T* __restrict__ x, float* __restrict__ out, int B, int HW, int C, int G, int Cb, int N,
                   int rows, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cpg = C / G;
  const Unit u(cpg, Cb, N, rows, HW, static_cast<int>(cluster.block_rank()));
  const Lanes<VEC> L(Cb);

  T* sv = reinterpret_cast<T*>(smem) + L.cv * VEC;
  Moments* red = reinterpret_cast<Moments*>(smem + align16(stage * Cb * static_cast<int>(sizeof(T))));
  Moments* pub = reinterpret_cast<Moments*>(reinterpret_cast<unsigned char*>(red) +
                                            scratch_bytes<Moments>(Cb, VEC, fold_floats(Cb, u.span)));
  float* kp =  // the pilot row of the band
      reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(pub) + align16(Cb * static_cast<int>(sizeof(Moments))));

  const size_t row0 = static_cast<size_t>(u.b) * HW * C + u.c0;  // the pilot row of the band

  // 1. each thread's running moments of x - K over its rows
  Moments acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = {0.f, 0.f, 0.f};
  if (L.active) {
    float k[VEC];
    load<T, VEC>(x + row0 + L.cv * VEC, k);
    if (L.ty == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kp[L.cv * VEC + i] = k[i];
    }
    float n = 0.f;
    const T* xc = x + row0 + static_cast<size_t>(u.r0) * C + L.cv * VEC;
    auto welford = [&](int, const Pack<T, VEC>& pk) {
      float v[VEC];
      unpack<T, VEC>(pk, v);
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float yv = v[i] - k[i];
        const float d = yv - acc[i].m;
        acc[i].m += d * inv;
        acc[i].M2 += d * (yv - acc[i].m);
      }
    };
    // the rows streamed through the stage (cp.async moves 4, 8 or 16 bytes:
    // odd bf16 bands go through registers)
    if constexpr (VEC * sizeof(T) >= 4) {
      // two slots of H rows, or one chunk where the stage holds the rows
      const int H = stage >= u.nrows ? u.nrows : stage / 2 - stage / 2 % L.TY;
      const uint64_t drop = l2_drop();
      stream_chunks<T, VEC>(
          xc, C, sv, Cb, L.ty, L.TY, H, (u.nrows + H - 1) / H, 0, 0,
          [&](int i) { return make_int2(i * H, min((i + 1) * H, u.nrows)); }, [&](int) { return drop; }, welford);
    } else {
      for_rows<T, VEC>(xc, C, L.ty, u.nrows, L.TY, welford);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i].n = n;
  }
  block_combine<Moments, VEC>(L, acc, red, pub, Cb);
  cluster.sync();

  // 2. the first block: the cluster's moments per channel in rank order (of
  // its band's blocks), each channel's mean of x - K_c moved to the group's
  // first pilot
  const int F = u.span > 1 ? cpg : Cb;  // the channels folded: the band's, or the wide group's
  float* e_c = reinterpret_cast<float*>(red);
  float* q_c = e_c + F;
  float* ws = q_c + F;  // a wide group's block sums
  const size_t pilot = static_cast<size_t>(u.b) * HW * C + u.g0;
  if (u.rank == 0) {
    for (int c = threadIdx.x; c < F; c += kThreads) {
      const int j = c / Cb;  // the band of channel c in the unit
      const Moments t = cluster_fold(cluster, pub, c - j * Cb, j * u.nr, u.nr);
      const float dk = u.span > 1 ? azula::to_float(x[pilot + c]) - azula::to_float(x[pilot])
                                  : kp[c] - kp[c / cpg * cpg];
      e_c[c] = dk + t.m;
      q_c[c] = t.M2;
    }
  }
  cluster_arrive();

  if (u.rank == 0 && u.span > 1) {
    // the wide group, folded by the whole block
    __syncthreads();
    const float hw = static_cast<float>(HW);
    float s[1] = {0.f};
    for (int c = threadIdx.x; c < cpg; c += kThreads) s[0] += e_c[c];
    block_sum<1>(s, ws);
    const float dm = s[0] / static_cast<float>(cpg);  // group mean - kref

    float v[2] = {0.f, 0.f};
    for (int c = threadIdx.x; c < cpg; c += kThreads) {
      const float e = e_c[c] - dm;
      v[0] += q_c[c];
      v[1] += e * e;
    }
    block_sum<2>(v, ws);
    if (threadIdx.x == 0) {
      const size_t bg = static_cast<size_t>(u.b) * G + u.g0 / cpg;
      out[bg] = azula::to_float(x[pilot]) + dm;
      out[static_cast<size_t>(B) * G + bg] = fmaxf((v[0] + hw * v[1]) / (hw * static_cast<float>(cpg)), 0.f);
    }
  } else if (u.rank == 0) {
    __syncthreads();
    const float hw = static_cast<float>(HW);
    const int lane = threadIdx.x % 32;
    for (int g = threadIdx.x / 32; g < Cb / cpg; g += kWarps) {
      const int c0 = g * cpg;
      float s = 0.f;
      for (int i = lane; i < cpg; i += 32) s += e_c[c0 + i];
      const float dm = warp_sum(s) / static_cast<float>(cpg);  // group mean - kref

      float m2 = 0.f, dev = 0.f;
      for (int i = lane; i < cpg; i += 32) {
        const float e = e_c[c0 + i] - dm;
        m2 += q_c[c0 + i];
        dev += e * e;
      }
      m2 = warp_sum(m2);
      dev = warp_sum(dev);
      if (lane == 0) {
        const size_t bg = static_cast<size_t>(u.b) * G + (u.c0 + c0) / cpg;
        out[bg] = kp[c0] + dm;
        out[static_cast<size_t>(B) * G + bg] = fmaxf((m2 + hw * dev) / (hw * static_cast<float>(cpg)), 0.f);
      }
    }
  }
  cluster_wait();
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* out, int B, int HW, int C, int G, int Cb, int N, int rows, int stage,
                   cudaStream_t s) {
  const int span = span_of(C / G, Cb);
  const int smem = shared_bytes<T>(Cb, span, stage, VEC);
  const int ty_rows = 2 * kThreads / lanes_of(Cb, VEC);  // rows of two passes of a block's threads
  if (smem > kMaxSharedBytes || stage < (rows < ty_rows ? rows : ty_rows)) {
    return cudaErrorInvalidValue;
  }
  return launch_clusters(group_stats_kernel<T, VEC>, C / Cb / span, N, B, smem, s, static_cast<const T*>(x),
                         static_cast<float*>(out), B, HW, C, G, Cb, N, rows, stage);
}

template <typename T>
cudaError_t dispatch(const void* x, void* out, int B, int HW, int C, int G, int Cb, int N, int rows, int stage,
                     cudaStream_t s) {
  switch (vector_of<T>(Cb)) {
    case 8:
      return launch<T, 16 / sizeof(T)>(x, out, B, HW, C, G, Cb, N, rows, stage, s);
    case 4:
      return launch<T, 4>(x, out, B, HW, C, G, Cb, N, rows, stage, s);
    case 2:
      return launch<T, 2>(x, out, B, HW, C, G, Cb, N, rows, stage, s);
    default:
      return launch<T, 1>(x, out, B, HW, C, G, Cb, N, rows, stage, s);
  }
}

}  // namespace

// x: (B, HW, C) contiguous, dtype 0 = float32, 1 = bfloat16, 16-byte
// aligned. out: (2, B, G) float32, the means then the variances. The plan
// (band, cluster, rows) as azula_group_norm's; `stage` rows of a block's
// shared memory take the copies. C % G == 0. Returns the launch's CUDA
// error.
extern "C" int azula_group_stats(const void* x, void* out, int B, int HW, int C, int G, int band, int cluster,
                                 int rows, int stage, int dtype, void* stream) {
  if (!valid_plan(B, HW, C, G, band, cluster, rows)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == azula::kBFloat16) return dispatch<__nv_bfloat16>(x, out, B, HW, C, G, band, cluster, rows, stage, s);
  if (dtype == azula::kFloat32) return dispatch<float>(x, out, B, HW, C, G, band, cluster, rows, stage, s);
  return cudaErrorInvalidValue;
}
