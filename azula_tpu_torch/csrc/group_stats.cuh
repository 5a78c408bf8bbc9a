// The statistics stage shared by group_norm.cu and group_stats.cu: one launch
// of thread-block clusters, each cluster summing the rows of one unit and
// folding its blocks' partials over distributed shared memory.
//
// The unit of work is (b, band): batch row b of x (B, HW, C), channels-last,
// and a band of Cb channels made of whole groups. The launch's grid is
// (bands * N, B) in clusters of (N, 1, 1): the N blocks of a cluster share
// one unit, block `rank` taking its rows [rank * rows, min((rank + 1) * rows,
// HW)). A group wider than a band (C / G > Cb, at most kMaxCluster bands of
// Cb channels) is one unit of its `span` = C / G / Cb bands: the cluster's
// N = span * nr blocks take band j's rows [r * rows, ...) at rank j * nr + r,
// and every channel of the group is folded over its band's nr blocks. The
// Python planner (`ops/norm.py`, `_gn_plan`) chooses Cb, N and rows, and how
// many of a block's rows group_norm.cu keeps in shared memory.
//
// In a block, threads run along the band in vectors of at most 16 bytes (nvx
// threads, the band's vectors rounded up to a power of two) and along the
// rows (TY = kThreads / nvx threads), so a warp reads whole runs of each
// row. Rows reach shared memory by cp.async, in chunks that are all in
// flight at once, two slots deep, so that a block reads at the card's rate
// without registers held per load (`stream_chunks`). Every moment is taken
// of d = x - K, K the pilot row x[b, 0, :], so the statistics stay exact
// when |mean| >> std. Each thread keeps its vector's moments in registers;
// the block's threads are combined in a fixed order (warp shuffles between
// the row threads of one warp, then the warps through shared memory), and
// the block publishes one partial per channel in its own shared memory.
// After a cluster barrier, the blocks read their peers' partials through
// `map_shared_rank` and fold them in rank order, so every block of a
// cluster that folds computes the same bits. No partial goes through device
// memory.
#pragma once

#include <cooperative_groups.h>

#include <climits>
#include <mutex>

#include "common.cuh"

namespace azula {
namespace gstats {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// channels of a band: at most one per thread where the fold runs per channel
// (a wider group spans up to kMaxCluster bands)
constexpr int kMaxBand = 512;
// at most 16 blocks a cluster (above 8, the non-portable sizes)
constexpr int kMaxCluster = 16;
// shared memory a block can take (227 KB on the H100)
constexpr int kMaxSharedBytes = 232448;

// the widest vector of at most 16 bytes whose length divides the band; the
// band divides C, so every row's band starts on such a vector
template <typename T>
inline int vector_of(int Cb) {
  constexpr int kMax = 16 / sizeof(T);
  return Cb % kMax == 0 ? kMax : Cb % 4 == 0 ? 4 : Cb % 2 == 0 ? 2 : 1;
}

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Threads along a band of Cb channels in vectors of VEC: the band's vectors
// rounded up to a power of two.
__host__ __device__ constexpr int lanes_of(int Cb, int vec) {
  int nvx = 1;
  while (nvx < Cb / vec) nvx <<= 1;
  return nvx;
}

// The scratch of the block's combination (a state per channel for each warp,
// or each row thread where a row spans warps), reused by the fold's
// `floats` float32 values.
template <typename S>
__host__ __device__ constexpr int scratch_bytes(int Cb, int vec, int floats) {
  const int nvx = lanes_of(Cb, vec);
  const int rows = nvx < 32 ? kWarps : kThreads / nvx;
  const int red = rows * Cb * static_cast<int>(sizeof(S));
  return align16(red > floats * 4 ? red : floats * 4);
}

// The bands of one group: 1 where a band holds whole groups.
__host__ __device__ constexpr int span_of(int cpg, int Cb) { return cpg > Cb ? cpg / Cb : 1; }

// The block's share of its cluster's unit.
struct Unit {
  int b;      // batch row
  int rank;   // block in the cluster
  int span;   // bands of the unit's group (1: the unit is one band of whole groups)
  int nr;     // blocks of a band in the cluster
  int r0;     // first row of the block
  int nrows;  // rows of the block
  int g0;     // first channel of the unit
  int c0;     // first channel of the block's band

  __device__ Unit(int cpg, int Cb, int N, int rows, int HW, int rank_)
      : b(blockIdx.y), rank(rank_), span(span_of(cpg, Cb)), nr(N / span), r0(rank_ % nr * rows),
        nrows(max(0, min(rows, HW - rank_ % nr * rows))), g0(static_cast<int>(blockIdx.x) / N * span * Cb),
        c0(g0 + rank_ / nr * Cb) {}
};

// A thread's place in the block: vector cv of the band, row thread ty.
template <int VEC>
struct Lanes {
  int nv;   // vectors in a band row
  int nvx;  // threads along the band (nv rounded up to a power of two)
  int TY;   // threads along the rows
  int cv, ty;
  bool active;  // whether cv is a vector of the band

  __device__ explicit Lanes(int Cb) : nv(Cb / VEC), nvx(lanes_of(Cb, VEC)) {
    TY = kThreads / nvx;
    cv = threadIdx.x % nvx;
    ty = threadIdx.x / nvx;
    active = cv < nv;
  }
};

// Calls f(l, pack) for the local rows l = first, first + step, ... below
// end, of the vector at xc (row 0 of the block), with four loads in flight:
// the path of vectors under 4 bytes (odd bf16 bands), which cp.async
// cannot copy.
template <typename T, int VEC, typename F>
__device__ __forceinline__ void for_rows(const T* xc, int C, int first, int end, int step, F&& f) {
  for (int lr = first; lr < end; lr += 4 * step) {
    Pack<T, VEC> pk[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int l = lr + u * step;
      if (l < end) pk[u] = *reinterpret_cast<const Pack<T, VEC>*>(xc + static_cast<size_t>(l) * C);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int l = lr + u * step;
      if (l < end) f(l, pk[u]);
    }
  }
}

// L2 policies: lines read again soon (kept before others), lines read once
__device__ __forceinline__ uint64_t l2_keep() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_drop() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// Copies BYTES (4, 8 or 16) from device memory to shared memory without
// registers (cp.async), under an L2 policy; the copying thread sees them
// after a wait.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, uint64_t policy) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "l"(policy)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(BYTES),
                 "l"(policy)
                 : "memory");
  }
}

// Stores v as VEC elements of T under an L2 policy (y is written once and
// read by the next layer, and must not push out the rows that a block reads
// again).
template <typename T, int VEC>
__device__ __forceinline__ void store_hint(T* p, const float (&v)[VEC], uint64_t policy) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = from_float<T>(v[i]);
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  if constexpr (kBytes == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(&pk);
    asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p), "r"(w.x), "r"(w.y),
                 "r"(w.z), "r"(w.w), "l"(policy)
                 : "memory");
  } else if constexpr (kBytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(&pk);
    asm volatile("st.global.L2::cache_hint.v2.b32 [%0], {%1, %2}, %3;\n" ::"l"(p), "r"(w.x), "r"(w.y), "l"(policy)
                 : "memory");
  } else if constexpr (kBytes == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(&pk);
    asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;\n" ::"l"(p), "r"(w), "l"(policy) : "memory");
  } else {
    *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// waits until at most N of the thread's committed groups of copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Calls f(l, pack) for the local rows of n chunks streamed through a stage
// of two slots of H rows (H a multiple of TY; sv the thread's column of
// slot 0). span(i) gives chunk i's rows [a, b), at most H of them; chunk i
// sits in slot (i + flip) & 1 and is copied under the L2 policy policy(i);
// the first `pre` chunks are in the stage already. While chunk i is read
// back, chunk i + 1 is in flight (cp.async) in the slot that chunk i - 1
// freed. The thread takes rows a + ty, a + ty + TY, ... of each chunk, so it
// reads back only what it copied itself and needs no barrier.
template <typename T, int VEC, typename Span, typename Policy, typename F>
__device__ __forceinline__ void stream_chunks(const T* xc, int C, T* sv, int Cb, int ty, int TY, int H, int n,
                                              int pre, int flip, Span&& span, Policy&& policy, F&& f) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  auto issue = [&](int i) {
    const int2 r = span(i);
    const uint64_t hint = policy(i);
    T* slot = sv + ((i + flip) & 1) * H * Cb;
    for (int l = r.x + ty; l < r.y; l += TY) {
      cp_async<kBytes>(slot + (l - r.x) * Cb, xc + static_cast<size_t>(l) * C, hint);
    }
    cp_async_commit();
  };
  if (pre == 0 && n > 0) issue(0);
  for (int i = 0; i < n; ++i) {
    const bool next = i + 1 < n && i + 1 >= pre;
    if (next) issue(i + 1);
    if (i >= pre) {
      if (next) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    }
    const int2 r = span(i);
    const T* slot = sv + ((i + flip) & 1) * H * Cb;
#pragma unroll 4
    for (int l = r.x + ty; l < r.y; l += TY) f(l, *reinterpret_cast<const Pack<T, VEC>*>(slot + (l - r.x) * Cb));
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Pack<T, VEC>& pk, float (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_float(pk.v[i]);
}

// Combines the threads' states per channel into the block's, in a fixed
// order, and writes channel c's to pub[c] (c < Cb). S has add(const S&), a
// combination in place, and shfl_xor(int). Every thread of the block calls it.
template <typename S, int VEC>
__device__ __forceinline__ void block_combine(const Lanes<VEC>& L, S (&acc)[VEC], S* red, S* pub, int Cb) {
  const int lane = threadIdx.x % 32;
  int row = L.ty, nrow = L.TY;
  bool write = L.active;
  if (L.nvx < 32) {
    // the row threads of one vector inside a warp are lanes nvx apart
    for (int off = 16; off >= L.nvx; off >>= 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i].add(acc[i].shfl_xor(off));
    }
    row = threadIdx.x / 32;
    nrow = kWarps;
    write = write && lane < L.nvx;
  }
  if (write) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[row * Cb + L.cv * VEC + i] = acc[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < Cb; c += kThreads) {
    S t = red[c];
    for (int r = 1; r < nrow; ++r) t.add(red[r * Cb + c]);
    pub[c] = t;
  }
}

// Channel c's state of the blocks of ranks first, ..., first + n - 1 (the
// blocks of one band), folded in rank order.
template <typename S>
__device__ __forceinline__ S cluster_fold(cg::cluster_group& cluster, S* pub, int c, int first, int n) {
  S t = *cluster.map_shared_rank(pub + c, first);
  for (int q = first + 1; q < first + n; ++q) t.add(*cluster.map_shared_rank(pub + c, q));
  return t;
}

// The two halves of a cluster barrier: a block arrives once it has read its
// peers' shared memory, and waits before it exits, so that no block leaves
// while a peer may still read its partials.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A sum over the warp's lanes, the same bits in every lane (each butterfly
// step adds the same two values, in either order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// K sums over the block's threads, in a fixed order (the warps' sums through
// `ws`, K * kWarps floats, added in warp order), the same bits in every
// thread and in every block that sums the same values. Every thread of the
// block calls it.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* ws) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) ws[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = ws[k * kWarps];
    for (int w = 1; w < kWarps; ++w) t += ws[k * kWarps + w];
    v[k] = t;
  }
  __syncthreads();
}

// Sets a kernel's dynamic shared memory limit (and, for clusters above 8
// blocks, the non-portable sizes) on the current device where a launch
// needs more than was set before: the attributes belong to the device's copy
// of the kernel, and setting them costs the host more than the launch.
inline cudaError_t ensure_attributes(const void* kernel, int smem, bool nonportable) {
  struct Set {
    const void* kernel;
    int device, smem;
    bool nonportable;
  };
  constexpr int kEntries = 64;
  static Set table[kEntries] = {};
  static int used = 0;
  static std::mutex lock;

  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> guard(lock);
  Set* entry = nullptr;
  for (int i = 0; i < used && entry == nullptr; ++i) {
    if (table[i].kernel == kernel && table[i].device == device) entry = &table[i];
  }
  if (entry == nullptr && used < kEntries) {
    entry = &table[used++];
    *entry = {kernel, device, 0, false};
  }
  if (entry != nullptr && entry->smem >= smem && (entry->nonportable || !nonportable)) return cudaSuccess;

  // never lower a limit that an earlier launch set
  const int limit = entry != nullptr && entry->smem > smem ? entry->smem : smem;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (e == cudaSuccess && nonportable) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return e;
  if (entry != nullptr) {
    entry->smem = limit;
    entry->nonportable = entry->nonportable || nonportable;
  }
  return cudaSuccess;
}

// Launches `kernel` on a grid (units * N, B) of kThreads-thread blocks in
// clusters of (N, 1, 1) with `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int units, int N, int B, int smem, cudaStream_t s,
                            Args... args) {
  cudaError_t e = ensure_attributes(reinterpret_cast<const void*>(kernel), smem, N > 8);
  if (e != cudaSuccess) return e;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(units * N), static_cast<unsigned>(B), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Whether a plan is one the kernels take: bands of Cb channels dividing C,
// at most kMaxBand, made of whole groups or, for a wider group, dividing it
// into span bands whose blocks (span of them a row block) fill the cluster;
// N in [1, kMaxCluster]; every block of a band holding at least one row.
inline bool valid_plan(int B, int HW, int C, int G, int Cb, int N, int rows) {
  if (B < 1 || B > 65535 || HW < 1 || G < 1 || C % G != 0 || Cb < 1 || Cb > kMaxBand) return false;
  const int cpg = C / G;
  if (C % Cb != 0 || (Cb % cpg != 0 && cpg % Cb != 0) || N < 1 || N > kMaxCluster || rows < 1) return false;
  const int span = span_of(cpg, Cb);
  if (N % span != 0) return false;
  const int nr = N / span;
  if (static_cast<long long>(rows) * nr < HW || static_cast<long long>(rows) * (nr - 1) >= HW) return false;
  return static_cast<long long>(C / Cb / span) * N <= INT_MAX;
}

}  // namespace gstats
}  // namespace azula
