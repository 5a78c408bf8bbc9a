// Direct 3x3 convolution, stride 1, zero padding 1, channels-last.
//
// Replaces: azula_tpu/ops/conv.py:53 (_pallas_conv3x3). It computes
//     y[b, h, w, k] = sum_{dy, dx, c} xpad[b, h + dy, w + dx, c] * w[dy, dx, c, k]
// for x (B, H, W, C) in bf16 or float32 and HWIO weights (3, 3, C, K) of the
// same dtype, accumulated in float32, y (B, H, W, K) in x's dtype.
//
// Bound on the H100: operations. 2 * 9 * C * K operations per output pixel
// against (C + K) elements moved: at unet32's shapes (C = K = 128 or 256)
// that is 1,150 to 2,300 operations per byte in bf16, far above the ~295 at
// which the bf16 tensor cores, not the memory, limit.
//
// Design, bf16 with C % 8 == 0 and K % 8 == 0 (TMA's 16-byte strides): an
// implicit GEMM on the tensor cores. M is the output pixels, N the output
// channels, and the contraction 9 C runs as k-blocks of one tap (dy, dx)
// and 64 input channels, four k16 wgmma steps each. A block owns a box of
// 128 output positions (TW x TH x TB = 128: 16 x 8 x 1 at 16 x 16 images,
// 8 x 8 x 2 at 8 x 8, 32 x 4 x 1 at 32 x 32; powers of two covering W, then
// H, then the batch) and 128 output channels. The A operand of a k-block is
// one TMA box of a four-dimensional map over x, dimensions (C, W, H, B),
// at (c0, w0 + dx - 1, h0 + dy - 1, b0): what lies outside the image (the
// SAME padding), past C or past B arrives as zeros, so nothing is padded in
// memory, no halo is staged by threads and a box never bleeds into the next
// image. It lands as 128 rows of 64 channels (128 bytes) in the 128-byte
// swizzle, K-major, as the attention kernels' Q tiles. The B operand is the
// weights of the tap and chunk, read through a three-dimensional map
// (K, C, 9 taps), so that a chunk past C reads zeros and never the next
// tap's rows: two 64-column panels of 64 channel rows, MN-major (HWIO keeps
// K contiguous). One producer warp (its thread 0) keeps three stages of
// (A box, B tile), 32 KB each, in flight on mbarriers; two consumer
// warpgroups each accumulate a 64 x 128 float32 tile with wgmma (A and B
// from shared memory, B transposed), keep one k-block's products in flight
// and release its stage after the next is issued. Two blocks share an SM
// (97 KB of shared memory each), so one block's epilogue runs under the
// other's products. The epilogue rounds to bf16 and stores each position's
// channels (bf16 pairs) where the position lies inside the image and the
// batch. Rows of the box are box positions, not pixels: a box past W, H or
// B costs products whose results are dropped. Blocks form a
// one-dimensional grid, (box, channel tile) with the channel tiles of a
// box together.
//
// Design, float32 and the other bf16 shapes: the CUDA-core direct
// convolution (no TF32, which would break the float32 gates). The TPU
// kernel DMAs a padded row band of the whole width into VMEM and runs nine
// full-width matmuls with lane rolls for the column shifts; the zero
// padding is materialized beforehand with jnp.pad. Here a block owns an
// 8 x 8 tile of output pixels and 64 output channels of one image. It walks
// C in chunks of 16: it stages the chunk's 10 x 10 input tile (the halo
// included, zeros outside the image: the padding is applied here) and the
// chunk's 9 x 16 x 64 weights in shared memory as float32 (43 KiB, a fixed
// size at every shape), and each of its 256 threads accumulates a 4-pixel x
// 4-channel tile in registers, 48 FMAs per pair of one input row and three
// weight vectors read. Ragged H, W, C and K are masked.
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using azula::from_float;
using azula::to_float;

constexpr int kThreads = 256;
constexpr int TH = 8;        // output rows of a block
constexpr int TW = 8;        // output columns of a block
constexpr int TK = 64;       // output channels of a block
constexpr int CK = 16;       // input channels staged at a time
constexpr int PH = TH + 2;   // input tile with its halo
constexpr int PW = TW + 2;

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               int H, int W, int C, int K, int tiles_w, int tiles) {
  __shared__ float in_s[PH * PW * CK];            // [row][col][channel]
  __shared__ __align__(16) float w_s[9 * CK * TK];  // [tap][channel][out channel]

  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int h0 = (tile / tiles_w) * TH;
  const int w0 = (tile % tiles_w) * TW;
  const int k0 = blockIdx.y * TK;

  const int tx = threadIdx.x % (TK / 4);  // out channels k0 + 4 tx .. + 3
  const int ty = threadIdx.x / (TK / 4);  // pixels (r, c0 .. c0 + 3)
  const int r = ty / 2;
  const int c0 = (ty % 2) * 4;

  const T* xb = x + static_cast<size_t>(b) * H * W * C;

  float acc[4][4] = {};

  for (int cc = 0; cc < C; cc += CK) {
    // the input tile of this chunk, zero outside the image and past C
    for (int i = threadIdx.x; i < PH * PW * CK; i += kThreads) {
      const int ci = i % CK;
      const int p = i / CK;
      const int hh = h0 - 1 + p / PW;
      const int ww = w0 - 1 + p % PW;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && cc + ci < C) {
        v = to_float(xb[(static_cast<size_t>(hh) * W + ww) * C + cc + ci]);
      }
      in_s[i] = v;
    }
    // the chunk's weights, zero past C and K
    for (int i = threadIdx.x; i < 9 * CK * TK; i += kThreads) {
      const int k = i % TK;
      const int ci = (i / TK) % CK;
      const int tap = i / (TK * CK);
      float v = 0.f;
      if (cc + ci < C && k0 + k < K) {
        v = to_float(w[(static_cast<size_t>(tap) * C + cc + ci) * K + k0 + k]);
      }
      w_s[i] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xin[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) xin[q] = in_s[((r + dy) * PW + c0 + q) * CK + ci];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(&w_s[((dy * 3 + dx) * CK + ci) * TK + tx * 4]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = xin[j + dx];
            acc[j][0] += v * wv.x;
            acc[j][1] += v * wv.y;
            acc[j][2] += v * wv.z;
            acc[j][3] += v * wv.w;
          }
        }
      }
    }
    __syncthreads();
  }

  const int hh = h0 + r;
  const int k = k0 + tx * 4;
  if (hh >= H) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ww = w0 + c0 + j;
    if (ww >= W) break;
    T* out = y + ((static_cast<size_t>(b) * H + hh) * W + ww) * K + k;
    if (K % 4 == 0 && k + 4 <= K) {
      azula::store<T, 4>(out, acc[j]);
    } else {
      for (int i = 0; i < 4 && k + i < K; ++i) out[i] = from_float<T>(acc[j][i]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int B, int H, int W, int C, int K, cudaStream_t s) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  const dim3 grid(B * tiles, (K + TK - 1) / TK);

  conv3x3_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), H, W, C, K, tiles_w, tiles);
  return cudaGetLastError();
}

// The bf16 form on the tensor cores.
namespace tc {

namespace hw = azula::hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;                   // output positions of a block (its box)
constexpr int BN = 128;                   // output channels of a block
constexpr int BK = 64;                    // input channels of a k-block
constexpr int kStages = 3;
constexpr int kThreads = 2 * 128 + 32;    // two consumer warpgroups and the producer warp
constexpr int kA = BM * BK * 2;           // an A box: 128 rows of 128 bytes
constexpr int kPanel = BK * 64 * 2;       // a B panel: 64 channel rows of 64 output channels
constexpr int kStage = kA + 2 * kPanel;
constexpr int kBar = kStages * kStage;
constexpr int kBytes = kBar + 8 * 2 * kStages + 1024;  // barriers: stage s full, stage s empty; alignment slack

// an SM's 228 KB of shared memory hold two blocks, each with its 1 KB reserve
static_assert(2 * (kBytes + 1024) <= 233472, "two blocks share an SM");

// A block: the box of output positions (w, h, b) from (w0, h0, b0), tw x th
// x tb of them, and output channels [n0, n0 + 128).
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_tc_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                  bf16* __restrict__ y, int B, int H, int W, int C, int K, int tw, int th, int tiles_w, int tiles_h,
                  int n_tiles) {
  extern __shared__ __align__(1024) uint8_t conv_smem[];
  const uint32_t base = (hw::smem_addr(conv_smem) + 1023) & ~1023u;
  const uint32_t full = base + kBar;        // + 8 s for stage s
  const uint32_t empty = full + 8 * kStages;

  const int n0 = (blockIdx.x % n_tiles) * BN;
  int box = blockIdx.x / n_tiles;
  const int w0 = (box % tiles_w) * tw;
  box /= tiles_w;
  const int h0 = (box % tiles_h) * th;
  const int b0 = (box / tiles_h) * (BM / (tw * th));
  const int chunks = (C + BK - 1) / BK;
  const int k_blocks = 9 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hw::barrier_init(full + 8 * s, 1);
      hw::barrier_init(empty + 8 * s, 256);
    }
    hw::barrier_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == 8) {
    // the producer: k-block j (tap j / chunks, channels from 64 (j % chunks))
    // into stage j % 3 once the consumers have released its k-block j - 3
    if (lane == 0) {
      for (int j = 0; j < k_blocks; ++j) {
        const int s = j % kStages;
        if (j >= kStages) hw::barrier_wait(empty + 8 * s, (j / kStages - 1) & 1);
        const int tap = j / chunks;
        const int c0 = (j % chunks) * BK;
        const uint32_t a = base + s * kStage;
        hw::barrier_expect(full + 8 * s, kStage);
        hw::tma_load(a, &x_map, full + 8 * s, c0, w0 + tap % 3 - 1, h0 + tap / 3 - 1, b0);
        hw::tma_load(a + kA, &w_map, full + 8 * s, n0, c0, tap);
        hw::tma_load(a + kA + kPanel, &w_map, full + 8 * s, n0 + 64, c0, tap);
      }
    }
    return;
  }

  // a consumer warpgroup: box positions [64 wg, 64 wg + 64), all 128 channels
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < k_blocks; ++j) {
    const int s = j % kStages;
    hw::barrier_wait(full + 8 * s, (j / kStages) & 1);
    const uint32_t a_tile = base + s * kStage + wg * 64 * 128;
    const uint32_t b_tile = base + s * kStage + kA;
    hw::fence_registers(acc);
    hw::mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a = hw::descriptor(a_tile + kk * 32, 16, 8 * 128, 1);
      const uint64_t b = hw::descriptor(b_tile + kk * 16 * 128, kPanel, 8 * 128, 1);
      hw::mma_ss<BN, 0, 1>(acc, a, b, 1);
    }
    hw::mma_commit();
    // the products of k-block j - 1 are done: release its stage
    hw::mma_wait<1>();
    hw::fence_registers(acc);
    if (j > 0) hw::barrier_arrive(empty + 8 * ((j - 1) % kStages));
  }
  hw::mma_wait<0>();
  hw::fence_registers(acc);

  // element i of acc: box position 64 wg + r + 8 ((i / 2) % 2), channel
  // n0 + 8 (i / 4) + c + i % 2
  const int r = 64 * wg + 16 * (warp % 4) + lane / 4;
  const int c = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = r + 8 * h;
    const int ww = w0 + p % tw;
    const int hh = h0 + p / tw % th;
    const int b = b0 + p / (tw * th);
    if (ww < W && hh < H && b < B) {
      bf16* dst = y + ((static_cast<size_t>(b) * H + hh) * W + ww) * K + n0 + c;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        if (n0 + 8 * n + c < K) {
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
              __floats2bfloat162_rn(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
        }
      }
    }
  }
}

// The smallest power of two at least n, at most cap.
int cover(int n, int cap) {
  int p = 1;
  while (p < n && p < cap) p *= 2;
  return p;
}

cudaError_t launch(const void* x, const void* w, void* y, int B, int H, int W, int C, int K, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 4) {
    return cudaErrorInvalidValue;
  }
  const int tw = cover(W, BM);
  const int th = cover(H, BM / tw);
  const int tb = BM / (tw * th);
  const int tiles_w = (W + tw - 1) / tw;
  const int tiles_h = (H + th - 1) / th;
  const int n_tiles = (K + BN - 1) / BN;
  const long long blocks = static_cast<long long>((B + tb - 1) / tb) * tiles_h * tiles_w * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;

  const int64_t x_dims[4] = {C, W, H, B};
  const int64_t x_strides[3] = {2LL * C, 2LL * W * C, 2LL * H * W * C};
  const int x_box[4] = {BK, tw, th, tb};
  const int64_t w_dims[3] = {K, C, 9};
  const int64_t w_strides[2] = {2LL * K, 2LL * C * K};
  const int w_box[3] = {64, BK, 1};
  CUtensorMap x_map, w_map;
  if (!hw::encode_map(&x_map, x, 4, x_dims, x_strides, x_box) ||
      !hw::encode_map(&w_map, w, 3, w_dims, w_strides, w_box)) {
    return cudaErrorInvalidValue;
  }

  const cudaError_t e = hw::allow_shared_memory<conv3x3_tc_kernel>(kBytes);
  if (e != cudaSuccess) return e;

  conv3x3_tc_kernel<<<static_cast<unsigned>(blocks), kThreads, kBytes, s>>>(
      x_map, w_map, static_cast<bf16*>(y), B, H, W, C, K, tw, th, tiles_w, tiles_h, n_tiles);
  return cudaGetLastError();
}

}  // namespace tc

// The form of a call: the tensor cores for bf16 with C % 8 == 0 and
// K % 8 == 0, the CUDA cores otherwise (`conv._conv3x3_form` mirrors it).
bool tensor_cores(int C, int K, int dtype) { return dtype == azula::kBFloat16 && C % 8 == 0 && K % 8 == 0; }

}  // namespace

// x: (B, H, W, C), w: (3, 3, C, K), y: (B, H, W, K), all contiguous, of one
// dtype, 0 = float32, 1 = bfloat16; x and w 16-byte aligned on the
// tensor-core form. B * ceil(H / 8) * ceil(W / 8) < 2^31. Returns
// cudaGetLastError().
extern "C" int azula_conv3x3(const void* x, const void* w, void* y, int B, int H, int W, int C, int K, int dtype,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores(C, K, dtype)) return tc::launch(x, w, y, B, H, W, C, K, s);
  if (dtype == azula::kBFloat16) return launch<__nv_bfloat16>(x, w, y, B, H, W, C, K, s);
  if (dtype == azula::kFloat32) return launch<float>(x, w, y, B, H, W, C, K, s);
  return cudaErrorInvalidValue;
}

// 1 if a call with C input and K output channels in `dtype` takes the
// tensor-core form, else 0.
extern "C" int azula_conv3x3_tensor_cores(int C, int K, int dtype) { return tensor_cores(C, K, dtype) ? 1 : 0; }

// The dynamic shared memory of a block of the tensor-core form.
extern "C" int azula_conv3x3_tc_shared_bytes() { return tc::kBytes; }
