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
// which the bf16 tensor cores, not the memory, limit. This first kernel
// runs on the CUDA cores in float32 (67 TFLOP/s at most), so it cannot come
// near the tensor-core bound; that is later work.
//
// Design: the TPU kernel DMAs a padded row band of the whole width into
// VMEM and runs nine full-width matmuls with lane rolls for the column
// shifts; the zero padding is materialized beforehand with jnp.pad. Here a
// block owns an 8 x 8 tile of output pixels and 64 output channels of one
// image. It walks C in chunks of 16: it stages the chunk's 10 x 10 input
// tile (the halo included, zeros outside the image: the padding is applied
// here) and the chunk's 9 x 16 x 64 weights in shared memory as float32
// (43 KiB, a fixed size at every shape), and each of its 256 threads
// accumulates a 4-pixel x 4-channel tile in registers, 48 FMAs per pair of
// one input row and three weight vectors read. Ragged H, W, C and K are
// masked.
#include "common.cuh"

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

}  // namespace

// x: (B, H, W, C), w: (3, 3, C, K), y: (B, H, W, K), all contiguous, of one
// dtype, 0 = float32, 1 = bfloat16. B * ceil(H / 8) * ceil(W / 8) < 2^31.
// Returns cudaGetLastError().
extern "C" int azula_conv3x3(const void* x, const void* w, void* y, int B, int H, int W, int C, int K, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == azula::kBFloat16) return launch<__nv_bfloat16>(x, w, y, B, H, W, C, K, s);
  if (dtype == azula::kFloat32) return launch<float>(x, w, y, B, H, W, C, K, s);
  return cudaErrorInvalidValue;
}
