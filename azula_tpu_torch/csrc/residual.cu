// The residual sum of a block with the biases of its convolutions:
// out = skip + h + (b0 + b1), per-channel biases, over a channels-last
// tensor.
//
// Replaces: no TPU kernel. XLA adds a convolution's bias in the convolution's
// own epilogue on the TPU; on the card, cuDNN's convolution leaves the bias to
// a separate broadcast `add_` over its whole output, one more read and write
// of it. ADM's residual blocks run their last convolution and their 1x1 skip
// convolution without bias and take both biases here, in the pass that reads
// the two outputs anyway (models/adm/backbone.py, ADMResBlock).
//
// Rounding: every element is summed in float32, the biases first, and
// rounded once to the storage type, as ops/residual.py's plain version
// computes it.
//
// Bound on the H100: memory. Two reads and one write of 2 or 4 bytes an
// element against three float32 additions.
//
// Design: one pass of short-lived blocks, as PyTorch's own vectorized
// elementwise kernels run (a grid that walks the tensor with resident blocks
// read 2.94 TB/s at ADM's largest residual against 3.09 for these, on an
// H100 at 700 W). A block takes 1,024 consecutive vectors, four a thread at
// a stride of the block's 256 threads, so that neighbouring threads touch
// neighbouring addresses and a thread's eight loads are in flight together.
// A vector is 16 bytes (8 bf16 or 4 float32) where every pointer is 16-byte
// aligned and the row's C channels hold whole vectors (every ADM width:
// 192 to 1,024 channels); otherwise one element, so that the kernel takes
// any C and any alignment. Each vector reads the biases of its own
// channels, a few KB that the cache holds.
#include "common.cuh"

namespace {

using azula::load;
using azula::store;

constexpr int kThreads = 256;
constexpr int kPer = 4;  // vectors a thread

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
residual_add_kernel(const T* __restrict__ skip, const T* __restrict__ h, const T* __restrict__ b0,
                    const T* __restrict__ b1, T* __restrict__ out, int64_t vectors, int lanes) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kPer + threadIdx.x;

  float a[kPer][V], c[kPer][V];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int64_t v = first + r * kThreads;
    if (v < vectors) {
      load<T, V>(skip + v * V, a[r]);
      load<T, V>(h + v * V, c[r]);
    }
  }

  // vector v holds the V channels from (v % lanes) V on, lanes = C / V
  int lane = static_cast<int>(first % lanes);
  const int step = kThreads % lanes;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int64_t v = first + r * kThreads;
    if (v < vectors) {
#pragma unroll
      for (int k = 0; k < V; ++k) a[r][k] += c[r][k];
      if (b0 != nullptr) {
        float bias[V];
        load<T, V>(b0 + lane * V, bias);
        if (b1 != nullptr) {
          float b[V];
          load<T, V>(b1 + lane * V, b);
#pragma unroll
          for (int k = 0; k < V; ++k) bias[k] += b[k];
        }
#pragma unroll
        for (int k = 0; k < V; ++k) a[r][k] += bias[k];
      }
      store<T, V>(out + v * V, a[r]);
    }
    lane += step;
    if (lane >= lanes) lane -= lanes;
  }
}

template <typename T>
int launch(const void* skip, const void* h, const void* b0, const void* b1, void* out, int rows, int C,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(skip) | reinterpret_cast<uintptr_t>(h) |
                              reinterpret_cast<uintptr_t>(b0) | reinterpret_cast<uintptr_t>(b1) |
                              reinterpret_cast<uintptr_t>(out);
  const bool vector = addresses % 16 == 0 && C % V == 0;
  const int width = vector ? V : 1;
  const int lanes = C / width;
  const int64_t vectors = static_cast<int64_t>(rows) * lanes;
  const dim3 grid(static_cast<unsigned>((vectors + kThreads * kPer - 1) / (kThreads * kPer)));

  const T* s = static_cast<const T*>(skip);
  const T* x = static_cast<const T*>(h);
  const T* p = static_cast<const T*>(b0);
  const T* q = static_cast<const T*>(b1);
  T* y = static_cast<T*>(out);
  if (vector) {
    residual_add_kernel<T, V><<<grid, kThreads, 0, stream>>>(s, x, p, q, y, vectors, lanes);
  } else {
    residual_add_kernel<T, 1><<<grid, kThreads, 0, stream>>>(s, x, p, q, y, vectors, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// skip, h, out: (rows, C) contiguous, dtype 0 = float32, 1 = bfloat16; b0,
// b1: (C,) of the same dtype, or null (b1 only with b0). Any alignment of
// the element type, rows >= 1, C >= 1. Returns the launch's CUDA error.
extern "C" int azula_residual_add(const void* skip, const void* h, const void* b0, const void* b1, void* out,
                                  int rows, int C, int dtype, void* stream) {
  if (rows < 1 || C < 1 || (b1 != nullptr && b0 == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == azula::kBFloat16) return launch<__nv_bfloat16>(skip, h, b0, b1, out, rows, C, s);
  if (dtype == azula::kFloat32) return launch<float>(skip, h, b0, b1, out, rows, C, s);
  return cudaErrorInvalidValue;
}
