// Flash-attention forward: o = softmax(q k^T * scale) v on (B, H, L, D).
//
// Replaces: azula_tpu/ops/attention.py:92, _pallas_attention (512 <= L <=
// 2048), and :566, _pallas_attention_batched (L <= 512), with their additive
// bias, and the dropout form of :337, _pallas_attention_blocked. Any L is
// taken; D is 32, 64, 128, 192 or 256. Inputs and output are bf16 or
// float32.
//
// The bias is the TPU kernels' b_ref: (Gm, L, L) in the inputs' dtype, 0
// where a boolean mask keeps and -1e30 where it masks (`_mask_to_bias`),
// pair p = b H + h reading group (p / bias_div) % bias_mod (the "full",
// "batch", "head" and "one" modes of `_bias_group_fn`); it is added to the
// scaled scores. A row masked everywhere gives the mean of v, as on the TPU
// (the -inf of the XLA path gives NaN). Dropout is the blocked kernel's: the
// keep mask is the coordinate hash of azula::PairMask over (row, column,
// pair) and two seed words read from the device, kept weights p / (1 - r)
// rounded to the input dtype against the running max enter the value
// product, while the denominator, and so the LSE, stay those of the
// undropped softmax. The exact and LSE entries take both; the max-free
// entry takes neither (JAX ignores max_free under a mask or dropout).
//
// The LSE entry is the same forward with the TPU kernels' with_lse=True
// output, the residual of the backward (attention_bwd.cu): each row's float32
// log-sum-exp m + log l, (B H, L), from the online softmax's final row max m
// and denominator l (the TPU kernels write it lane-replicated, (B H, L, 128)).
// As in the TPU kernel, its exp-weights are rounded to the input dtype before
// the value product; the inference entry keeps them unrounded, and writes no
// LSE, as JAX's primal path writes none.
//
// The max-free entry replaces _pallas_attention_blocked (L > 2048) and
// _pallas_attention's max_free option, in the same unmasked inference form:
// no row max and no rescale, p = exp(min(s, 80)) rounded to the input dtype
// before the value product, the denominator summed from the unrounded p, and
// o = acc / l at the end. The Python wrapper takes it where the JAX package's
// TPU dispatch threads max_free (L > 512, L % 128 == 0, D % 64 == 0).
//
// Bound on the H100: a (b, h) pair does 4 L^2 D operations on 8 L D bytes
// (bf16), L / 2 operations per byte. At ADM's L = 1024 that is above the
// ~295 where even the bf16 tensor cores would limit, and this kernel runs its
// products on the float32 CUDA cores (67 TFLOP/s, ~20 operations per byte),
// so it is bound by operations at every main-path length (L = 64, 256, 1024
// for ADM, 4608 for FLUX.1 at 1024 px).
//
// Design: the TPU kernel kept a pair's whole K and V resident in VMEM and
// ran one softmax over it. A block here has at most 227 KB of shared memory,
// so K and V are streamed instead: one block of 256 threads per (b * h,
// 64-query tile) runs the flash step of common.cuh (azula::flash) over
// 64-key tiles, with an online softmax in float32 divided once at the end;
// the exact route's exp-weights enter the value product unrounded. Keys and
// queries past L are masked in the ragged last tile, so no length gate is
// needed. The products use plain FMA; tensor cores (mma.sync / wgmma) and
// TMA are later work. At D = 128 a block takes 119,552 bytes of shared
// memory, so one block runs per SM; at D = 256 217,856 of the 232,448, so
// the bias has no tile of its own: each score reads it from device memory
// (a bias adds L^2 elements to a pair's 4 L D), and the keep mask is
// computed in registers. Blocks form a one-dimensional grid, (pair, query
// tile) with the tiles of a pair together, so any number of pairs fits.
#include "common.cuh"

namespace {

namespace flash = azula::flash;

// One block: one query tile of one pair (the tiles of a pair together in the
// one-dimensional grid). With kRound the exp-weights are rounded to T before
// the value product; with kDropout they are the dropped-out weights. Unless
// lse is null, each row's log-sum-exp goes to lse.
template <typename T, int D, bool kMaxFree, bool kRound, bool kDropout>
__device__ __forceinline__ void forward_block(const T* __restrict__ q, const T* __restrict__ k,
                                              const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                                              int L, float scale, const azula::MaskArgs& args) {
  extern __shared__ float4 smem4[];
  const flash::Tiles<D> s(reinterpret_cast<float*>(smem4));

  const int tiles = (L + flash::BQ - 1) / flash::BQ;
  const int pair = blockIdx.x / tiles;
  const size_t base = static_cast<size_t>(pair) * L * D;
  const int q0 = (blockIdx.x % tiles) * flash::BQ;
  const azula::PairMask<T> mask(args, pair, L);

  float acc[4][D / 16];
  flash::load_tile<T, D>(q + base, D, s.Q, q0, L);
  flash::start_rows<D>(s, acc);

  for (int k0 = 0; k0 < L; k0 += flash::BK) {
    __syncthreads();  // the previous tile's readers are done
    flash::load_tile<T, D>(k + base, D, s.K, k0, L);
    flash::load_tile<T, D>(v + base, D, s.V, k0, L);
    __syncthreads();
    flash::attend_tile<T, D, kRound, kMaxFree, kDropout>(s, acc, k0, L, scale, q0, mask);
  }

  flash::store_rows<T, D>(s, acc, o + base, D, q0, L);

  // the rows' final max and denominator were written before the last tile's
  // second barrier
  const int i = threadIdx.x;
  if (lse != nullptr && i < flash::BQ && q0 + i < L) {
    lse[static_cast<size_t>(pair) * L + q0 + i] = s.m[i] + logf(s.l[i]);
  }
}

// The inference forms (lse is null); the max-free form rounds its weights, as
// the TPU kernels do.
template <typename T, int D, bool kMaxFree>
__global__ void __launch_bounds__(flash::kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int L, float scale, azula::MaskArgs mask) {
  forward_block<T, D, kMaxFree, kMaxFree, false>(q, k, v, o, lse, L, scale, mask);
}

// The exact form with the LSE output, its weights rounded as the TPU kernel's;
// with kDropout the blocked kernel's dropout, with or without the LSE.
template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(flash::kThreads)
attention_fwd_lse_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         T* __restrict__ o, float* __restrict__ lse, int L, float scale, azula::MaskArgs mask) {
  forward_block<T, D, false, true, kDropout>(q, k, v, o, lse, L, scale, mask);
}

// The three entries: the exact inference forward, the max-free forward and
// the exact forward with the LSE output.
enum class Form { kExact, kMaxFree, kLse };

template <typename T, int D, Form F>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int L, float scale,
                   const azula::MaskArgs& mask, cudaStream_t s) {
  // dropout runs the rounded kernel of the blocked TPU kernel, whatever the
  // entry; without dropout, the exact inference entry keeps its weights
  // unrounded
  auto* const kernel = mask.seed != nullptr       ? attention_fwd_lse_kernel<T, D, true>
                       : F == Form::kLse          ? attention_fwd_lse_kernel<T, D, false>
                       : F == Form::kMaxFree      ? attention_fwd_kernel<T, D, true>
                                                  : attention_fwd_kernel<T, D, false>;

  const long long blocks = static_cast<long long>(BH) * ((L + flash::BQ - 1) / flash::BQ);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;

  // the limit is an attribute of the device's copy of the kernel, so it is
  // set on every launch: the current device may differ from the last one
  constexpr int bytes = flash::Tiles<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;

  kernel<<<static_cast<unsigned>(blocks), flash::kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse, L,
      scale, mask);
  return cudaGetLastError();
}

template <Form F, typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int L, int D,
                     float scale, const azula::MaskArgs& mask, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32, F>(q, k, v, o, lse, BH, L, scale, mask, s);
    case 64: return launch<T, 64, F>(q, k, v, o, lse, BH, L, scale, mask, s);
    case 128: return launch<T, 128, F>(q, k, v, o, lse, BH, L, scale, mask, s);
    case 192: return launch<T, 192, F>(q, k, v, o, lse, BH, L, scale, mask, s);
    case 256: return launch<T, 256, F>(q, k, v, o, lse, BH, L, scale, mask, s);
    default: return cudaErrorInvalidValue;
  }
}

template <Form F>
int entry(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int L, int D, float scale,
          int dtype, void* stream, const azula::MaskArgs& mask) {
  if (BH <= 0 || L <= 0 || mask.bias_div <= 0 || mask.bias_mod <= 0) return cudaErrorInvalidValue;
  if (F == Form::kMaxFree && (mask.bias != nullptr || mask.seed != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == azula::kBFloat16) return dispatch<F, __nv_bfloat16>(q, k, v, o, lse, BH, L, D, scale, mask, s);
  if (dtype == azula::kFloat32) return dispatch<F, float>(q, k, v, o, lse, BH, L, D, scale, mask, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: (BH, L, D) contiguous, dtype 0 = float32, 1 = bfloat16;
// D in {32, 64, 128, 192, 256}. bias: null or (Gm, L, L) in the dtype, pair
// p reading group (p / bias_div) % bias_mod; seed: null (no dropout) or two
// int32 words on the device, keeping where the hash is at least `threshold`
// and scaling kept weights by 1 / retain. Returns cudaGetLastError().
extern "C" int azula_attention_fwd(const void* q, const void* k, const void* v, void* o, int BH, int L, int D,
                                   float scale, int dtype, void* stream, const void* bias, int bias_div,
                                   int bias_mod, const void* seed, int threshold, float retain) {
  return entry<Form::kExact>(q, k, v, o, nullptr, BH, L, D, scale, dtype, stream,
                             azula::mask_args(bias, bias_div, bias_mod, seed, threshold, retain));
}

// The max-free form, unmasked: q, k, v, o, BH, L, D, scale, dtype and stream
// as above.
extern "C" int azula_attention_fwd_max_free(const void* q, const void* k, const void* v, void* o, int BH, int L,
                                            int D, float scale, int dtype, void* stream) {
  return entry<Form::kMaxFree>(q, k, v, o, nullptr, BH, L, D, scale, dtype, stream, azula::MaskArgs());
}

// The exact form with the LSE output, lse: float32 (BH, L) contiguous; the
// other arguments as azula_attention_fwd's.
extern "C" int azula_attention_fwd_lse(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                                       int L, int D, float scale, int dtype, void* stream, const void* bias,
                                       int bias_div, int bias_mod, const void* seed, int threshold, float retain) {
  return entry<Form::kLse>(q, k, v, o, static_cast<float*>(lse), BH, L, D, scale, dtype, stream,
                           azula::mask_args(bias, bias_div, bias_mod, seed, threshold, retain));
}
