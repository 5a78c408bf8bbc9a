// Helpers shared by the kernels: conversion between the storage type and
// float32, and vector loads and stores of N consecutive elements.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace azula {

// dtype codes passed by the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// N elements moved as one aligned access (16 bytes for 8 bf16 or 4 float).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&out)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(pk.v[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&in)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int i = 0; i < N; ++i) pk.v[i] = from_float<T>(in[i]);
  *reinterpret_cast<Pack<T, N>*>(p) = pk;
}

}  // namespace azula
