// Error text for the status codes that the kernels' C entry points return,
// and the tensor-map encoder of the tensor-core kernels (hopper.cuh).
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstring>
#include <mutex>

#include "hopper.cuh"

extern "C" const char* azula_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

namespace azula {
namespace hopper {

namespace {

// cuTensorMapEncodeTiled of the driver library that the CUDA runtime loaded
// (looked up at run time, so that the library links without -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// what a map encodes, as words without padding, so that keys compare bytewise
struct Key {
  uintptr_t x;
  int64_t rank;
  int64_t dims[5];
  int64_t strides[4];
  int64_t box[5];
};

}  // namespace

bool encode_map(CUtensorMap* map, const void* x, int rank, const int64_t* dims, const int64_t* strides,
                const int* box) {
  struct Entry {
    CUtensorMap map;
    Key key;
  };
  constexpr int kEntries = 64;
  static Entry table[kEntries] = {};
  static std::mutex lock;

  if (rank < 3 || rank > 5 || (box[0] != 32 && box[0] != 64)) return false;
  Key key = {};
  key.x = reinterpret_cast<uintptr_t>(x);
  key.rank = rank;
  uint64_t h = key.x >> 8;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.strides[i] = strides[i];
    h = h * 40503u ^ static_cast<uint64_t>(dims[i]) ^ static_cast<uint64_t>(box[i]) << 20;
  }
  Entry& entry = table[h % kEntries];
  {
    const std::lock_guard<std::mutex> guard(lock);
    if (std::memcmp(&entry.key, &key, sizeof(Key)) == 0) {
      *map = entry.map;
      return true;
    }
  }

  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[5], st[4];
  cuuint32_t b[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    unit[i] = 1;
    if (i + 1 < rank) st[i] = static_cast<cuuint64_t>(strides[i]);
  }
  const CUtensorMapSwizzle swizzle = box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank), const_cast<void*>(x), d, st, b, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }

  const std::lock_guard<std::mutex> guard(lock);
  entry = {*map, key};
  return true;
}

bool encode_panels(CUtensorMap* map, const void* x, int BH, int L, int D, int panel, int rows) {
  const int64_t dims[3] = {D, L, BH};
  const int64_t strides[2] = {static_cast<int64_t>(D) * 2, static_cast<int64_t>(L) * D * 2};
  const int box[3] = {panel, rows, 1};
  return encode_map(map, x, 3, dims, strides, box);
}

bool encode_heads(CUtensorMap* map, const void* x, int B, int L, int H, int D, int panel, int rows) {
  const int64_t C = static_cast<int64_t>(H) * D;
  const int64_t dims[3] = {C, L, B};
  const int64_t strides[2] = {C * 2, static_cast<int64_t>(L) * C * 2};
  const int box[3] = {panel, rows, 1};
  return encode_map(map, x, 3, dims, strides, box);
}

}  // namespace hopper
}  // namespace azula
