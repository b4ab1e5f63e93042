// Helpers shared by the forward (forward.cu) and backward (backward.cu)
// kernels: storage-type conversions and vector loads and stores of row
// slices.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace cuembed {

constexpr int kThreads = 256;  // threads per block (the forward kernels' most)

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int BYTES>
struct RawVec;
template <>
struct RawVec<16> {
  using type = uint4;
};
template <>
struct RawVec<8> {
  using type = uint2;
};
template <>
struct RawVec<4> {
  using type = unsigned int;
};
template <>
struct RawVec<2> {
  using type = unsigned short;
};

// BYTES of a row, as one load: N elements of T.
template <typename T, int BYTES>
struct Vec {
  static constexpr int N = BYTES / static_cast<int>(sizeof(T));
  using Raw = typename RawVec<BYTES>::type;

  // Through the read-only cache: for data no thread writes in this kernel.
  __device__ __forceinline__ static Raw load(const T* p) {
    return __ldg(reinterpret_cast<const Raw*>(p));
  }
  // A plain load, for a row this kernel also writes.
  __device__ __forceinline__ static Raw load_rw(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float (&v)[N]) {
    T e[N];
    memcpy(e, &r, BYTES);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_float(e[i]);
  }
  __device__ __forceinline__ static void store(T* p, const float (&v)[N]) {
    T e[N];
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_float<T>(v[i]);
    Raw r;
    memcpy(&r, e, BYTES);
    *reinterpret_cast<Raw*>(p) = r;
  }
};

}  // namespace cuembed
