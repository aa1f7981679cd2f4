// Row reads and writes shared by the port's row kernels: float32 and bfloat16
// elements moved one or four at a time (16-byte float32 / 8-byte bfloat16
// vectors), always converted through float32 registers.  Loads go through
// the read-only path (__ldg): callers pass inputs that the kernel does not
// write.  bf16 stores round to nearest even, like Tensor.to(torch.bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace row_io {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned int*>(&a);
  t.y = *reinterpret_cast<const unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// kPer consecutive elements of a row, kPer = 4 (vector accesses) or 1.
template <int kPer, typename T>
__device__ __forceinline__ void load_row(const T* p, float v[kPer]) {
  if constexpr (kPer == 4) load4(p, v); else v[0] = load1(p);
}

// The same for a row the kernel also writes: plain loads, not __ldg.
template <int kPer, typename T>
__device__ __forceinline__ void load_row_rw(const T* p, float v[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = to_float(p[i]);
}

template <int kPer, typename T>
__device__ __forceinline__ void store_row(T* p, const float v[kPer]) {
  if constexpr (kPer == 4) store4(p, v); else p[0] = from_float<T>(v[0]);
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace row_io
