// Row reads and writes shared by the port's row kernels: float32 and bfloat16
// elements moved one or four at a time (16-byte float32 / 8-byte bfloat16
// vectors), always converted through float32 registers.  Loads go through
// the read-only path (__ldg): callers pass inputs that the kernel does not
// write.  bf16 stores round to nearest even, like Tensor.to(torch.bfloat16).
// The second half holds the shared-memory windows of the banded kernels
// (slab_spmm.cu, slab_attn_fwd.cu): rows kept as 16-byte quads in their own
// type, staged by cp.async.
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

// -- 16-byte quads and the 3R-row window of a banded row block -------------
// Every band edge of a row in block b of R rows has its source in the 3R
// input rows [(b - 1) R, (b + 2) R) (plus a shard's column offset).  A kernel
// that walks the blocks in order keeps them in a ring of three R-row slots
// of shared memory: window block lb = b - 1, b, b + 1 sits in slot
// (lb + 1) % 3, so moving from block b to b + 1 stages one new slot.  A
// window row holds one column chunk of kNQ quads, each 16 bytes of the
// input's own type (4 float32 or 8 bfloat16 elements).

template <typename T> struct Quad { static constexpr int kElems = 16 / sizeof(T); };

// The float32 values of a quad of T elements.
__device__ __forceinline__ void unpack(const uint4& q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(b);
    v[2 * i + 1] = __high2float(b);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Elements [e, e + kElems) of a row at p (zeros at and past fcv) as a quad:
// one 16-byte load where ``vec`` (16-byte aligned rows) and the quad is
// whole, else element by element.
__device__ __forceinline__ unsigned bits_at(const float* p, int i, bool ok) {
  return ok ? __float_as_uint(__ldg(p + i)) : 0u;
}
__device__ __forceinline__ unsigned bits_at(const __nv_bfloat16* p, int i, bool ok) {
  return ok ? (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p) + i) : 0u;
}

template <typename T>
__device__ __forceinline__ uint4 load_quad(const T* __restrict__ p, int e, int fcv, bool vec) {
  constexpr int kE = Quad<T>::kElems;
  if (vec && e + kE <= fcv) return __ldg(reinterpret_cast<const uint4*>(p + e));
  unsigned w[4];
  if constexpr (kE == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bits_at(p, e + i, e + i < fcv);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bits_at(p, e + 2 * i, e + 2 * i < fcv) |
             (bits_at(p, e + 2 * i + 1, e + 2 * i + 1 < fcv) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Window id j in [0, 3R) of row block b (input row (b - 1) R + j, plus the
// offset) is window row ((b + j / R) % 3) R + j % R; b3 = b % 3.  32-bit
// compares, no division: this runs once per edge.
__device__ __forceinline__ int window_index(int j, int R, int b3) {
  const int jb = j >= 2 * R ? 2 : j >= R ? 1 : 0;
  int slot = b3 + jb;
  if (slot >= 3) slot -= 3;
  return slot * R + (j - jb * R);
}

// Stages input rows [q0, q0 + R) (row stride ``stride`` elements), elements
// [col0, col0 + fcv) of each, into window rows [idx0, idx0 + R): 16-byte
// cp.async where ``vec``, 4-byte cp.async for float32 rows that are not
// 16-byte aligned, plain loads for such bfloat16 rows; zeros past fcv and for
// rows outside [0, x_rows).  The caller waits (cp_async_wait_all) and
// synchronises before reading.  stage_rows_at takes each input row's
// pointer from row_at(qr) (a table in parts); stage_rows reads one array.
template <int kNQ, int kThreads, typename T, typename RowAt>
__device__ __forceinline__ void stage_rows_at(uint4* win, int idx0, const RowAt& row_at,
                                              int64_t q0, int R, int64_t x_rows, int64_t col0,
                                              int fcv, bool vec) {
  constexpr int kE = Quad<T>::kElems;
  for (int it = threadIdx.x; it < R * kNQ; it += kThreads) {
    const int row = it / kNQ, q = it % kNQ, e = q * kE;
    uint4* d = win + (idx0 + row) * kNQ + q;
    const int64_t qr = q0 + row;
    if (qr < 0 || qr >= x_rows || e >= fcv) {
      *d = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const T* p = row_at(qr) + col0;
    if (vec && e + kE <= fcv) {
      cp_async16(d, p + e);
    } else if (sizeof(T) == 4) {
      unsigned* dw = reinterpret_cast<unsigned*>(d);
#pragma unroll
      for (int i = 0; i < kE; ++i) {
        if (e + i < fcv) cp_async4(dw + i, p + e + i);
        else dw[i] = 0u;
      }
    } else {
      *d = load_quad(p, e, fcv, false);
    }
  }
}

template <int kNQ, int kThreads, typename T>
__device__ __forceinline__ void stage_rows(uint4* win, int idx0, const T* __restrict__ src,
                                           int64_t q0, int R, int64_t x_rows, int64_t stride,
                                           int64_t col0, int fcv, bool vec) {
  stage_rows_at<kNQ, kThreads, T>(win, idx0, [&](int64_t qr) { return src + qr * stride; },
                                  q0, R, x_rows, col0, fcv, vec);
}

// Team helpers: a team of kT threads (a power of two <= 32, aligned in its
// warp) owns one row.
template <int kT>
__device__ __forceinline__ unsigned team_mask() {
  if constexpr (kT == 32) return 0xffffffffu;
  else return ((1u << kT) - 1u) << (threadIdx.x & 31 & ~(kT - 1));
}
template <int kT, typename V>
__device__ __forceinline__ V from_team(V v, int u) {
  return __shfl_sync(team_mask<kT>(), v, u, kT);
}

}  // namespace row_io
