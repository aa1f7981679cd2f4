// Edge walks and head sums shared by the slab attention kernels
// (slab_attn_fwd.cu, slab_attn_bwd.cu).  A warp owns one node and visits its
// edges 32 ids at a time, one id per lane: from an ELL row of window-local
// ids (column = base + id) or from a CSR slice of global ids.  A ballot drops
// the empty slots at the end and the columns are broadcast with shuffles,
// kUnroll at a time, so that the caller can keep that many row loads in
// flight.  Every lane of the warp takes part in every call.
//
// A row shard's table (Parts) is read where its parts lie: the halo-extended
// rows in three parts of one row type and the remote rows in a packed tail.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;

// A row shard's table of per-node rows in parts (the shard kernels' kParts
// instances): rows [0, lo) in prev, [lo, hi) in own, [hi, band) in next,
// each ``stride`` elements a row (the shard's rows with the R rows before
// and after it: lo = R, hi = n + R, band = n + 2R); rows [band, rows) in a
// tail of remote rows, ``tail_stride`` bytes apart, each a float32 head (the
// node's scalars: alpha_src, or the four stats a head) at byte 0 and the
// row's elements at byte ``tail_off`` (both 16-byte aligned).
struct Parts {
  const void* prev;
  const void* own;
  const void* next;
  const unsigned char* tail;
  int64_t lo, hi, band, rows, tail_stride, tail_off;
};

// Row q of a table in parts (0 <= q < rows).
template <typename T>
__device__ __forceinline__ const T* part_row(const Parts& p, int64_t q, int64_t stride) {
  if (q >= p.band) return reinterpret_cast<const T*>(p.tail + (q - p.band) * p.tail_stride + p.tail_off);
  const void* base = q < p.lo ? p.prev : q < p.hi ? p.own : p.next;
  const int64_t q0 = q < p.lo ? 0 : q < p.hi ? p.lo : p.hi;
  return static_cast<const T*>(base) + (q - q0) * stride;
}

// The float32 head of tail row q (band <= q < rows).
__device__ __forceinline__ const float* tail_head(const Parts& p, int64_t q) {
  return reinterpret_cast<const float*>(p.tail + (q - p.band) * p.tail_stride);
}

// Whether every part's rows of a table in parts start at multiples of
// ``bytes`` (at most 16): the parts' pointers and row strides, the tail's
// offset.
inline bool parts_aligned(const Parts& p, int64_t stride_bytes, int64_t bytes) {
  const auto at = [&](const void* q) { return reinterpret_cast<uintptr_t>(q) % bytes == 0; };
  return stride_bytes % bytes == 0 && at(p.prev) && at(p.own) && at(p.next) &&
         (p.rows == p.band ||
          (at(p.tail) && p.tail_stride % bytes == 0 && p.tail_off % bytes == 0));
}

__device__ __forceinline__ float lrelu(float z, float slope) {
  return z >= 0.0f ? z : slope * z;
}

// v rounded to bfloat16 (to nearest even, like Tensor.to(torch.bfloat16)):
// a band operand of compute_dtype bfloat16.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Calls visit(cc) with cc[u] the column of lane k0 + u's id (-1 where there
// is none) for the ids ``my`` that the lanes hold (-1 = no edge).
template <typename Visit>
__device__ __forceinline__ void visit_lanes(int32_t my, Visit& visit) {
  const unsigned valid = __ballot_sync(kFull, my >= 0);
  const int kend = valid ? 32 - __clz(valid) : 0;
  for (int k0 = 0; k0 < kend; k0 += kUnroll) {
    int32_t cc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cc[u] = __shfl_sync(kFull, my, (k0 + u) & 31);
      if (k0 + u >= kend) cc[u] = -1;
    }
    visit(cc);
  }
}

// The k_width ids of an ELL row, window-local: id j >= 0 is node base + j,
// kept when that lies in [0, n).
template <typename Visit>
__device__ __forceinline__ void ell_edges(int lane, const int32_t* ids, int64_t k_width,
                                          int64_t base, int64_t n, Visit& visit) {
  for (int64_t kc = 0; kc < k_width; kc += 32) {
    int32_t my = -1;
    if (kc + lane < k_width) {
      const int32_t id = ids[kc + lane];
      const int64_t col = base + id;
      if (id >= 0 && col >= 0 && col < n) my = (int32_t)col;
    }
    visit_lanes(my, visit);
  }
}

// The global ids csr[e0:e1), kept when they lie in [0, n).
template <typename Visit>
__device__ __forceinline__ void csr_edges(int lane, const int32_t* csr, int64_t e0,
                                          int64_t e1, int64_t n, Visit& visit) {
  for (int64_t eb = e0; eb < e1; eb += 32) {
    int32_t my = -1;
    if (eb + lane < e1) {
      const int32_t id = csr[eb + lane];
      if (id >= 0 && id < n) my = id;
    }
    visit_lanes(my, visit);
  }
}

// Adds, for each head that elements [c0, c0 + 32 * per) of a row touch, the
// sum of ``part`` over the lanes whose elements lie in that head, into
// out[head] (lane 0 writes; the caller's warp owns ``out``'s row, so plain
// read-modify-writes from one thread are ordered).  ``head`` is the lane's
// head, ``active`` whether it holds elements.
__device__ __forceinline__ void add_head_sums(float part, bool active, int64_t head,
                                              int64_t c0, int per, int64_t f,
                                              int64_t heads, int lane, float* out) {
  const int64_t h0 = c0 / f;
  int64_t h1 = (c0 + 32 * per - 1) / f;
  if (h1 > heads - 1) h1 = heads - 1;
  for (int64_t hh = h0; hh <= h1; ++hh) {
    const float v = warp_sum(active && head == hh ? part : 0.0f);
    if (lane == 0) out[hh] += v;
  }
}

}  // namespace attn
