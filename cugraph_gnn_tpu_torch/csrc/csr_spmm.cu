// CSR SpMM over a destination-sorted COO: for every destination row r,
//   out[r] = (accumulate ? out[r] : 0) + sum_e w[e] * x[cols[e]]
// over the slots e in [rowptr[r], rowptr[r+1]), skipping slots whose column
// is outside [0, n_x) (the -1 padding).  w[e] = 1 when no weights are given.
// x is float32 or bfloat16, out float32 or bfloat16; the sum is taken in
// float32 registers and rounded once, when the row is stored.
//
// Replaces cugraph_gnn_tpu/ops/pallas/spmm_kernel.py::csr_spmm_pallas
// (:90; _spmm_kernel :61), which walks the edge tiles in order on one TPU
// core with one DMA per edge into VMEM.  In the port it also takes the slab
// SpMM's fallback edges (out-of-band and past-max_k), which the JAX package
// sends to XLA's segment_spmm (slab_kernel.py:342-346), in accumulate mode.
//
// Bound on the H100: bytes, and in practice the latency of random row reads.
// A call must read the cols (and weights) once, the row pointer once, each
// distinct source row it needs once, and read (when accumulating) and write
// each output row that has slots once; the arithmetic is one add or FMA per
// element read, far below the card's rate.  chip_smoke.py computes these
// bytes for the slab path's fallback and PERF.md has them beside the time.
// The slab fallback has ~1.1 slots per row, so each row is a chain of
// dependent trips (row pointer, then cols and the output row, then the
// source rows, then the store) that moves a few hundred bytes.
//
// Design (a warp per row, the earlier design, lost to torch.sparse.mm):
// - A group of kG lanes owns a row, sized to the row: kE elements a lane in
//   16-byte vectors (8 bfloat16 or 4 float32; 1 where F or the pointers do
//   not allow it), kV vectors a lane, so F = 128 bf16 is 16 lanes (two rows
//   a warp) and F = 256 bf16 one warp, one pass over the edges.
// - Each group takes kT consecutive rows (two for groups smaller than a
//   warp, else one): one load brings their kT + 1 row pointers, one load up
//   to kG of their slots' columns, and their output rows are read while the
//   source rows load, one at a time.  Groups share nothing: no barrier, and
//   a grid of one block per kT * (256 / kG) rows keeps the card full; with
//   no source rows held back for unrolling a thread needs at most 64
//   registers, so at least four blocks stay resident on a multiprocessor
//   and many rows' random reads are in flight.
// - Rows of more than kLongRow slots (the transposed banded graph's two hub
//   rows collect ~770) are left by their group to a second launch, in which
//   each block scans 4096 rows and takes each long one with all its groups:
//   each group sums a fixed contiguous share of the slots into shared
//   memory, and the shares are added in group order.
// No atomics anywhere: each output row is written by one group or one
// block, and every sum runs in a fixed order, so two launches agree bit for
// bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kLongRow = 64;   // rows with more slots are split over a block

// kE consecutive elements of a source row (read-only path)
template <int kE, typename T>
__device__ __forceinline__ void load_x(const T* p, float* v) {
  if constexpr (kE == 8) {
    static_assert(sizeof(T) == 2, "8-element vectors are bfloat16 rows");
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned int u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u[i]);
      v[2 * i] = __low2float(b);
      v[2 * i + 1] = __high2float(b);
    }
  } else {
    row_io::load_row<kE>(p, v);
  }
}

// kE consecutive elements of an output row, read before accumulating
template <int kE, typename T>
__device__ __forceinline__ void load_out(const T* p, float* v) {
  if constexpr (kE >= 4 && sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < kE; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (kE == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const unsigned int u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u[i]);
      v[2 * i] = __low2float(b);
      v[2 * i + 1] = __high2float(b);
    }
  } else {
    row_io::load_row_rw<kE>(p, v);
  }
}

template <int kE, typename T>
__device__ __forceinline__ void store_out(T* p, const float* v) {
  if constexpr (kE >= 4 && sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < kE; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (kE == 8) {
    uint4 t;
    unsigned int* u = reinterpret_cast<unsigned int*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned int*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = t;
  } else {
    row_io::store_row<kE>(p, v);
  }
}

// The tile sizes of one configuration: kT rows a group, kW elements a pass
// over a row.  Two rows a group where a group is less than a warp (four rows
// a warp), else one; a group adds one source row at a time.  On the H100
// four rows a group, or two or four source rows loaded before they are
// added, were slower at F = 128 and 256 bf16: registers bound the warps
// resident, and resident warps keep more rows in flight than unrolling.
template <int kE, int kG, int kV>
struct Tile {
  static constexpr int kPerLane = kV * kE;
  static constexpr int kT = kPerLane >= 16 || kG == 32 ? 1 : 2;
  static constexpr int kW = kG * kPerLane;
  static constexpr int kGroups = kThreads / kG;
};

// Adds w * x[col] over the slots [s0, s1) into acc[t], t the slot's row
// among the group's rows (rp[t] <= slot < rp[t + 1]); rows whose bit is set
// in ``skip`` are left out.  Elements [c0, c0 + kW) of each row, lane
// ``lane`` holding elements c0 + (v * kG + lane) * kE + [0, kE).  Every lane
// of the group takes part.
template <int kE, int kG, int kV, int kT, typename TX>
__device__ __forceinline__ void add_slots(
    const TX* __restrict__ x, int64_t n_x, const int32_t* __restrict__ cols,
    const float* __restrict__ w, int64_t s0, int64_t s1, const int64_t (&rp)[kT + 1],
    unsigned skip, int64_t c0, int64_t f, int lane, unsigned gmask,
    float (&acc)[kT][kV * kE]) {
  for (int64_t eb = s0; eb < s1; eb += kG) {
    const int64_t slot = eb + lane;
    int32_t my_c = -1;
    float my_w = 1.0f;
    int my_t = 0;
    if (slot < s1) {
#pragma unroll
      for (int i = 1; i < kT; ++i) my_t += slot >= rp[i];
      if (!((skip >> my_t) & 1u)) {
        const int32_t c = cols[slot];
        if (c >= 0 && c < n_x) {
          my_c = c;
          if (w != nullptr) my_w = w[slot];
        }
      }
    }
    const int cnt = (int)(s1 - eb < kG ? s1 - eb : kG);
    for (int k = 0; k < cnt; ++k) {
      const int32_t c = __shfl_sync(gmask, my_c, k, kG);
      const float wk = __shfl_sync(gmask, my_w, k, kG);
      const int tk = __shfl_sync(gmask, my_t, k, kG);
      if (c < 0) continue;
      float v[kV * kE];
#pragma unroll
      for (int vv = 0; vv < kV; ++vv) {
        const int64_t j = c0 + (int64_t)(vv * kG + lane) * kE;
        if (j < f) load_x<kE>(x + (int64_t)c * f + j, &v[vv * kE]);
      }
#pragma unroll
      for (int vv = 0; vv < kV; ++vv) {
        const int64_t j = c0 + (int64_t)(vv * kG + lane) * kE;
        if (j >= f) continue;
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          if (tk != t) continue;
#pragma unroll
          for (int p = 0; p < kE; ++p)
            acc[t][vv * kE + p] = fmaf(wk, v[vv * kE + p], acc[t][vv * kE + p]);
        }
      }
    }
  }
}

template <typename TX, typename TOut, int kE, int kG, int kV>
__global__ void __launch_bounds__(kThreads)
csr_spmm_rows_kernel(const TX* __restrict__ x, int64_t n_x,
                     const int32_t* __restrict__ cols, const float* __restrict__ w,
                     const int64_t* __restrict__ rowptr, TOut* __restrict__ out,
                     int64_t n_rows, int64_t f, bool accumulate) {
  using C = Tile<kE, kG, kV>;
  constexpr int kT = C::kT, kW = C::kW;
  const int lane = threadIdx.x % kG;
  const unsigned gmask =
      kG == 32 ? 0xffffffffu : ((1u << kG) - 1u) << ((threadIdx.x & 31) / kG * kG);
  const int64_t r0 = ((int64_t)blockIdx.x * C::kGroups + threadIdx.x / kG) * kT;
  if (r0 >= n_rows) return;   // the same in the whole group
  // lane i <= kT holds rowptr[r0 + i]
  const int64_t ri = r0 + lane;
  const int64_t my_rp = lane <= kT ? rowptr[ri < n_rows ? ri : n_rows] : 0;
  int64_t rp[kT + 1];
#pragma unroll
  for (int i = 0; i <= kT; ++i) rp[i] = __shfl_sync(gmask, my_rp, i, kG);
  unsigned skip = 0;   // long rows (the long-row kernel's) and rows past the end
#pragma unroll
  for (int t = 0; t < kT; ++t)
    if (r0 + t >= n_rows || rp[t + 1] - rp[t] > kLongRow) skip |= 1u << t;

  for (int64_t c0 = 0; c0 < f; c0 += kW) {
    float acc[kT][kV * kE];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const bool load = accumulate && !((skip >> t) & 1u) && rp[t + 1] > rp[t];
#pragma unroll
      for (int vv = 0; vv < kV; ++vv) {
        const int64_t j = c0 + (int64_t)(vv * kG + lane) * kE;
        if (load && j < f) {
          load_out<kE>(out + (r0 + t) * f + j, &acc[t][vv * kE]);
        } else {
#pragma unroll
          for (int p = 0; p < kE; ++p) acc[t][vv * kE + p] = 0.0f;
        }
      }
    }
    add_slots<kE, kG, kV, kT>(x, n_x, cols, w, rp[0], rp[kT], rp, skip, c0, f, lane,
                              gmask, acc);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if ((skip >> t) & 1u) continue;
      if (accumulate && rp[t + 1] == rp[t]) continue;   // nothing added
#pragma unroll
      for (int vv = 0; vv < kV; ++vv) {
        const int64_t j = c0 + (int64_t)(vv * kG + lane) * kE;
        if (j < f) store_out<kE>(out + (r0 + t) * f + j, &acc[t][vv * kE]);
      }
    }
  }
}

// Rows of more than kLongRow slots: each block scans kScanRows rows and
// takes every long one among them with all its groups, each group summing
// a fixed contiguous share of the slots into shared memory; the shares are
// added in group order.
constexpr int64_t kScanRows = 4096;

template <typename TX, typename TOut, int kE, int kG, int kV>
__global__ void __launch_bounds__(kThreads)
csr_spmm_long_kernel(const TX* __restrict__ x, int64_t n_x,
                     const int32_t* __restrict__ cols, const float* __restrict__ w,
                     const int64_t* __restrict__ rowptr, TOut* __restrict__ out,
                     int64_t n_rows, int64_t f, bool accumulate) {
  using C = Tile<kE, kG, kV>;
  constexpr int kW = C::kW, kGroups = C::kGroups;
  extern __shared__ float part[];   // kGroups * kW
  const int lane = threadIdx.x % kG, grp = threadIdx.x / kG;
  const unsigned gmask =
      kG == 32 ? 0xffffffffu : ((1u << kG) - 1u) << ((threadIdx.x & 31) / kG * kG);
  const int64_t first = (int64_t)blockIdx.x * kScanRows;
  const int64_t last = first + kScanRows < n_rows ? first + kScanRows : n_rows;
  for (int64_t s0 = first; s0 < last; s0 += kThreads) {
    const int64_t mine = s0 + threadIdx.x;
    const bool is_long = mine < last && rowptr[mine + 1] - rowptr[mine] > kLongRow;
    if (!__syncthreads_or(is_long)) continue;
    for (int64_t r = s0; r < s0 + kThreads && r < last; ++r) {
      const int64_t e0 = rowptr[r], e1 = rowptr[r + 1], len = e1 - e0;
      if (len <= kLongRow) continue;   // the same in every thread
      const int64_t rp1[2] = {e0 + len * grp / kGroups, e0 + len * (grp + 1) / kGroups};
      for (int64_t c0 = 0; c0 < f; c0 += kW) {
        float acc[1][kV * kE];
#pragma unroll
        for (int p = 0; p < kV * kE; ++p) acc[0][p] = 0.0f;
        add_slots<kE, kG, kV, 1>(x, n_x, cols, w, rp1[0], rp1[1], rp1, 0u, c0, f, lane,
                                 gmask, acc);
#pragma unroll
        for (int vv = 0; vv < kV; ++vv)
#pragma unroll
          for (int p = 0; p < kE; ++p)
            part[grp * kW + (vv * kG + lane) * kE + p] = acc[0][vv * kE + p];
        __syncthreads();
        for (int j = threadIdx.x; j < kW && c0 + j < f; j += kThreads) {
          TOut* o = out + r * f + c0 + j;
          float s = accumulate ? row_io::to_float(*o) : 0.0f;
          for (int gi = 0; gi < kGroups; ++gi) s += part[gi * kW + j];
          *o = row_io::from_float<TOut>(s);
        }
        __syncthreads();   // part is read before the next share is written
      }
    }
  }
}

template <typename TX, typename TOut, int kE, int kG, int kV>
int launch_cfg(const void* x, int64_t n_x, const void* cols, const void* w,
               const void* rowptr, void* out, int64_t n_rows, int64_t f,
               bool accumulate, cudaStream_t stream) {
  using C = Tile<kE, kG, kV>;
  const TX* xp = static_cast<const TX*>(x);
  const int32_t* cp = static_cast<const int32_t*>(cols);
  const float* wp = static_cast<const float*>(w);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  TOut* op = static_cast<TOut*>(out);
  const int64_t tile_rows = (int64_t)C::kGroups * C::kT;
  csr_spmm_rows_kernel<TX, TOut, kE, kG, kV>
      <<<(unsigned)((n_rows + tile_rows - 1) / tile_rows), kThreads, 0, stream>>>(
          xp, n_x, cp, wp, rp, op, n_rows, f, accumulate);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t smem = sizeof(float) * C::kGroups * C::kW;
  csr_spmm_long_kernel<TX, TOut, kE, kG, kV>
      <<<(unsigned)((n_rows + kScanRows - 1) / kScanRows), kThreads, smem, stream>>>(
          xp, n_x, cp, wp, rp, op, n_rows, f, accumulate);
  return (int)cudaGetLastError();
}

// The group size and vectors a lane for F elements in vectors of kE.
template <typename TX, typename TOut, int kE>
int launch_e(const void* x, int64_t n_x, const void* cols, const void* w,
             const void* rowptr, void* out, int64_t n_rows, int64_t f,
             bool accumulate, cudaStream_t stream) {
  const int64_t nvec = (f + kE - 1) / kE;
#define CSR_LAUNCH(G, V)                                                              \
  return launch_cfg<TX, TOut, kE, G, V>(x, n_x, cols, w, rowptr, out, n_rows, f, \
                                        accumulate, stream)
  if constexpr (kE > 1) {
    if (nvec <= 8) CSR_LAUNCH(8, 1);
    if (nvec <= 16) CSR_LAUNCH(16, 1);
  }
  if (nvec <= 32) CSR_LAUNCH(32, 1);
  if (nvec <= 64) CSR_LAUNCH(32, 2);
  CSR_LAUNCH(32, 4);   // wider rows take several passes
#undef CSR_LAUNCH
}

template <typename TX, typename TOut>
int launch(const void* x, int64_t n_x, const void* cols, const void* w,
           const void* rowptr, void* out, int64_t n_rows, int64_t f,
           bool accumulate, cudaStream_t stream) {
  const bool aligned = row_io::aligned(x, 16) && row_io::aligned(out, 16);
  if constexpr (sizeof(TX) == 2) {
    if (aligned && f % 8 == 0)
      return launch_e<TX, TOut, 8>(x, n_x, cols, w, rowptr, out, n_rows, f, accumulate,
                                   stream);
  } else {
    if (aligned && f % 4 == 0)
      return launch_e<TX, TOut, 4>(x, n_x, cols, w, rowptr, out, n_rows, f, accumulate,
                                   stream);
  }
  return launch_e<TX, TOut, 1>(x, n_x, cols, w, rowptr, out, n_rows, f, accumulate, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  cols int32 (n_slots), weights
// float32 (n_slots) or null, rowptr int64 (n_rows + 1), out (n_rows, f).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int csr_spmm(const void* x, int x_dtype, int64_t n_x, const void* cols,
                        const void* weights, const void* rowptr, void* out,
                        int out_dtype, int64_t n_rows, int64_t f, int accumulate,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool acc = accumulate != 0;
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, n_x, cols, weights, rowptr, out, n_rows, f, acc, s);
  if (x_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, n_x, cols, weights, rowptr, out, n_rows, f, acc, s);
  if (x_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, n_x, cols, weights, rowptr, out, n_rows, f, acc, s);
  if (x_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, n_x, cols, weights, rowptr, out, n_rows,
                                                f, acc, s);
  return (int)cudaErrorInvalidValue;
}
