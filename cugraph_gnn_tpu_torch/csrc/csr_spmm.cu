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
//
// Design: one warp per destination row, so no two warps write one row: no
// atomics, and the sum order is fixed (slot order), hence deterministic.  The
// warp reads 32 slots' columns at a time (one per lane) and broadcasts them
// with shuffles; for each, every lane loads 4 consecutive elements (16-byte
// float32 / 8-byte bfloat16 vectors where F % 4 == 0 and the pointers are
// aligned, else 1), so a 128-wide float32 row is one coalesced 512-byte read.
// Four source rows are loaded before any is added, to keep several random
// reads in flight per warp; 64 resident warps per SM add the rest.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename TX, typename TOut, bool kWeighted, int kPer>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const TX* __restrict__ x, int64_t n_x,
                const int32_t* __restrict__ cols, const float* __restrict__ w,
                const int64_t* __restrict__ rowptr, TOut* __restrict__ out,
                int64_t n_rows, int64_t f, bool accumulate) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       r < n_rows; r += stride) {
    const int64_t e0 = rowptr[r];
    const int64_t e1 = rowptr[r + 1];
    if (accumulate && e0 >= e1) continue;  // warp-uniform: nothing to add
    TOut* dst = out + r * f;
    for (int64_t c0 = 0; c0 < f; c0 += 32 * kPer) {
      const int64_t j = c0 + kPer * lane;
      const bool active = j < f;
      float acc[kPer];
      if (accumulate && active) {
        row_io::load_row_rw<kPer>(dst + j, acc);
      } else {
#pragma unroll
        for (int p = 0; p < kPer; ++p) acc[p] = 0.0f;
      }
      for (int64_t eb = e0; eb < e1; eb += 32) {
        const int cnt = (int)(e1 - eb < 32 ? e1 - eb : 32);
        int32_t my_c = -1;
        float my_w = 1.0f;
        if (lane < cnt) {
          const int32_t c = cols[eb + lane];
          if (c >= 0 && c < n_x) {
            my_c = c;
            if (kWeighted) my_w = w[eb + lane];
          }
        }
        for (int k0 = 0; k0 < cnt; k0 += kUnroll) {
          int32_t cc[kUnroll];
          float ww[kUnroll];
          float v[kUnroll][kPer];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            cc[u] = __shfl_sync(kFull, my_c, (k0 + u) & 31);
            ww[u] = kWeighted ? __shfl_sync(kFull, my_w, (k0 + u) & 31) : 1.0f;
            if (k0 + u >= cnt) cc[u] = -1;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (active && cc[u] >= 0) {
              row_io::load_row<kPer>(x + (int64_t)cc[u] * f + j, v[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (active && cc[u] >= 0) {
#pragma unroll
              for (int p = 0; p < kPer; ++p)
                acc[p] = kWeighted ? fmaf(ww[u], v[u][p], acc[p]) : acc[p] + v[u][p];
            }
          }
        }
      }
      if (active) row_io::store_row<kPer>(dst + j, acc);
    }
  }
}

template <typename TX, typename TOut, bool kWeighted>
int launch(const void* x, int64_t n_x, const void* cols, const void* w,
           const void* rowptr, void* out, int64_t n_rows, int64_t f,
           bool accumulate, cudaStream_t stream) {
  int64_t blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the row loop strides over the rest
  const bool vec = f % 4 == 0 && row_io::aligned(x, 4 * sizeof(TX)) &&
                   row_io::aligned(out, 4 * sizeof(TOut));
  const TX* xp = static_cast<const TX*>(x);
  const int32_t* cp = static_cast<const int32_t*>(cols);
  const float* wp = static_cast<const float*>(w);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  TOut* op = static_cast<TOut*>(out);
  if (vec)
    csr_spmm_kernel<TX, TOut, kWeighted, 4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, n_x, cp, wp, rp, op, n_rows, f, accumulate);
  else
    csr_spmm_kernel<TX, TOut, kWeighted, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, n_x, cp, wp, rp, op, n_rows, f, accumulate);
  return (int)cudaGetLastError();
}

template <typename TX, typename TOut>
int launch_w(const void* x, int64_t n_x, const void* cols, const void* w,
             const void* rowptr, void* out, int64_t n_rows, int64_t f,
             bool accumulate, cudaStream_t stream) {
  if (w != nullptr)
    return launch<TX, TOut, true>(x, n_x, cols, w, rowptr, out, n_rows, f, accumulate, stream);
  return launch<TX, TOut, false>(x, n_x, cols, w, rowptr, out, n_rows, f, accumulate, stream);
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
    return launch_w<float, float>(x, n_x, cols, weights, rowptr, out, n_rows, f, acc, s);
  if (x_dtype == 0 && out_dtype == 1)
    return launch_w<float, __nv_bfloat16>(x, n_x, cols, weights, rowptr, out, n_rows, f, acc, s);
  if (x_dtype == 1 && out_dtype == 0)
    return launch_w<__nv_bfloat16, float>(x, n_x, cols, weights, rowptr, out, n_rows, f, acc, s);
  if (x_dtype == 1 && out_dtype == 1)
    return launch_w<__nv_bfloat16, __nv_bfloat16>(x, n_x, cols, weights, rowptr, out, n_rows, f, acc, s);
  return (int)cudaErrorInvalidValue;
}
