// Slab SpMM, band part: for every row r < n of a banded graph,
//   out[r] = sum_k w[r,k] * x[(r / R) * R - R + col_offset + ell[r,k]]
// over the ELL entries ell[r,k] >= 0 whose x row lies in [0, x_rows); w = 1
// for an unweighted graph.  A whole graph passes col_offset 0 and x_rows n.
// A row shard passes its x with one R-row halo on each side (x_rows = n + 2R)
// and col_offset R, so its local row r reads x row (r / R) * R + ell[r,k].
// x is float32 or bfloat16; out is float32, summed in float32 registers.
// With round_bf16 (compute dtype bfloat16) every x element and weight is
// rounded to bfloat16 before it is used, as the MXU's operands are in the JAX
// package.  The fallback edges, the mean divide and the cast to x's dtype are
// the caller's (slab_kernel.py, ops/dist_full_batch.py).
//
// Replaces cugraph_gnn_tpu/ops/pallas/slab_kernel.py::slab_spmm (:267;
// pallas_call :333 over _slab_bits_kernel :198 and _slab_kernel :177) and,
// with the shard offset, the per-shard band kernel of
// cugraph_gnn_tpu/ops/dist_full_batch.py::_shard_spmm_body (:178; pallas_call
// :218 over the same kernels at G = 1 on the halo-extended x).  The
// TPU design multiplies a 0/1 (R, 3R) block, decoded from bit planes, with
// the block's 3R-row window of x on the MXU, G blocks stacked to fit 16 MB of
// VMEM.  None of that carries over: the window (3R x F = 768 rows x 512 B =
// 393 KB at R = 256, F = 128 f32) does not fit a block's 227 KB of shared
// memory, and a dense (R, 3R) product would spend 3R/K (48x at K = 16) more
// operations than there are edges.
//
// Bound on the H100: bytes.  A call must read the ELL once (n_pad x K int32:
// 157 MB at 2,449,408 x 16), x once and write out once; at F = 128 float32
// that is ~2.67 GB, ~0.80 ms at 3.35 TB/s.  The arithmetic is one add (FMA
// when weighted) per edge and element, ~4 GFLOP at that shape, three orders
// below the card's rate.
//
// Design: one warp per row, reading the ELL (64 B a row at K = 16, against
// 128 B for the TPU's bit planes, and one body serves weighted graphs), so
// the bit planes are never moved to the device; SlabGraph keeps them on the
// host for the array-equality tests.  Each lane holds one of up to 32 ELL
// ids, a ballot finds the valid ones (deduplication leaves holes), and the
// columns are broadcast with shuffles; for each, every lane loads 4
// consecutive elements (16-byte float32 / 8-byte bfloat16 vectors where
// F % 4 == 0 and the pointers are aligned, else 1), so a 128-wide float32 row
// is one coalesced 512-byte read, with four rows in flight per warp.
// Neighboring warps take neighboring rows, whose windows overlap, so the
// three-fold re-read of each x row that the window implies is served by the
// 50 MB L2 and x crosses device memory about once.  No atomics: each row's
// sum has a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename TX, bool kWeighted, bool kRound, int kPer>
__global__ void __launch_bounds__(kThreads)
slab_band_kernel(const TX* __restrict__ x, int64_t n, int64_t col_offset,
                 int64_t x_rows, const int32_t* __restrict__ ell,
                 const float* __restrict__ ell_w, int64_t k_width, int64_t block_rows,
                 float* __restrict__ out, int64_t f) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       r < n; r += stride) {
    const int64_t base = (r / block_rows) * block_rows - block_rows + col_offset;
    const int32_t* ids = ell + r * k_width;
    const float* ws = kWeighted ? ell_w + r * k_width : nullptr;
    float* dst = out + r * f;
    for (int64_t c0 = 0; c0 < f; c0 += 32 * kPer) {
      const int64_t j = c0 + kPer * lane;
      const bool active = j < f;
      float acc[kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p) acc[p] = 0.0f;
      for (int64_t kc = 0; kc < k_width; kc += 32) {
        int32_t my_c = -1;
        float my_w = 1.0f;
        if (kc + lane < k_width) {
          const int32_t id = ids[kc + lane];
          const int64_t col = base + id;
          // a real entry is never outside [0, x_rows); guard as the TPU
          // kernel's clamped window blocks do
          if (id >= 0 && col >= 0 && col < x_rows) {
            my_c = (int32_t)col;
            if (kWeighted) my_w = kRound ? round_bf16(ws[kc + lane]) : ws[kc + lane];
          }
        }
        const unsigned valid = __ballot_sync(kFull, my_c >= 0);
        const int kend = valid ? 32 - __clz(valid) : 0;
        for (int k0 = 0; k0 < kend; k0 += kUnroll) {
          int32_t cc[kUnroll];
          float ww[kUnroll];
          float v[kUnroll][kPer];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            cc[u] = __shfl_sync(kFull, my_c, (k0 + u) & 31);
            ww[u] = kWeighted ? __shfl_sync(kFull, my_w, (k0 + u) & 31) : 1.0f;
            if (k0 + u >= kend) cc[u] = -1;
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
              for (int p = 0; p < kPer; ++p) {
                const float xv = kRound ? round_bf16(v[u][p]) : v[u][p];
                acc[p] = kWeighted ? fmaf(ww[u], xv, acc[p]) : acc[p] + xv;
              }
            }
          }
        }
      }
      if (active) row_io::store_row<kPer>(dst + j, acc);
    }
  }
}

template <typename TX, bool kWeighted, bool kRound>
int launch(const void* x, int64_t n, int64_t col_offset, int64_t x_rows, const void* ell,
           const void* ell_w, int64_t k_width, int64_t block_rows, void* out, int64_t f,
           cudaStream_t stream) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the row loop strides over the rest
  const bool vec = f % 4 == 0 && row_io::aligned(x, 4 * sizeof(TX)) &&
                   row_io::aligned(out, 4 * sizeof(float));
  const TX* xp = static_cast<const TX*>(x);
  const int32_t* ep = static_cast<const int32_t*>(ell);
  const float* wp = static_cast<const float*>(ell_w);
  float* op = static_cast<float*>(out);
  if (vec)
    slab_band_kernel<TX, kWeighted, kRound, 4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, n, col_offset, x_rows, ep, wp, k_width, block_rows, op, f);
  else
    slab_band_kernel<TX, kWeighted, kRound, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, n, col_offset, x_rows, ep, wp, k_width, block_rows, op, f);
  return (int)cudaGetLastError();
}

template <typename TX, bool kRound>
int launch_w(const void* x, int64_t n, int64_t col_offset, int64_t x_rows, const void* ell,
             const void* ell_w, int64_t k_width, int64_t block_rows, void* out, int64_t f,
             cudaStream_t stream) {
  if (ell_w != nullptr)
    return launch<TX, true, kRound>(x, n, col_offset, x_rows, ell, ell_w, k_width,
                                    block_rows, out, f, stream);
  return launch<TX, false, kRound>(x, n, col_offset, x_rows, ell, ell_w, k_width,
                                   block_rows, out, f, stream);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  x (x_rows, f); ell int32 (>= n rows,
// k_width), ell_w float32 (>= n rows, k_width) or null, out float32 (n, f).
// col_offset: 0 for a whole graph, block_rows for a shard's halo-extended x.
// round_bf16 rounds x (a no-op for bfloat16 x) and the weights to bfloat16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int slab_spmm(const void* x, int x_dtype, int64_t n, int64_t col_offset,
                         int64_t x_rows, const void* ell, const void* ell_w,
                         int64_t k_width, int64_t block_rows, int round_bf16, void* out,
                         int64_t f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && round_bf16)
    return launch_w<float, true>(x, n, col_offset, x_rows, ell, ell_w, k_width, block_rows, out, f, s);
  if (x_dtype == 0)
    return launch_w<float, false>(x, n, col_offset, x_rows, ell, ell_w, k_width, block_rows, out, f, s);
  if (x_dtype == 1 && round_bf16)
    return launch_w<__nv_bfloat16, true>(x, n, col_offset, x_rows, ell, ell_w, k_width, block_rows, out, f, s);
  if (x_dtype == 1)
    return launch_w<__nv_bfloat16, false>(x, n, col_offset, x_rows, ell, ell_w, k_width, block_rows, out, f, s);
  return (int)cudaErrorInvalidValue;
}
