// Slab SpMM: for every row r < n of a banded graph, the whole function
//   out[r] = (sum_k w[r,k] x[(r / R) * R - R + col_offset + ell[r,k]]
//             + sum_e fb_w[e] x[fb_src[e]]) / max(degree[r], 1)
// over the row's ELL entries (ids >= 0 whose x row lies in [0, x_rows)) and
// its fallback slots e in [fb_rowptr[r], fb_rowptr[r + 1]), the divide for
// 'mean' only, rounded once to the output type.  w = 1 for an unweighted
// graph.  A whole graph passes col_offset 0 and x_rows n; the band-only mode
// (float32 output, no fallback, no divide) also a row shard's x with one
// R-row halo on each side (x_rows = n + 2R) and col_offset R (the sharded
// graph's balanced plan; a shard's whole function is slab_spmm_shard.cu).
// x is float32 or bfloat16; the output float32 or x's type; every sum is
// float32.  With round_bf16 (compute dtype bfloat16) the band's x elements
// and weights are rounded to bfloat16 before they are used, as the MXU's
// operands are in the JAX package; the fallback terms use x as it is.  The
// band is summed in ELL order, then the fallback in CSR order, then divided
// and rounded once (the plain version, slab_kernel.py, sums the fallback
// apart and adds it to the band: the same terms in another order).
//
// Replaces cugraph_gnn_tpu/ops/pallas/slab_kernel.py::slab_spmm (:267;
// pallas_call :333 over _slab_bits_kernel :198 and _slab_kernel :177, then
// the fallback segment sum, the 'mean' divide and the cast, :341-354) and,
// band only with the shard offset, the per-shard band kernel of
// cugraph_gnn_tpu/ops/dist_full_batch.py::_shard_spmm_body (:178;
// pallas_call :218) in its balanced plan.  The TPU kernel multiplies a 0/1
// (R, 3R) block with the block's 3R-row window of x on the MXU, G blocks
// stacked in VMEM so that neighbouring windows share their rows; the rest of
// the function is XLA passes over (N, F).
//
// Bound on the H100: bytes.  A call must read the ELL's real entries, x once
// (the fallback's source rows are rows of x), the fallback row pointer and
// ids and the degrees ('mean'), and write the output once in its type: for
// the three calls of a GraphSAGE step at 2,449,029 nodes (bf16; graph F =
// 128, graph F = 256, transpose F = 256) ~6.7 GB, ~2.01 ms at 3.35 TB/s
// (chip_smoke.py counts each call's bytes).  The arithmetic is one FMA per
// edge and element, three orders below the card's rate.
//
// Design: the window kernel of slab_spmm.cuh (a 3R-row window of one column
// chunk in shared memory, a team of threads a row, no atomics).  The
// band-only mode (float32 output, no fallback, no divide: slab_spmm_band
// and the row shards' slab_spmm_band_shard) keeps the first design, one warp
// a row reading its sources through the 50 MB L2: on the H100 it ran the
// three calls of a step in 1.52 + 2.74 + 3.36 ms against 2.33 + 4.36 + 4.57
// for the window kernel's band-only mode, whose staging, band sums and
// float32 stores add up instead of overlapping (PERF.md §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_io.cuh"
#include "slab_spmm.cuh"

namespace {

// -- the band-only mode: one warp a row, sources read through the L2 --------
// (the window kernel's band-only mode measured slower on the H100: its
// float32 output and its staging do not overlap the band sums; see the
// header)
constexpr int kBandThreads = 256;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kUnroll = 4;   // source rows in flight a lane
constexpr unsigned kFull = 0xffffffffu;

template <typename TX, bool kWeighted, bool kRound, int kPer>
__global__ void __launch_bounds__(kBandThreads) band_rows_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const TX* x = static_cast<const TX*>(a.x);
  float* out = static_cast<float*>(a.out);
  const int64_t stride = (int64_t)gridDim.x * kBandWarps;
  for (int64_t r = (int64_t)blockIdx.x * kBandWarps + (threadIdx.x >> 5); r < a.n; r += stride) {
    const int64_t base = (r / a.R) * a.R - a.R + a.col_offset;
    const int32_t* ids = a.ell + r * a.k_width;
    const float* ws = kWeighted ? a.ell_w + r * a.k_width : nullptr;
    for (int64_t c0 = 0; c0 < a.f; c0 += 32 * kPer) {
      const int64_t j = c0 + kPer * lane;
      const bool active = j < a.f;
      float acc[kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p) acc[p] = 0.0f;
      // every slot of the row (its length would be one more dependent load)
      for (int64_t kc = 0; kc < a.k_width; kc += 32) {
        int32_t my_c = -1;
        float my_w = 1.0f;
        if (kc + lane < a.k_width) {
          const int32_t id = ids[kc + lane];
          const int64_t col = base + id;
          if (id >= 0 && col >= 0 && col < a.x_rows) {
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
          for (int u = 0; u < kUnroll; ++u)
            if (active && cc[u] >= 0) row_io::load_row<kPer>(x + (int64_t)cc[u] * a.f + j, v[u]);
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
      if (active) row_io::store_row<kPer>(out + r * a.f + j, acc);
    }
  }
}

template <typename TX, bool kW, bool kR>
int launch_band(const Args& a, cudaStream_t stream) {
  int64_t blocks = (a.n + kBandWarps - 1) / kBandWarps;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the row loop strides over the rest
  if (a.f % 4 == 0 && row_io::aligned(a.x, 4 * sizeof(TX)) && row_io::aligned(a.out, 16))
    band_rows_kernel<TX, kW, kR, 4><<<(unsigned)blocks, kBandThreads, 0, stream>>>(a);
  else
    band_rows_kernel<TX, kW, kR, 1><<<(unsigned)blocks, kBandThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The band alone into float32 (no fallback, no divide): one warp a row;
// anything else: the window kernel.
template <typename TX, typename TO>
int launch_wr(const Args& a, bool round, cudaStream_t s) {
  const bool w = a.ell_w != nullptr;
  if (std::is_same<TO, float>::value && a.fb_rowptr == nullptr && a.deg == nullptr) {
    if (w) return round ? launch_band<TX, true, true>(a, s) : launch_band<TX, true, false>(a, s);
    return round ? launch_band<TX, false, true>(a, s) : launch_band<TX, false, false>(a, s);
  }
  const XParts none{};
  if (w) return round ? launch<TX, TO, true, true, false>(a, none, s)
                      : launch<TX, TO, true, false, false>(a, none, s);
  return round ? launch<TX, TO, false, true, false>(a, none, s)
               : launch<TX, TO, false, false, false>(a, none, s);
}

}  // namespace

// x_dtype, out_dtype: 0 = float32, 1 = bfloat16 (out float32 or x's type).
// x (x_rows, f); ell int32 (>= n rows, k_width) of window-local ids, ell_w
// float32 (>= n rows, k_width) or null, ell_len int32 (>= n) the slots of
// each row to read (entries past them are -1; the band-only mode reads all
// k_width);
// fb_rowptr int64 (n + 1) over fb_src int32 (ids into x) and fb_w float32 (or
// null), or fb_rowptr null: no fallback; degrees int32 (n) for the divide,
// or null; out (n, f).  col_offset: 0 for a whole graph, block_rows for a
// shard's halo-extended x.  round_bf16 rounds the band's x and weights to
// bfloat16.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int slab_spmm(const void* x, int x_dtype, int64_t n, int64_t col_offset,
                         int64_t x_rows, const void* ell, const void* ell_w,
                         const void* ell_len, int64_t k_width, int64_t block_rows,
                         int round_bf16, const void* fb_rowptr, const void* fb_src,
                         const void* fb_w, const void* degrees, void* out, int out_dtype,
                         int64_t f, void* stream) {
  Args a{x, n, col_offset, x_rows, static_cast<const int32_t*>(ell),
         static_cast<const float*>(ell_w), static_cast<const int32_t*>(ell_len), k_width,
         (int)block_rows, static_cast<const int64_t*>(fb_rowptr),
         static_cast<const int32_t*>(fb_src), static_cast<const float*>(fb_w),
         static_cast<const int32_t*>(degrees), out, f, 1, false, false};
  const size_t xs = x_dtype == 0 ? 4 : 2, os = out_dtype == 0 ? 4 : 2;
  a.x_vec = (f * xs) % 16 == 0 && row_io::aligned(x, 16);
  a.out_vec = (f * os) % 16 == 0 && row_io::aligned(out, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && out_dtype == 0) return launch_wr<float, float>(a, round_bf16, s);
  if (x_dtype == 1 && out_dtype == 1) return launch_wr<__nv_bfloat16, __nv_bfloat16>(a, round_bf16, s);
  if (x_dtype == 1 && out_dtype == 0) return launch_wr<__nv_bfloat16, float>(a, round_bf16, s);
  return (int)cudaErrorInvalidValue;
}
