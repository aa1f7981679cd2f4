// Sharded slab SpMM: one row shard's whole function over its table, in one
// launch.  For each of the shard's rows r < n (n = rs, a multiple of R)
//   out[r] = (sum_k w[r,k] X[(r / R) * R + ell[r,k]]
//             + sum_e fb_w[e] X[fb_src[e]]) / max(degree[r], 1)
// where X = [x_prev | x | x_next | x_tail] is the shard's table: the previous
// rank's last R rows, its own n rows, the next rank's first R rows (zeros
// past the graph's ends) and the U rows of other ranks that its fallback
// edges read, each distinct remote row once.  The ELL entries read the
// n + 2R halo-extended rows only; the fallback slots e in
// [fb_rowptr[r], fb_rowptr[r + 1]) (ids into X, planned once per graph by
// ops/dist_full_batch.py::plan_fallback_table) any row of X.  The divide is
// for 'mean' only; the output is in x's type, rounded once; every sum is
// float32; with round_bf16 the band's x elements and weights are rounded to
// bfloat16 first, the fallback terms use x as it is.
//
// Replaces cugraph_gnn_tpu/ops/dist_full_batch.py::_shard_spmm_body (:178;
// the band kernel's pallas_call :218, then the distributed fallback gather
// and segment sum, :227-243) with the 'mean' divide and the cast of its
// caller, for the bucketed fallback plan (every plan at world 1).  The TPU
// body exchanges the halos, runs the slab MXU kernel over the halo-extended
// x, gathers every fallback source row from its owner each call and adds
// their segment sum; here the remote rows arrive by one all-to-all of rows
// (their route planned once) and the whole sum is this one launch.
//
// Bound on the H100: bytes, as the whole graph's slab_spmm: the ELL's real
// entries, X once, the fallback row pointer and ids (and weights), the
// degrees for 'mean', the output once in x's type (chip_smoke.py counts each
// call's bytes: ~2.0 ms for the three calls of a world-1 GCN step at
// 2,449,152 rows).
//
// Design: the window kernel of slab_spmm.cuh with its parts (kParts).  The
// table is read where its parts lie, with no copy of x (a copied table cost
// 2.15 ms more for a world-1 GCN step's three calls, PERF.md §6): the parts
// are whole R-row blocks, so each window slot is staged from the one part
// that holds it, and a fallback slot's row pointer is picked from its id.
// The one-card instances (slab_spmm.cu) do not carry the parts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_io.cuh"
#include "slab_spmm.cuh"

namespace {

template <typename T>
int launch_shard(const Args& a, const XParts& xp, bool round, cudaStream_t s) {
  const bool w = a.ell_w != nullptr;
  if (w) return round ? launch<T, T, true, true, true>(a, xp, s)
                      : launch<T, T, true, false, true>(a, xp, s);
  return round ? launch<T, T, false, true, true>(a, xp, s)
               : launch<T, T, false, false, true>(a, xp, s);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16, the type of every part and of out.
// x (n, f), x_prev and x_next (block_rows, f), x_tail (tail_rows, f; null
// when empty), each row-major; ell int32 (>= n rows, k_width) of
// window-local ids, ell_w float32 (>= n rows, k_width) or null, ell_len
// int32 (>= n) the slots of each row to read (entries past them are -1);
// fb_rowptr int64 (n + 1) over fb_src int32 (ids into X) and fb_w float32
// (or null), or fb_rowptr null: no fallback; degrees int32 (n) for the
// divide, or null; out (n, f).  round_bf16 rounds the band's x and weights
// to bfloat16.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int slab_spmm_shard(const void* x, const void* x_prev, const void* x_next,
                               const void* x_tail, int x_dtype, int64_t n, int64_t tail_rows,
                               const void* ell, const void* ell_w, const void* ell_len,
                               int64_t k_width, int64_t block_rows, int round_bf16,
                               const void* fb_rowptr, const void* fb_src, const void* fb_w,
                               const void* degrees, void* out, int64_t f, void* stream) {
  const int64_t r = block_rows;
  Args a{x, n, r, n + 2 * r + tail_rows, static_cast<const int32_t*>(ell),
         static_cast<const float*>(ell_w), static_cast<const int32_t*>(ell_len), k_width,
         (int)block_rows, static_cast<const int64_t*>(fb_rowptr),
         static_cast<const int32_t*>(fb_src), static_cast<const float*>(fb_w),
         static_cast<const int32_t*>(degrees), out, f, 1, false, false};
  const XParts xp{x_prev, x_next, x_tail, r, n + r, n + 2 * r};
  const size_t es = x_dtype == 0 ? 4 : 2;
  a.x_vec = (f * es) % 16 == 0 && row_io::aligned(x, 16) && row_io::aligned(x_prev, 16) &&
            row_io::aligned(x_next, 16) && row_io::aligned(x_tail, 16);
  a.out_vec = (f * es) % 16 == 0 && row_io::aligned(out, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_shard<float>(a, xp, round_bf16, s);
  if (x_dtype == 1) return launch_shard<__nv_bfloat16>(a, xp, round_bf16, s);
  return (int)cudaErrorInvalidValue;
}
