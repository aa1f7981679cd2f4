// Sharded slab attention backward: one row shard's whole backward, in one
// call (two launches, the destination pass and the source pass, as on one
// card).  For the shard's n rows (a multiple of R) and every edge r <- c of
// its band and its fallback, with the kernels and formulas of
// slab_attn_bwd.cu, it writes dad[r] (its in-edges), dx[c] and das[c] (its
// out-edges) for its own nodes, each summed on its owner:
// - the destination pass reads the source rows (x, alpha_src) from the
//   shard's table A = [x_prev | x | x_next | tail_A]: the previous rank's
//   last R rows, its own n rows, the next rank's first R rows (zeros past
//   the graph's ends) and the remote rows its fallback in-edges read, each
//   once, alpha_src packed beside x in each tail row;
// - the source pass reads the destination rows (g and the four stats) from
//   table B = [g_prev | g | g_next | tail_B], the remote rows its fallback
//   out-edges read, the stats packed beside g.
// The band ELL's and the band CSR's (or t_ell's) ids are rows of the
// halo-extended part; the fallback CSRs by destination (fb_rowptr, fb_src:
// ids into A) and by source (fb_t_rowptr, fb_t_dst: ids into B) are planned
// once per graph (ops/dist_full_batch.py::plan_fallback_table, the second
// with sources and destinations swapped).  Every sum is float32 in a fixed
// order: no atomics, two launches agree bit for bit.
//
// Replaces the whole sharded backwards of
// cugraph_gnn_tpu/ops/dist_full_batch.py: _attn_bwd_sharded_onepass (:679;
// pallas_call :735, then the fallback edges' distributed gather, segment
// sums and scatter-add, :775-808), _attn_bwd_sharded (:818; :886, then
// :902-931) and _attn_bwd_sharded_mh (:1071; :1131, then :1147-1178).  The
// TPU bodies exchange the halos, run the band kernel over the halo-extended
// inputs, gather every fallback edge's destination row (g and the stats)
// from its owner each call, and return dalpha_dst's fallback terms to their
// owners by a distributed scatter-add; here the remote rows arrive by one
// all-to-all of packed rows (their route planned once), dalpha_dst is
// summed on its owner in the destination pass, and the whole backward is
// this one call.
//
// Bound on the H100: bytes, as the whole graph's backward: x, g, alpha_src
// and the stats once (each table's tail once), the forward ELL's real
// entries, the band index by source, both fallback CSRs, and dx, dad and
// das once: at a world-1 shard of 2,449,152 rows, H*F = 256 float32, ~8.2
// GB, ~2.5 ms at 3.35 TB/s (chip_smoke.py counts each call's bytes).
//
// Design: the kernels of slab_attn_bwd.cuh with their parts (kParts), the
// design picked by shape as on one card (choose_design): the band window
// kernels (bit planes, and t_ell pairs up to R = 526 in 256-row tiles) or
// the warp-per-node kernels over t_ell.  Windows are staged row by row from
// the part that holds each row; a fallback slot's row is picked from its id
// (a tail row: its head and elements at their byte offsets), so no table is
// copied.  float32 products only (no bfloat16 compute mode).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_edges.cuh"
#include "row_io.cuh"
#include "slab_attn_bwd.cuh"

namespace {

// One band pass of a shard by ``plan``: tiles shorter than the pair's blocks
// read the band edges past their window from global memory (kFar).
template <typename TX, bool kSrc>
int band_pass(const Args& a, const Plan& plan, cudaStream_t stream) {
  const bool far = plan.tile < a.block_rows;
  if (plan.nqt == 1)
    return far ? launch_band<TX, 1, kSrc, true, true, true, false, true>(a, plan.tile, stream)
               : launch_band<TX, 1, kSrc, true, true, false, false, true>(a, plan.tile, stream);
  return far ? launch_band<TX, 2, kSrc, true, true, true, false, true>(a, plan.tile, stream)
             : launch_band<TX, 2, kSrc, true, true, false, false, true>(a, plan.tile, stream);
}

template <typename TX>
int launch_shard(const Args& a, cudaStream_t stream) {
  Plan plan;
  // t_rowptr is null where the shard has no band edges (padding rows only)
  const int err = choose_design(a.block_rows, a.f, a.t_rowptr != nullptr, a.t_ell != nullptr,
                                &plan);
  if (err != 0) return err;
  if (plan.design == kWarpPerNode) {
    const bool vec = a.f % 4 == 0 &&
                     attn::parts_aligned(a.xp, a.heads * a.f * sizeof(TX), 4 * sizeof(TX)) &&
                     attn::parts_aligned(a.gp, a.heads * a.f * 4, 16) &&
                     row_io::aligned(a.dx, 16);
    return vec ? launch_passes<TX, 4, true, true, false, true>(a, kAllPhases, stream)
               : launch_passes<TX, 1, true, true, false, true>(a, kAllPhases, stream);
  }
  if (plan.design != kWindows) return (int)cudaErrorInvalidValue;
  const int e = band_pass<TX, false>(a, plan, stream);
  return e != 0 ? e : band_pass<TX, true>(a, plan, stream);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16, the type of x's parts.  Table A: x
// (n, heads, f), x_prev and x_next (block_rows, heads, f), and tail_a's
// tail_a_rows rows, tail_a_stride bytes apart, each alpha_src's heads
// float32 at byte 0 and heads * f elements of x_dtype at byte tail_a_off;
// alpha_src float32 (n + 2 block_rows, heads) the halo-extended rows'.
// Table B: g, g_prev, g_next float32 like x's parts, and tail_b's rows,
// each the four stats of each head (float32 (heads, 4)) at byte 0 and g's
// heads * f float32 at byte tail_b_off; stats float32 (n + 2 block_rows,
// heads, 4) = (alpha_dst, m, max(s, 1e-16), t) the halo-extended rows'.
// Tails' strides and offsets are multiples of 16, a tail null when empty.
// ell int32 (>= n rows, k_width) window-local to the halo-extended rows;
// fb_rowptr int64 (n + 1) over fb_src int32 ids into table A; t_rowptr
// int64 (n + 1) over t_rows int32 halo-extended destination rows and t_ell
// (>= n rows, t_width) window-local ones (either null; slab_attn_bwd_design
// says which the shape takes); fb_t_rowptr int64 (n + 1) over fb_t_dst
// int32 ids into table B.  dx float32 (n, heads, f) is written; dad and das
// float32 (n, heads) must hold zeros.  Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int slab_attn_bwd_shard(
    const void* x, const void* x_prev, const void* x_next, const void* tail_a,
    int64_t tail_a_rows, int64_t tail_a_stride, int64_t tail_a_off, int x_dtype,
    const void* alpha_src, const void* g, const void* g_prev, const void* g_next,
    const void* tail_b, int64_t tail_b_rows, int64_t tail_b_stride, int64_t tail_b_off,
    const void* stats, int64_t n, int64_t heads, int64_t f, float slope, const void* ell,
    int64_t k_width, int64_t block_rows, const void* fb_rowptr, const void* fb_src,
    const void* t_ell, int64_t t_width, const void* t_rowptr, const void* t_rows,
    const void* fb_t_rowptr, const void* fb_t_dst, void* dx, void* dad, void* das,
    void* stream) {
  const int64_t r = block_rows, band = n + 2 * r;
  const Args a{x, g, alpha_src, stats, n, r, band, heads, f, slope, ell, k_width, block_rows,
               fb_rowptr, fb_src, t_ell, t_width, t_rowptr, t_rows, fb_t_rowptr, fb_t_dst,
               dx, dad, das,
               attn::Parts{x_prev, x, x_next, static_cast<const unsigned char*>(tail_a), r,
                           n + r, band, band + tail_a_rows, tail_a_stride, tail_a_off},
               attn::Parts{g_prev, g, g_next, static_cast<const unsigned char*>(tail_b), r,
                           n + r, band, band + tail_b_rows, tail_b_stride, tail_b_off}};
  // the stats are read as float4, a tail's head too
  if (!row_io::aligned(stats, 16) ||
      (tail_b_rows > 0 && (!row_io::aligned(tail_b, 16) || tail_b_stride % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_shard<float>(a, st);
  if (x_dtype == 1) return launch_shard<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
