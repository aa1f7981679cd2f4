// Fused slab attention backward: given the forward's per-node stats
// st[r,h] = (alpha_dst, m, max(s, 1e-16), t = g[r,h] . out[r,h]) and
// alpha_src, for every edge r <- c (band and fallback) and head h,
//   z_rc = ad[r,h] + as[c,h],  a_rc = exp(lrelu(z_rc) - m[r,h]) / s[r,h]
//   w_rc = a_rc * lrelu'(z_rc)  (lrelu'(z) = 1 for z >= 0, else slope)
//   de_rc = w_rc * (g[r,h] . x[c,h] - t[r,h])
// and writes dad[r,h] = sum_c de_rc, das[c,h] = sum_r de_rc and
// dx[c,h,:] = sum_r a_rc g[r,h,:].  x is float32 or bfloat16, g and every
// output float32.  The outputs cover n nodes; the per-node inputs (x, g,
// alpha_src, st) hold x_rows rows with node i at row i + col_offset (a whole
// graph: col_offset 0, x_rows n).  A row shard's whole backward, over its
// tables of halo and remote rows, is slab_attn_bwd_shard.cu.
//
// With round_bf16 (the TPU kernels' compute_dtype bfloat16) the band edges'
// products g[r] . x[c] and a_rc g[r] take g, x and a_rc rounded to bfloat16,
// the MXU's operands there; w_rc, t and every sum stay float32, and so do the
// fallback edges (the JAX package's segment sums take float32).  The window
// kernels round a staged window slot once in shared memory (it serves band
// edges only) and every other band operand where it is read (they run at
// their register cap), so their float32 instances keep their code; the
// warp-per-node kernels keep a rounded copy of the node's own row.  Only
// the kernels with every phase on have this mode.
//
// Replaces, in one source, the three TPU backward kernels of
// cugraph_gnn_tpu/ops/pallas/slab_attn_grad.py: _onepass_bwd (:333;
// pallas_call :391 over _bwd_onepass_kernel :176, used with bit planes),
// slab_attention_bwd (:507; :554 over _bwd_fused_kernel :444, H = 1, no bit
// planes) and slab_attention_bwd_mh (:689; :742 over _bwd_fused_kernel_mh
// :620).  The TPU kernels rebuild each row block's (R, 3R) attention on the
// VPU and reach the column sums either by accumulating them in VMEM across a
// sequential grid (one pass, bit planes) or through the transpose ELL t_ell
// (two orientations); the fallback edges' gradients are XLA segment sums
// (_add_fallback_grads_mh :763).  Hopper blocks run in no order, so the
// column sums come from a second pass over a transpose index instead of
// from atomics: a host-built CSR of the band edges by source (every pair
// has it; a t_ell pair's holds exactly t_ell's edges, each column's in
// t_ell's slot order), or, where the window below does not fit, the pair's
// t_ell; the fallback edges ride both passes, by the forward's fallback row
// pointer and a source-major fallback CSR.
//
// Bound on the H100: bytes.  A call must read x, g, alpha_src, the stats,
// the forward ELL and the transpose index and both fallback indexes once,
// and write dx, dad and das once: at n = 2,449,029, H*F = 256 float32 that
// is ~8.2 GB, ~2.4 ms at 3.35 TB/s (chip_smoke.py computes the exact count
// for its inputs).  The arithmetic is one exp per edge and head and a few
// FMAs per element per edge (~34 GFLOP), far below the card's rate.
//
// Design: slab_attn_bwd.cuh.  This source holds the whole-graph entries,
// the design query and the phase probe.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_edges.cuh"
#include "row_io.cuh"
#include "slab_attn_bwd.cuh"

namespace {

template <typename TX, int kPer>
struct OldPasses {
  template <bool kExp, bool kDots, bool kRound>
  static int run(const Args& a, int phases, cudaStream_t s) {
    return launch_passes<TX, kPer, kExp, kDots, kRound>(a, phases, s);
  }
};

template <typename TX, int kNQT, bool kSrc>
struct BandPass {
  int64_t tile;
  template <bool kExp, bool kDots, bool kRound>
  int run(const Args& a, int, cudaStream_t s) const {
    return launch_band<TX, kNQT, kSrc, kExp, kDots, false, kRound>(a, tile, s);
  }
};

// Calls l.run<kExp, kDots, kRound>(...) for the exp and dot phases in
// ``phases`` and the rounding flag.  The probe's variants exist for float32
// x only; bfloat16 x and the rounding mode run every phase.
template <typename TX, typename L>
int by_phases(const L& l, const Args& a, int phases, bool round, cudaStream_t s) {
  const bool e = phases & kExpPhase, d = phases & kDotPhase;
  if (round) {
    if (!e || !d) return (int)cudaErrorInvalidValue;
    return l.template run<true, true, true>(a, phases, s);
  }
  if constexpr (std::is_same<TX, float>::value) {
    if (!e && !d) return l.template run<false, false, false>(a, phases, s);
    if (!e) return l.template run<false, true, false>(a, phases, s);
    if (!d) return l.template run<true, false, false>(a, phases, s);
  } else {
    if (!e || !d) return (int)cudaErrorInvalidValue;
  }
  return l.template run<true, true, false>(a, phases, s);
}

template <typename TX>
int launch_old(const Args& a, int phases, bool round, cudaStream_t stream) {
  const bool vec = a.f % 4 == 0 && row_io::aligned(a.x, 4 * sizeof(TX)) &&
                   row_io::aligned(a.g, 16) && row_io::aligned(a.dx, 16);
  return vec ? by_phases<TX>(OldPasses<TX, 4>(), a, phases, round, stream)
             : by_phases<TX>(OldPasses<TX, 1>(), a, phases, round, stream);
}

// One band kernel (the band CSR by source, fallback edges included) by
// ``plan``.  Tiles shorter than the pair's blocks (kFar) exist with every
// phase on.
template <typename TX, bool kSrc>
int launch_pass(const Args& a, const Plan& plan, int phases, bool round, cudaStream_t stream) {
  if (plan.tile < a.block_rows) {
    if (!(phases & kExpPhase) || !(phases & kDotPhase)) return (int)cudaErrorInvalidValue;
    if (round)
      return plan.nqt == 1
                 ? launch_band<TX, 1, kSrc, true, true, true, true>(a, plan.tile, stream)
                 : launch_band<TX, 2, kSrc, true, true, true, true>(a, plan.tile, stream);
    return plan.nqt == 1 ? launch_band<TX, 1, kSrc, true, true, true, false>(a, plan.tile, stream)
                         : launch_band<TX, 2, kSrc, true, true, true, false>(a, plan.tile, stream);
  }
  return plan.nqt == 1
             ? by_phases<TX>(BandPass<TX, 1, kSrc>{plan.tile}, a, phases, round, stream)
             : by_phases<TX>(BandPass<TX, 2, kSrc>{plan.tile}, a, phases, round, stream);
}

template <typename TX>
int launch(const Args& a, int phases, bool round, cudaStream_t stream) {
  Plan plan;
  // t_rows is null where the pair has no band edges (a shard of padding rows)
  const int err = choose_design(a.block_rows, a.f, a.t_rowptr != nullptr, a.t_ell != nullptr,
                                &plan);
  if (err != 0) return err;
  if (plan.design == kWarpPerNode) return launch_old<TX>(a, phases, round, stream);
  if (plan.design != kWindows) return (int)cudaErrorInvalidValue;
  if (phases & kDstPass) {
    const int e = launch_pass<TX, false>(a, plan, phases, round, stream);
    if (e != 0) return e;
  }
  if (phases & kSrcPass) return launch_pass<TX, true>(a, plan, phases, round, stream);
  return 0;
}

int run(const Args& a, int x_dtype, int phases, bool round, cudaStream_t stream) {
  if (!row_io::aligned(a.st, 16)) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0) return launch<float>(a, phases, round, stream);
  if (x_dtype == 1) return launch<__nv_bfloat16>(a, phases, round, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  x (x_rows, heads, f); g float32
// (x_rows, heads, f); alpha_src float32 (x_rows, heads); stats float32
// (x_rows, heads, 4) = (alpha_dst, m, max(s, 1e-16), t), 16-byte aligned;
// ell int32 (>= n rows, k_width) and fb_rowptr int64 (n + 1) over fb_src:
// the forward's edges by destination; t_rowptr int64 (n + 1) over t_rows
// int32 destination rows of the per-node inputs (the band edges by source),
// t_ell int32 (>= n rows, t_width) window-local destination rows of the
// same edges (either may be null; slab_attn_bwd_design says which one a
// pair's shape takes); fb_t_rowptr int64 (n + 1) over fb_t_dst int32: the
// fallback edges by source.  Node i sits at row i + col_offset of the
// per-node inputs (0 for a whole graph, x_rows = n; block_rows for a
// shard's halo-extended inputs).  dx float32 (n, heads, f) is written; dad
// and das float32 (n, heads) must hold zeros.  round_bf16 nonzero: the band
// edges' products take g, x and a rounded to bfloat16 (compute_dtype
// bfloat16; the fallback edges' stay float32).  Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int slab_attn_bwd(const void* x, int x_dtype, const void* g,
                             const void* alpha_src, const void* stats, int64_t n,
                             int64_t col_offset, int64_t x_rows, int64_t heads,
                             int64_t f, float slope, const void* ell,
                             int64_t k_width, int64_t block_rows, const void* fb_rowptr,
                             const void* fb_src, const void* t_ell, int64_t t_width,
                             const void* t_rowptr, const void* t_rows,
                             const void* fb_t_rowptr, const void* fb_t_dst, void* dx,
                             void* dad, void* das, void* stream, int round_bf16) {
  const Args a{x, g, alpha_src, stats, n, col_offset, x_rows, heads, f, slope, ell,
               k_width, block_rows,
               fb_rowptr, fb_src, t_ell, t_width, t_rowptr, t_rows, fb_t_rowptr,
               fb_t_dst, dx, dad, das};
  return run(a, x_dtype, kAllPhases, round_bf16 != 0, static_cast<cudaStream_t>(stream));
}

// Which kernels slab_attn_bwd launches for a pair of ``block_rows`` rows a
// block and heads of ``f`` elements on the current device, given whether
// the pair has the band CSR by source and t_ell: *design 1 = the band
// kernels over shared-memory windows, *chunk elements of a head at a time
// over tiles of *tile rows; 2 = the warp-per-node kernels over t_ell
// (*chunk and *tile 0); 0 = none.  Returns a CUDA error code (0 on
// success).
extern "C" int slab_attn_bwd_design(int64_t block_rows, int64_t f, int has_band_csr,
                                    int has_t_ell, int* design, int* chunk, int64_t* tile) {
  Plan plan;
  const int err = choose_design(block_rows, f, has_band_csr != 0, has_t_ell != 0, &plan);
  if (err != 0) return err;
  *design = (int)plan.design;
  *chunk = 4 * kSub * plan.nqt;
  *tile = plan.tile;
  return 0;
}

// The phase probe (the counterpart of the JAX package's
// benchmarks/bwd_kernel_anatomy.py and benchmarks/attn_bwd_probe.py): the
// same arguments as slab_attn_bwd plus ``phases``, a mask of 1 (the dst
// pass), 2 (the src pass), 4 (expf in the edge weights; without it the
// exponent itself) and 8 (the per-edge dot and FMA work; without it the
// loaded rows are only kept alive).  Memory traffic is the real kernels' in
// every variant; phases 15 runs exactly slab_attn_bwd's float32 code
// (round_bf16 0).  Outputs of
// a variant other than 15 are meaningless.
extern "C" int slab_attn_bwd_probe(const void* x, int x_dtype, const void* g,
                                   const void* alpha_src, const void* stats, int64_t n,
                                   int64_t col_offset, int64_t x_rows, int64_t heads,
                                   int64_t f, float slope, const void* ell,
                                   int64_t k_width, int64_t block_rows,
                                   const void* fb_rowptr, const void* fb_src,
                                   const void* t_ell, int64_t t_width,
                                   const void* t_rowptr, const void* t_rows,
                                   const void* fb_t_rowptr, const void* fb_t_dst,
                                   void* dx, void* dad, void* das, void* stream,
                                   int phases) {
  const Args a{x, g, alpha_src, stats, n, col_offset, x_rows, heads, f, slope, ell,
               k_width, block_rows,
               fb_rowptr, fb_src, t_ell, t_width, t_rowptr, t_rows, fb_t_rowptr,
               fb_t_dst, dx, dad, das};
  if (phases < 0 || phases > kAllPhases)
    return (int)cudaErrorInvalidValue;
  return run(a, x_dtype, phases, false, static_cast<cudaStream_t>(stream));
}
