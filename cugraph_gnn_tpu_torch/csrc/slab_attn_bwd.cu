// Fused slab attention backward: given the forward's per-node stats
// st[r,h] = (alpha_dst, m, max(s, 1e-16), t = g[r,h] . out[r,h]) and
// alpha_src, for every edge r <- c (band and fallback) and head h,
//   z_rc = ad[r,h] + as[c,h],  a_rc = exp(lrelu(z_rc) - m[r,h]) / s[r,h]
//   w_rc = a_rc * lrelu'(z_rc)  (lrelu'(z) = 1 for z >= 0, else slope)
//   de_rc = w_rc * (g[r,h] . x[c,h] - t[r,h])
// and writes dad[r,h] = sum_c de_rc, das[c,h] = sum_r de_rc and
// dx[c,h,:] = sum_r a_rc g[r,h,:].  x is float32 or bfloat16, g and every
// output float32.
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
// from atomics: the pair's t_ell where it has one, else a host-built CSR of
// the same band edges by source; the fallback edges ride both passes, by
// the forward's fallback row pointer and a source-major fallback CSR.
//
// Bound on the H100: bytes.  A call must read x, g, alpha_src, the stats,
// the forward ELL and the transpose index and both fallback indexes once,
// and write dx, dad and das once: at n = 2,449,029, H*F = 256 float32 that
// is ~8.2 GB, ~2.4 ms at 3.35 TB/s (chip_smoke.py computes the exact count
// for its inputs).  The arithmetic is one exp per edge and head and a few
// FMAs per element per edge (~34 GFLOP), far below the card's rate.  In
// practice each pass re-reads an edge's source row (x in the dst pass, g in
// the src pass) from L2: 65 GB at that shape.
//
// Design: two kernels on one stream, each one warp per node, no atomics, a
// fixed order of sums.  Both factor the per-edge dot out of the sum, since
// the weights depend only on per-node scalars:
//   dad[r] = sum_c w_rc (g[r] . x[c]) - t[r] sum_c w_rc
//   das[c] = sum_r w_rc (g[r] . x[c]) - sum_r w_rc t[r]
// so each lane adds w times its own elements' part of the dot and the head's
// lanes are summed once per node, not once per edge.
// - dst pass (warp per row r): g[r] in registers; reads the rows x[c] of
//   the row's edges and alpha_src[c]; writes dad[r].
// - src pass (warp per column c): x[c] in registers; reads the rows g[r]
//   of the column's in-edges and st[r] (one 16-byte load); writes dx[c]
//   and das[c].
// Lanes split H*F as in the forward (4 consecutive elements each where
// F % 4 == 0 and aligned, else 1), four rows in flight per warp; the band's
// window re-reads are left to the 50 MB L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_edges.cuh"
#include "row_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
using attn::kUnroll;

// a_rc and w_rc of one edge from the destination's stats and the source's
// alpha_src
__device__ __forceinline__ void edge_weights(float4 st, float as_c, float slope,
                                             float& a, float& w) {
  const float z = st.x + as_c;
  a = expf(attn::lrelu(z, slope) - st.y) / st.z;
  w = z >= 0.0f ? a : slope * a;
}

template <typename TX, int kPer>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dst_kernel(const TX* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ as, const float4* __restrict__ st,
                    int64_t n, int64_t heads, int64_t f, float slope,
                    const int32_t* __restrict__ ell, int64_t k_width, int64_t block_rows,
                    const int64_t* __restrict__ fb_rowptr,
                    const int32_t* __restrict__ fb_src, float* __restrict__ dad) {
  const int lane = threadIdx.x & 31;
  const int64_t hf = heads * f;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       r < n; r += stride) {
    const int64_t base = (r / block_rows) * block_rows - block_rows;
    const int32_t* ids = ell + r * k_width;
    const int64_t e0 = fb_rowptr[r];
    const int64_t e1 = fb_rowptr[r + 1];
    for (int64_t c0 = 0; c0 < hf; c0 += 32 * kPer) {
      const int64_t j = c0 + kPer * lane;
      const bool active = j < hf;
      const int64_t h = active ? j / f : 0;
      const float4 sr = st[r * heads + h];
      float gv[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) gv[q] = 0.0f;
      if (active) row_io::load_row<kPer>(g + r * hf + j, gv);
      float d = 0.0f;      // this lane's part of sum_c w (g . x[c])
      float w_sum = 0.0f;  // sum_c w, the same in every lane of the head
      auto visit = [&](const int32_t* cc) {
        float w[kUnroll];
        float v[kUnroll][kPer];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          w[u] = 0.0f;
          if (cc[u] >= 0) {
            float a;
            edge_weights(sr, __ldg(as + (int64_t)cc[u] * heads + h), slope, a, w[u]);
            if (active) row_io::load_row<kPer>(x + (int64_t)cc[u] * hf + j, v[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (cc[u] >= 0) {
            w_sum += w[u];
            if (active) {
              float dot = 0.0f;
#pragma unroll
              for (int q = 0; q < kPer; ++q) dot = fmaf(gv[q], v[u][q], dot);
              d = fmaf(w[u], dot, d);
            }
          }
        }
      };
      attn::ell_edges(lane, ids, k_width, base, n, visit);
      attn::csr_edges(lane, fb_src, e0, e1, n, visit);
      // the head's first lane carries -t * sum_c w once
      const float part = d - (active && j % f == 0 ? sr.w * w_sum : 0.0f);
      attn::add_head_sums(part, active, h, c0, kPer, f, heads, lane, dad + r * heads);
    }
  }
}

template <typename TX, int kPer>
__global__ void __launch_bounds__(kThreads)
attn_bwd_src_kernel(const TX* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ as, const float4* __restrict__ st,
                    int64_t n, int64_t heads, int64_t f, float slope,
                    const int32_t* __restrict__ t_ell, int64_t t_width, int64_t block_rows,
                    const int64_t* __restrict__ t_rowptr, const int32_t* __restrict__ t_rows,
                    const int64_t* __restrict__ fbt_rowptr,
                    const int32_t* __restrict__ fbt_dst, float* __restrict__ dx,
                    float* __restrict__ das) {
  const int lane = threadIdx.x & 31;
  const int64_t hf = heads * f;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t c = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       c < n; c += stride) {
    const int64_t base = (c / block_rows) * block_rows - block_rows;
    for (int64_t c0 = 0; c0 < hf; c0 += 32 * kPer) {
      const int64_t j = c0 + kPer * lane;
      const bool active = j < hf;
      const int64_t h = active ? j / f : 0;
      const float as_c = as[c * heads + h];
      float xv[kPer];
      float acc[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) xv[q] = acc[q] = 0.0f;
      if (active) row_io::load_row<kPer>(x + c * hf + j, xv);
      float d = 0.0f;      // this lane's part of sum_r w (g[r] . x)
      float wt_sum = 0.0f; // sum_r w t[r], the same in every lane of the head
      auto visit = [&](const int32_t* rr) {
        float4 sr[kUnroll];
        float v[kUnroll][kPer];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (rr[u] >= 0) {
            sr[u] = __ldg(st + (int64_t)rr[u] * heads + h);
            if (active) row_io::load_row<kPer>(g + (int64_t)rr[u] * hf + j, v[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (rr[u] >= 0) {
            float a, w;
            edge_weights(sr[u], as_c, slope, a, w);
            wt_sum = fmaf(w, sr[u].w, wt_sum);
            if (active) {
              float dot = 0.0f;
#pragma unroll
              for (int q = 0; q < kPer; ++q) {
                dot = fmaf(v[u][q], xv[q], dot);
                acc[q] = fmaf(a, v[u][q], acc[q]);
              }
              d = fmaf(w, dot, d);
            }
          }
        }
      };
      if (t_ell != nullptr)
        attn::ell_edges(lane, t_ell + c * t_width, t_width, base, n, visit);
      else
        attn::csr_edges(lane, t_rows, t_rowptr[c], t_rowptr[c + 1], n, visit);
      attn::csr_edges(lane, fbt_dst, fbt_rowptr[c], fbt_rowptr[c + 1], n, visit);
      if (active) row_io::store_row<kPer>(dx + c * hf + j, acc);
      const float part = d - (active && j % f == 0 ? wt_sum : 0.0f);
      attn::add_head_sums(part, active, h, c0, kPer, f, heads, lane, das + c * heads);
    }
  }
}

struct Args {
  const void *x, *g, *as, *st;
  int64_t n, heads, f;
  float slope;
  const void *ell;
  int64_t k_width, block_rows;
  const void *fb_rowptr, *fb_src, *t_ell;
  int64_t t_width;
  const void *t_rowptr, *t_rows, *fbt_rowptr, *fbt_dst;
  void *dx, *dad, *das;
};

template <typename TX, int kPer>
int launch_both(const Args& a, cudaStream_t stream) {
  int64_t blocks = (a.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the node loops stride over the rest
  const TX* x = static_cast<const TX*>(a.x);
  const float* g = static_cast<const float*>(a.g);
  const float* as = static_cast<const float*>(a.as);
  const float4* st = static_cast<const float4*>(a.st);
  attn_bwd_dst_kernel<TX, kPer><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, g, as, st, a.n, a.heads, a.f, a.slope, static_cast<const int32_t*>(a.ell),
      a.k_width, a.block_rows, static_cast<const int64_t*>(a.fb_rowptr),
      static_cast<const int32_t*>(a.fb_src), static_cast<float*>(a.dad));
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  attn_bwd_src_kernel<TX, kPer><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, g, as, st, a.n, a.heads, a.f, a.slope, static_cast<const int32_t*>(a.t_ell),
      a.t_width, a.block_rows, static_cast<const int64_t*>(a.t_rowptr),
      static_cast<const int32_t*>(a.t_rows), static_cast<const int64_t*>(a.fbt_rowptr),
      static_cast<const int32_t*>(a.fbt_dst), static_cast<float*>(a.dx),
      static_cast<float*>(a.das));
  return (int)cudaGetLastError();
}

template <typename TX>
int launch(const Args& a, cudaStream_t stream) {
  const bool vec = a.f % 4 == 0 && row_io::aligned(a.x, 4 * sizeof(TX)) &&
                   row_io::aligned(a.g, 16) && row_io::aligned(a.dx, 16);
  return vec ? launch_both<TX, 4>(a, stream) : launch_both<TX, 1>(a, stream);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  x (n, heads, f); g float32 (n,
// heads, f); alpha_src float32 (n, heads); stats float32 (n, heads, 4) =
// (alpha_dst, m, max(s, 1e-16), t), 16-byte aligned; ell int32 (>= n rows,
// k_width) and fb_rowptr int64 (n + 1) over fb_src: the forward's edges by
// destination; t_ell int32 (>= n rows, t_width) window-local destination
// rows, or (t_ell null) t_rowptr int64 (n + 1) over t_rows int32 global
// destination rows: the band edges by source; fb_t_rowptr int64 (n + 1)
// over fb_t_dst int32: the fallback edges by source.  dx float32 (n, heads,
// f) is written; dad and das float32 (n, heads) must hold zeros.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int slab_attn_bwd(const void* x, int x_dtype, const void* g,
                             const void* alpha_src, const void* stats, int64_t n,
                             int64_t heads, int64_t f, float slope, const void* ell,
                             int64_t k_width, int64_t block_rows, const void* fb_rowptr,
                             const void* fb_src, const void* t_ell, int64_t t_width,
                             const void* t_rowptr, const void* t_rows,
                             const void* fb_t_rowptr, const void* fb_t_dst, void* dx,
                             void* dad, void* das, void* stream) {
  if (!row_io::aligned(stats, 16) ||
      (t_ell == nullptr && (t_rowptr == nullptr || t_rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, g, alpha_src, stats, n, heads, f, slope, ell, k_width, block_rows,
               fb_rowptr, fb_src, t_ell, t_width, t_rowptr, t_rows, fb_t_rowptr,
               fb_t_dst, dx, dad, das};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch<float>(a, s);
  if (x_dtype == 1) return launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
