// Fused slab attention forward: for every row r < n and head h, over the
// row's edges r <- c (the band ELL's and the fallback's alike; c indexes x
// and as, whose x_rows rows hold the band's columns at col_offset: 0 and n
// for a whole graph, R and n + 2R for a row shard's halo-extended operands),
//   e_rc       = leakyrelu(ad[r,h] + as[c,h])
//   m[r,h]     = max_c e_rc                (0 for a row with no edge)
//   s[r,h]     = sum_c exp(e_rc - m[r,h])
//   out[r,h,:] = sum_c exp(e_rc - m[r,h]) x[c,h,:] / max(s[r,h], 1e-16)
// x is (x_rows, H, F) float32 or bfloat16; ad, m, s are (n, H) and as
// (x_rows, H) float32; out is float32.  With round_bf16 the band edges' weights and x elements are
// rounded to bfloat16 before they are multiplied (the JAX package's MXU
// operands for compute_dtype bfloat16); the fallback edges and every sum
// stay float32.
//
// Replaces cugraph_gnn_tpu/ops/pallas/slab_kernel.py::slab_attention_spmm_mh
// (:438; pallas_call :503 over _slab_attn_fwd_kernel :386; H = 1 through
// slab_attention_spmm :546) and, with the shard offset, the per-shard
// forwards of cugraph_gnn_tpu/ops/dist_full_batch.py (_attn_fwd_sharded :585,
// pallas_call :628; _attn_fwd_sharded_mh :974, :1019), whose fallback edges
// stay outside the kernel.  The TPU kernel builds the (R, 3R) adjacency
// of a row block, takes each head's masked row softmax over the window on
// the VPU and multiplies it with the block's 3R-row window of x on the MXU,
// G blocks stacked to fit VMEM; the fallback edges join afterwards through
// segment ops and a log-sum-exp merge (slab_kernel.py:517-539), which in
// XLA costs several passes over (N, H, F).  None of the block structure
// carries over (a 3R-row window at H*F = 256 float32 is 786 KB, beyond a
// block's 227 KB of shared memory, and a dense (R, 3R) product spends 3R/K
// more operations than there are edges).
//
// Bound on the H100: bytes.  A call must read x once, the ELL, the fallback
// ids and row pointer once, the alphas once, and write out, m and s once:
// at n = 2,449,029, H*F = 256 float32, K = 16 and 2.76M fallback edges that
// is ~5.4 GB, ~1.6 ms at 3.35 TB/s (chip_smoke.py computes the exact count
// for its inputs).  The arithmetic is one exp and one FMA per element per
// edge (~17 GFLOP), three orders below the card's rate.  In practice the
// gather re-reads each edge's source row from L2: 32.6 GB at that shape.
//
// Design: one warp per destination row; no atomics, a fixed order of sums.
// The fallback edges join the row's softmax through the host-built row
// pointer over the fallback COO (SlabGraph.fb_rowptr), so each row's
// softmax is taken in one place and no (N, H, F) intermediate is written.
// Lanes split the row's H*F elements, 4 consecutive ones each (16-byte
// float32 / 8-byte bfloat16 loads where F % 4 == 0 and the pointers are
// aligned, else 1), so every lane's elements lie in one head; each lane
// computes its head's scores itself (the alphas are 4 bytes a node and
// head, served by L1), first the row max, then the weights and the weighted
// sum, with four source rows in flight.  The exact two-pass softmax keeps
// each weight as the plain version computes it, which bfloat16 rounding of
// the weights needs.  Neighbouring warps take neighbouring rows whose
// windows overlap, so the band's re-reads of x are left to the 50 MB L2.
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename TX, bool kRound, int kPer>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ ad,
                const float* __restrict__ as, int64_t n, int64_t col_offset,
                int64_t x_rows, int64_t heads, int64_t f,
                const int32_t* __restrict__ ell, int64_t k_width, int64_t block_rows,
                const int64_t* __restrict__ fb_rowptr, const int32_t* __restrict__ fb_src,
                float slope, float* __restrict__ out, float* __restrict__ m_out,
                float* __restrict__ s_out) {
  const int lane = threadIdx.x & 31;
  const int64_t hf = heads * f;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       r < n; r += stride) {
    const int64_t base = (r / block_rows) * block_rows - block_rows + col_offset;
    const int32_t* ids = ell + r * k_width;
    const int64_t e0 = fb_rowptr[r];
    const int64_t e1 = fb_rowptr[r + 1];
    for (int64_t c0 = 0; c0 < hf; c0 += 32 * kPer) {
      const int64_t j = c0 + kPer * lane;
      const bool active = j < hf;
      const int64_t h = active ? j / f : 0;
      const float adr = ad[r * heads + h];

      // pass 1: the row's largest score in head h
      float mx = -INFINITY;
      auto max_of = [&](const int32_t* cc) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (cc[u] >= 0)
            mx = fmaxf(mx, attn::lrelu(adr + __ldg(as + (int64_t)cc[u] * heads + h), slope));
        }
      };
      attn::ell_edges(lane, ids, k_width, base, x_rows, max_of);
      attn::csr_edges(lane, fb_src, e0, e1, x_rows, max_of);
      const float m = mx == -INFINITY ? 0.0f : mx;

      // pass 2: the weights, their sum and the weighted rows
      float acc[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) acc[q] = 0.0f;
      float s = 0.0f;
      auto accumulate = [&](const int32_t* cc, bool band) {
        float p[kUnroll];
        float v[kUnroll][kPer];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = 0.0f;
          if (cc[u] >= 0) {
            const float e = attn::lrelu(adr + __ldg(as + (int64_t)cc[u] * heads + h), slope);
            p[u] = expf(e - m);
            if (active) row_io::load_row<kPer>(x + (int64_t)cc[u] * hf + j, v[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (cc[u] >= 0) {
            s += p[u];
            if (active) {
              const bool rnd = kRound && band;
              const float w = rnd ? round_bf16(p[u]) : p[u];
#pragma unroll
              for (int q = 0; q < kPer; ++q)
                acc[q] = fmaf(w, rnd ? round_bf16(v[u][q]) : v[u][q], acc[q]);
            }
          }
        }
      };
      auto band_rows = [&](const int32_t* cc) { accumulate(cc, true); };
      auto fallback_rows = [&](const int32_t* cc) { accumulate(cc, false); };
      attn::ell_edges(lane, ids, k_width, base, x_rows, band_rows);
      attn::csr_edges(lane, fb_src, e0, e1, x_rows, fallback_rows);

      if (active) {
        const float denom = fmaxf(s, 1e-16f);
        float o[kPer];
#pragma unroll
        for (int q = 0; q < kPer; ++q) o[q] = acc[q] / denom;
        row_io::store_row<kPer>(out + r * hf + j, o);
        if (j % f == 0) {   // the lane that holds the head's first element
          m_out[r * heads + h] = m;
          s_out[r * heads + h] = s;
        }
      }
    }
  }
}

template <typename TX, bool kRound>
int launch(const void* x, const void* ad, const void* as, int64_t n, int64_t col_offset,
           int64_t x_rows, int64_t heads, int64_t f, const void* ell, int64_t k_width,
           int64_t block_rows, const void* fb_rowptr, const void* fb_src, float slope, void* out, void* m,
           void* s, cudaStream_t stream) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the row loop strides over the rest
  const bool vec = f % 4 == 0 && row_io::aligned(x, 4 * sizeof(TX)) &&
                   row_io::aligned(out, 4 * sizeof(float));
  const TX* xp = static_cast<const TX*>(x);
  const float* adp = static_cast<const float*>(ad);
  const float* asp = static_cast<const float*>(as);
  const int32_t* ep = static_cast<const int32_t*>(ell);
  const int64_t* rp = static_cast<const int64_t*>(fb_rowptr);
  const int32_t* fp = static_cast<const int32_t*>(fb_src);
  float* op = static_cast<float*>(out);
  float* mp = static_cast<float*>(m);
  float* sp = static_cast<float*>(s);
  if (vec)
    attn_fwd_kernel<TX, kRound, 4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, adp, asp, n, col_offset, x_rows, heads, f, ep, k_width, block_rows, rp, fp,
        slope, op, mp, sp);
  else
    attn_fwd_kernel<TX, kRound, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, adp, asp, n, col_offset, x_rows, heads, f, ep, k_width, block_rows, rp, fp,
        slope, op, mp, sp);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  x (x_rows, heads, f); alpha_src
// float32 (x_rows, heads); alpha_dst, m, s float32 (n, heads); ell int32
// (>= n rows, k_width); fb_rowptr int64 (n + 1) over fb_src int32 (ids into
// x); out float32 (n, heads, f).  col_offset: 0 for a whole graph (x_rows =
// n), block_rows for a shard's halo-extended x and alpha_src.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int slab_attn_fwd(const void* x, int x_dtype, const void* alpha_dst,
                             const void* alpha_src, int64_t n, int64_t col_offset,
                             int64_t x_rows, int64_t heads, int64_t f,
                             const void* ell, int64_t k_width, int64_t block_rows,
                             const void* fb_rowptr, const void* fb_src, float slope,
                             int round_bf16, void* out, void* m, void* s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SLAB_ATTN_FWD_LAUNCH(TX, ROUND)                                                \
  return launch<TX, ROUND>(x, alpha_dst, alpha_src, n, col_offset, x_rows, heads, f, ell, \
                           k_width, block_rows, fb_rowptr, fb_src, slope, out, m, s, st)
  if (x_dtype == 0 && round_bf16) SLAB_ATTN_FWD_LAUNCH(float, true);
  if (x_dtype == 0) SLAB_ATTN_FWD_LAUNCH(float, false);
  if (x_dtype == 1 && round_bf16) SLAB_ATTN_FWD_LAUNCH(__nv_bfloat16, true);
  if (x_dtype == 1) SLAB_ATTN_FWD_LAUNCH(__nv_bfloat16, false);
#undef SLAB_ATTN_FWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
