// The attention backward's kernels and their launches, shared by
// slab_attn_bwd.cu (a whole graph's nodes, and the phase probe) and
// slab_attn_bwd_shard.cu (a row shard's nodes over its tables in parts: the
// kParts instances, which read the halo-extended rows and the remote tail
// where they lie, attn::Parts).  What the kernels compute and what they
// replace: slab_attn_bwd.cu's header.
//
// Both passes factor the per-edge dot out of the sums, since the weights
// depend only on per-node scalars:
//   dad[r] = g[r] . (sum_c w_rc x[c]) - t[r] sum_c w_rc
//   das[c] = x[c] . (sum_r w_rc g[r]) - sum_r w_rc t[r]
// so a lane adds w times its own elements and the lanes of a head are
// summed once per node, not once per edge.  No atomics; every sum runs in a
// fixed order, so two launches agree bit for bit.
//
// Design for every pair whose window fits (the band kernels): the band
// edges over shared memory, the fallback edges in the same passes.  They run
// all three TPU kernels of slab_attn_bwd.cu's header: pairs with bit planes
// (R <= 341) and t_ell pairs up to R = 526, where a 3R-row window of
// 32-element chunks still fits the H100's 232,448 bytes of shared memory a
// block (band_smem: 226,048 at R = 512).
// - Every band edge of a row in block b has its source in the 3R-row
//   window [(b-1)R, (b+2)R), and every band in-edge of a column in block b
//   comes from a destination row in the same window.  So the dst pass
//   stages x (and alpha_src) of the window in shared memory and the src
//   pass g (and the 16-byte stats); each source row is read from the L2 or
//   HBM once per tile instead of once per edge (a warp per node, the design
//   below, reads 65 GB from the L2 at layer 0's shape; the phase probe put
//   its FMA chain at ~45% of its time and expf at < 2%).
// - A tile is one head of R rows (F <= 64 in one chunk: F = 64 at R = 256
//   is a 196 KB window; wider heads in even chunks of at most 64, whose dot
//   parts are added in chunk order).  Where a whole head's window of 3R
//   rows does not fit (t_ell pairs at R = 512), a tile holds fewer rows,
//   256 (the most whose window fits), and its window 768: a band edge that
//   reaches past it (only where |c - r| > 256: at R = 512 the banded
//   graph's uniform sources that land within 512 rows, a few thousandths
//   of its band) reads its row from global memory in the same walk (kFar),
//   after the window edges of its round of 8.  Bit-plane pairs at 274 < R
//   <= 341 take such tiles too, which then may span two of the pair's
//   blocks.  Tried on the H100 and slower at R = 512: tiles of R rows in
//   32-element chunks (layer 0 in 8 (head, chunk) passes), in either order
//   (a chunk's tiles, or a tile's chunks with its window restaged for each).
//   One CTA of 1024 threads a multiprocessor, persistent over (head, row
//   block) tiles in order; the window is a ring of three slots of a tile's
//   rows filled by cp.async (16-byte, or 4-byte for rows that are not
//   16-byte aligned such as F = 47; plain loads for bfloat16 x), so moving
//   from one tile to the next stages one new slot and x and g are read from
//   HBM about once per head.  Window rows keep their 16-byte quads rotated
//   by the row index, so that rows read together spread over the banks.
// - A team of 8 threads owns a row (column), each thread 1 to 2 quads of
//   the chunk (neighbouring quads across the team: coalesced row reads and
//   shared loads).  The row's ids (the band CSR's slice), stats and own row
//   chunk are loaded while the window arrives.  Team thread s computes the
//   weights of the row's edges s, s + 8, ... (one expf per edge, head and
//   chunk) and the team shares them by shuffles; each thread adds its
//   quads' part of the dot (dst) or of the dot and dx (src), and the team's
//   parts are summed by a fixed shuffle tree.
// - The fallback edges follow in the same team, their rows read from global
//   memory (a row shard's from its table's parts and remote tail).  A
//   column with more than 64 fallback in-edges (the transposed banded
//   graph's two hub columns have ~500) is taken by the whole CTA after the
//   tile, each team a fixed share, the shares summed by a fixed tree and
//   then warp by warp.
// - Tried on the H100 and slower: 2 or 4 threads a row (4 spill at the 64
//   registers that 1024 threads allow), one thread a row in two CTAs of 256
//   threads a multiprocessor (32-element chunks), and, at R = 256 where a
//   64-element chunk fits, 32-element chunks with 512 or 1024 threads.
// Pairs whose 3R-row window does not fit even at 32-element chunks (R >=
// 527 on the H100; only t_ell pairs get there) keep the first design for
// both passes: their band edges may reach R rows, so shorter tiles would
// read a large share of them from global memory.  One warp per node, g[r] (dst)
// or x[c] (src) in registers, the edges' source rows read from the L2,
// lanes splitting H*F (4 consecutive elements each where F % 4 == 0 and
// aligned, else 1), four rows in flight per warp.  Which design runs is
// decided by shape before any launch (choose_design; the query entry
// slab_attn_bwd_design reports it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_edges.cuh"
#include "row_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
using attn::kUnroll;

// a_rc and w_rc of one edge from the destination's stats and the source's
// alpha_src (kExp false, the probe's variant: the exponent without expf)
template <bool kExp>
__device__ __forceinline__ void edge_weights(float4 st, float as_c, float slope,
                                             float& a, float& w) {
  const float z = st.x + as_c;
  const float e = attn::lrelu(z, slope) - st.y;
  a = (kExp ? expf(e) : e) / st.z;
  w = z >= 0.0f ? a : slope * a;
}

// Keeps loaded values alive without arithmetic: the probe's variants
// without dots load exactly what the real kernels load.
template <int kPer>
__device__ __forceinline__ void sink(const float v[kPer]) {
#pragma unroll
  for (int q = 0; q < kPer; ++q) asm volatile("" ::"f"(v[q]));
}

// kRound (compute_dtype bfloat16; with kExp and kDots only): the band edges'
// products g . x (both kernels) and a g (the src kernels) take their
// operands rounded to bfloat16, every sum and the fallback edges' products
// stay float32.
template <typename T, bool kRound>
__device__ __forceinline__ float band_operand(float v) {
  return kRound && std::is_same<T, float>::value ? attn::round_bf16(v) : v;
}

template <typename TX, int kPer, bool kExp, bool kDots, bool kRound = false,
          bool kParts = false>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dst_kernel(const TX* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ as, const float4* __restrict__ st,
                    int64_t n, int64_t col_offset, int64_t x_rows, int64_t heads,
                    int64_t f, float slope, const int32_t* __restrict__ ell,
                    int64_t k_width, int64_t block_rows,
                    const int64_t* __restrict__ fb_rowptr,
                    const int32_t* __restrict__ fb_src, float* __restrict__ dad,
                    attn::Parts xp, attn::Parts gp) {
  const int lane = threadIdx.x & 31;
  const int64_t hf = heads * f;
  // kParts: source rows from table A (x, a tail row's alpha_src in its
  // head), the node's own g from table B's own part
  auto x_row = [&](int64_t c) -> const TX* {
    if constexpr (kParts) return attn::part_row<TX>(xp, c, hf);
    else return x + c * hf;
  };
  auto as_of = [&](int64_t c, int64_t h) -> float {
    if constexpr (kParts) {
      if (c >= xp.band) return __ldg(attn::tail_head(xp, c) + h);
    }
    return __ldg(as + c * heads + h);
  };
  const int64_t fb_rows = kParts ? xp.rows : x_rows;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       r < n; r += stride) {
    const int64_t base = (r / block_rows) * block_rows - block_rows + col_offset;
    const int64_t rx = r + col_offset;   // r's row in the per-node inputs
    const int32_t* ids = ell + r * k_width;
    const int64_t e0 = fb_rowptr[r];
    const int64_t e1 = fb_rowptr[r + 1];
    for (int64_t c0 = 0; c0 < hf; c0 += 32 * kPer) {
      const int64_t j = c0 + kPer * lane;
      const bool active = j < hf;
      const int64_t h = active ? j / f : 0;
      const float4 sr = st[rx * heads + h];
      float gv[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) gv[q] = 0.0f;
      const float* g_r = kParts ? static_cast<const float*>(gp.own) + r * hf : g + rx * hf;
      if (active) row_io::load_row<kPer>(g_r + j, gv);
      float gb[kPer];      // g as the band's products take it
#pragma unroll
      for (int q = 0; q < kPer; ++q) gb[q] = band_operand<float, kRound>(gv[q]);
      float d = 0.0f;      // this lane's part of sum_c w (g . x[c])
      float w_sum = 0.0f;  // sum_c w, the same in every lane of the head
      // band: std::true_type for the ELL's edges, false for the fallback's
      auto visit = [&](const int32_t* cc, auto band) {
        constexpr bool kR = kRound && decltype(band)::value;
        float w[kUnroll];
        float v[kUnroll][kPer];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          w[u] = 0.0f;
          if (cc[u] >= 0) {
            float a;
            edge_weights<kExp>(sr, as_of(cc[u], h), slope, a, w[u]);
            if (active) row_io::load_row<kPer>(x_row(cc[u]) + j, v[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (cc[u] >= 0) {
            w_sum += w[u];
            if (active && kDots) {
              float dot = 0.0f;
#pragma unroll
              for (int q = 0; q < kPer; ++q)
                dot = fmaf(kR ? gb[q] : gv[q], band_operand<TX, kR>(v[u][q]), dot);
              d = fmaf(w[u], dot, d);
            } else if (active) {
              sink<kPer>(v[u]);
            }
          }
        }
      };
      auto visit_band = [&](const int32_t* cc) { visit(cc, std::true_type()); };
      auto visit_fb = [&](const int32_t* cc) { visit(cc, std::false_type()); };
      attn::ell_edges(lane, ids, k_width, base, x_rows, visit_band);
      attn::csr_edges(lane, fb_src, e0, e1, fb_rows, visit_fb);
      // the head's first lane carries -t * sum_c w once
      const float part = d - (active && j % f == 0 ? sr.w * w_sum : 0.0f);
      attn::add_head_sums(part, active, h, c0, kPer, f, heads, lane, dad + r * heads);
    }
  }
}

template <typename TX, int kPer, bool kExp, bool kDots, bool kRound = false,
          bool kParts = false>
__global__ void __launch_bounds__(kThreads)
attn_bwd_src_kernel(const TX* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ as, const float4* __restrict__ st,
                    int64_t n, int64_t col_offset, int64_t x_rows, int64_t heads,
                    int64_t f, float slope, const int32_t* __restrict__ t_ell,
                    int64_t t_width, int64_t block_rows,
                    const int64_t* __restrict__ fbt_rowptr,
                    const int32_t* __restrict__ fbt_dst, float* __restrict__ dx,
                    float* __restrict__ das, attn::Parts xp, attn::Parts gp) {
  const int lane = threadIdx.x & 31;
  const int64_t hf = heads * f;
  // kParts: destination rows from table B (g, a tail row's stats in its
  // head), the node's own x from table A's own part
  auto g_row = [&](int64_t r) -> const float* {
    if constexpr (kParts) return attn::part_row<float>(gp, r, hf);
    else return g + r * hf;
  };
  auto st_of = [&](int64_t r, int64_t h) -> float4 {
    if constexpr (kParts) {
      if (r >= gp.band) return __ldg(reinterpret_cast<const float4*>(attn::tail_head(gp, r)) + h);
    }
    return __ldg(st + r * heads + h);
  };
  const int64_t fb_rows = kParts ? gp.rows : x_rows;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t c = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       c < n; c += stride) {
    const int64_t base = (c / block_rows) * block_rows - block_rows + col_offset;
    const int64_t cx = c + col_offset;   // c's row in the per-node inputs
    for (int64_t c0 = 0; c0 < hf; c0 += 32 * kPer) {
      const int64_t j = c0 + kPer * lane;
      const bool active = j < hf;
      const int64_t h = active ? j / f : 0;
      const float as_c = as[cx * heads + h];
      float xv[kPer];
      float acc[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) xv[q] = acc[q] = 0.0f;
      const TX* x_c = kParts ? static_cast<const TX*>(xp.own) + c * hf : x + cx * hf;
      if (active) row_io::load_row<kPer>(x_c + j, xv);
      float xb[kPer];      // x as the band's products take it
#pragma unroll
      for (int q = 0; q < kPer; ++q) xb[q] = band_operand<TX, kRound>(xv[q]);
      float d = 0.0f;      // this lane's part of sum_r w (g[r] . x)
      float wt_sum = 0.0f; // sum_r w t[r], the same in every lane of the head
      // band: std::true_type for t_ell's edges, false for the fallback's
      auto visit = [&](const int32_t* rr, auto band) {
        constexpr bool kR = kRound && decltype(band)::value;
        float4 sr[kUnroll];
        float v[kUnroll][kPer];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (rr[u] >= 0) {
            sr[u] = st_of(rr[u], h);
            if (active) row_io::load_row<kPer>(g_row(rr[u]) + j, v[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (rr[u] >= 0) {
            float a, w;
            edge_weights<kExp>(sr[u], as_c, slope, a, w);
            wt_sum = fmaf(w, sr[u].w, wt_sum);
            if (active && !kDots) {
              sink<kPer>(v[u]);
            } else if (active) {
              const float ab = band_operand<float, kR>(a);
              float dot = 0.0f;
#pragma unroll
              for (int q = 0; q < kPer; ++q) {
                const float gq = band_operand<float, kR>(v[u][q]);
                dot = fmaf(gq, kR ? xb[q] : xv[q], dot);
                acc[q] = fmaf(ab, gq, acc[q]);
              }
              d = fmaf(w, dot, d);
            }
          }
        }
      };
      auto visit_band = [&](const int32_t* rr) { visit(rr, std::true_type()); };
      auto visit_fb = [&](const int32_t* rr) { visit(rr, std::false_type()); };
      attn::ell_edges(lane, t_ell + c * t_width, t_width, base, x_rows, visit_band);
      attn::csr_edges(lane, fbt_dst, fbt_rowptr[c], fbt_rowptr[c + 1], fb_rows, visit_fb);
      if (active) row_io::store_row<kPer>(dx + c * hf + j, acc);
      const float part = d - (active && j % f == 0 ? wt_sum : 0.0f);
      attn::add_head_sums(part, active, h, c0, kPer, f, heads, lane, das + c * heads);
    }
  }
}

struct Args {
  const void *x, *g, *as, *st;
  int64_t n, col_offset, x_rows, heads, f;
  float slope;
  const void *ell;
  int64_t k_width, block_rows;
  const void *fb_rowptr, *fb_src, *t_ell;
  int64_t t_width;
  const void *t_rowptr, *t_rows, *fbt_rowptr, *fbt_dst;
  void *dx, *dad, *das;
  attn::Parts xp, gp;   // a shard's tables A (x) and B (g); x_rows their band
};

// -- band kernels over shared-memory windows (pairs with the band CSR) ------
// A team of kSub threads owns a row (dst pass) or a column (src pass) of a
// tile of R rows (in the kernels R is the tile's height: the pair's block
// rows, or fewer with kFar); the window of the tile's 3R rows for one head
// (or one chunk of it) is in shared memory; one CTA of 1024 threads a
// multiprocessor, persistent over (head, tile) pairs in order, so that the
// 3-slot ring of R-row window blocks keeps two of them from one tile to the
// next.
constexpr int kBandThreads = 1024;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kSub = 8;                       // threads a row (column): a team
constexpr int kTeams = kBandThreads / kSub;   // rows (columns) a pass over a block
constexpr int kMaxIds = 16;                   // ELL ids of a row in registers
constexpr int kMaxChunk = 64;                 // elements of a head a tile holds
constexpr int64_t kLongFb = 64;   // columns with more fallback in-edges: the whole CTA

using row_io::cp_async16;
using row_io::cp_async4;
using row_io::cp_async_wait_all;
using row_io::window_index;

struct BandArgs {
  const void* x;
  const float* g;
  const float* as;
  const float4* st;
  int64_t n, col_offset, x_rows, heads, f;
  int64_t R;       // rows of a tile: a window slot
  int64_t ell_R;   // the pair's block rows (the forward ELL's ids are local to them)
  float slope;
  const int32_t* ell;
  int64_t k_width;
  const int64_t* t_rowptr;
  const int32_t* t_rows;
  const int64_t* fb_rowptr;
  const int32_t* fb_src;
  const int64_t* fbt_rowptr;
  const int32_t* fbt_dst;
  float *dx, *dad, *das;
  int n_chunks;
  bool x_vec, g_vec;   // 16-byte (8-byte bf16) pieces of x rows; of g and dx rows
  attn::Parts xp, gp;  // kParts: a shard's tables A (x) and B (g); x_rows their band
};

// Window row idx keeps its quad q at quad (q + idx) % kNQ: the rows that a
// warp's threads read together then spread over the banks.
template <int kNQ>
__device__ __forceinline__ int rot_quad(int idx, int q) {
  const int p = q + idx % kNQ;
  return p >= kNQ ? p - kNQ : p;
}

// Rows [q0, q0 + R) of ``src`` (row stride ``stride``), elements [col0,
// col0 + fcv), into window rows idx0.. (zeros past fcv and for rows outside
// [0, x_rows)): float32 by cp.async (16 bytes where ``async16``, else 4),
// bfloat16 by plain loads.  stage_rows_at takes each row's pointer from
// row_at(qr) (a table in parts).
template <int kNQ, typename T, typename RowAt>
__device__ __forceinline__ void stage_rows_at(float* win, int idx0, const RowAt& row_at,
                                              int64_t q0, int R, int64_t x_rows, int64_t col0,
                                              int fcv, bool async16) {
  for (int it = threadIdx.x; it < R * kNQ; it += kBandThreads) {
    const int row = it / kNQ, q = it - row * kNQ, e = 4 * q;
    const int idx = idx0 + row;
    float* d = win + 4 * (idx * kNQ + rot_quad<kNQ>(idx, q));
    const int64_t qr = q0 + row;
    if (qr < 0 || qr >= x_rows || e >= fcv) {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const T* p = row_at(qr) + col0 + e;
    if constexpr (sizeof(T) == 4) {
      if (async16 && e + 4 <= fcv) {
        cp_async16(d, reinterpret_cast<const float*>(p));
      } else {   // unaligned rows (F % 4 != 0): 4-byte copies, zeros past fcv
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (e + i < fcv)
            cp_async4(d + i, reinterpret_cast<const float*>(p) + i);
          else
            d[i] = 0.0f;
        }
      }
    } else {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = e + i < fcv ? row_io::load1(p + i) : 0.0f;
      *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int kNQ, typename T>
__device__ __forceinline__ void stage_rows(float* win, int idx0, const T* __restrict__ src,
                                           int64_t q0, int R, int64_t x_rows, int64_t stride,
                                           int64_t col0, int fcv, bool async16) {
  stage_rows_at<kNQ, T>(win, idx0, [&](int64_t qr) { return src + qr * stride; }, q0, R,
                        x_rows, col0, fcv, async16);
}

// The stats (float4) of rows [q0, q0 + R), head h, into window rows idx0..
__device__ __forceinline__ void stage_stats(float4* st_s, int idx0, const float4* __restrict__ st,
                                            int64_t q0, int R, int64_t x_rows, int64_t heads,
                                            int64_t h) {
  for (int row = threadIdx.x; row < R; row += kBandThreads) {
    const int64_t qr = q0 + row;
    float* d = reinterpret_cast<float*>(st_s + idx0 + row);
    if (qr < 0 || qr >= x_rows)
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 1.0f, 0.0f);
    else
      cp_async16(d, reinterpret_cast<const float*>(st + qr * heads + h));
  }
}

// A team thread's quads 4 (kSub j + s), j < kNQT, of a row chunk (zeros
// past fcv) into registers: the team's threads read neighbouring pieces.
template <int kNQT, typename T>
__device__ __forceinline__ void load_team_chunk(const T* __restrict__ p, int s, int fcv,
                                                bool vec, float (&v)[4 * kNQT]) {
#pragma unroll
  for (int j = 0; j < kNQT; ++j) {
    const int e = 4 * (kSub * j + s);
    if (vec && e + 4 <= fcv) {
      row_io::load_row<4>(p + e, v + 4 * j);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * j + i] = e + i < fcv ? row_io::load1(p + e + i) : 0.0f;
    }
  }
}

// kRound: the window slots in ``staged`` (a mask of the three), R rows of
// kFC floats each, rounded to bfloat16 in place once they have arrived; the
// window serves the band edges only.
template <int kFC>
__device__ __forceinline__ void round_slots(float* win, int staged, int R) {
#pragma unroll 1
  for (int slot = 0; slot < 3; ++slot) {
    if (!(staged >> slot & 1)) continue;   // the same in every thread
    float* w = win + (int64_t)slot * R * kFC;
    for (int it = threadIdx.x; it < R * kFC; it += kBandThreads) w[it] = attn::round_bf16(w[it]);
  }
  __syncthreads();
}

// The 4 elements of window row idx's quad q.
template <int kNQ>
__device__ __forceinline__ float4 window_quad(const float* win, int idx, int q) {
  return reinterpret_cast<const float4*>(win)[idx * kNQ + rot_quad<kNQ>(idx, q)];
}

// A value from team thread u, and the team's sum.
template <typename T>
__device__ __forceinline__ T from_team(T v, int u) {
  return row_io::from_team<kSub>(v, u);
}
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int off = 1; off < kSub; off <<= 1)
    v += __shfl_xor_sync(row_io::team_mask<kSub>(), v, off, kSub);
  return v;
}

// dst pass: dad[r, h] = g[r] . (sum_c w_rc x[c]) - t[r] sum_c w_rc over row
// r's band edges (x and alpha_src of the window in shared memory) and its
// fallback edges (read from global memory), one chunk of F at a time (the
// dot parts added in chunk order in dad).  Team thread s holds the row's ids
// s, s + kSub, ... and computes their weights, which the team shares.
template <typename TX, int kNQT, bool kExp, bool kDots, bool kFar = false, bool kRound = false,
          bool kParts = false>
__global__ void __launch_bounds__(kBandThreads, 1) band_dst_kernel(BandArgs a) {
  constexpr int kNQ = kSub * kNQT, kFC = 4 * kNQ, kIds = kMaxIds / kSub;
  extern __shared__ __align__(16) float smem[];
  const int R = (int)a.R;
  float* xs = smem;                 // [3R][kFC]
  float* as_s = xs + 3 * R * kFC;   // [3R]
  const TX* x = static_cast<const TX*>(a.x);
  const int s = threadIdx.x % kSub, team = threadIdx.x / kSub;
  const int64_t hf = a.heads * a.f;
  // kParts: source rows from table A (x, a tail row's alpha_src in its
  // head), a row's own g from table B's own part
  auto x_row = [&](int64_t c) -> const TX* {
    if constexpr (kParts) return attn::part_row<TX>(a.xp, c, hf);
    else return x + c * hf;
  };
  auto as_of = [&](int64_t c, int64_t h) -> float {
    if constexpr (kParts) {
      if (c >= a.xp.band) return __ldg(attn::tail_head(a.xp, c) + h);
    }
    return __ldg(a.as + c * a.heads + h);
  };
  const int64_t fb_rows = kParts ? a.xp.rows : a.x_rows;
  const int64_t n_blocks = (a.n + R - 1) / R;
  const int64_t tiles = n_blocks * a.heads;
  const int64_t p0 = tiles * blockIdx.x / gridDim.x, p1 = tiles * (blockIdx.x + 1) / gridDim.x;
  // chunk-major: every chunk walks all of the CTA's tiles, so the ring keeps
  // two slots from one tile to the next
  for (int k = 0; k < a.n_chunks; ++k) {
    const int fcv = (int)(a.f - (int64_t)k * kFC < kFC ? a.f - (int64_t)k * kFC : kFC);
    const bool last = k == a.n_chunks - 1;
    int64_t tag[3] = {-1, -1, -1};   // what each slot holds: h * (n_blocks + 2) + lb
    for (int64_t p = p0; p < p1; ++p) {
      const int64_t h = p / n_blocks, b = p % n_blocks;
      const int64_t base = (b - 1) * R + a.col_offset;   // input row of window id 0
      const int b3 = (int)(b % 3);
      // kFar: the ELL's ids are local to the pair's blocks of ell_R rows;
      // a row's ids plus rofs0 (plus ell_R from tile row bnd on) are ids of
      // this tile's window
      const int64_t eb = kFar ? b * R / a.ell_R : 0;
      const int rofs0 = kFar ? (int)((eb - 1) * a.ell_R - (b - 1) * R) : 0;
      const int bnd = kFar ? (int)((eb + 1) * a.ell_R - b * R) : 0;
      const int64_t col0 = h * a.f + (int64_t)k * kFC;
      int staged = 0;   // the slots staged for this tile
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int64_t lb = b + i;
        const int slot = (int)(lb % 3);
        const int64_t want = h * (n_blocks + 2) + lb;
        if (tag[slot] == want) continue;   // the same in every thread
        const int64_t q0 = (lb - 1) * R + a.col_offset;
        if constexpr (kParts)
          stage_rows_at<kNQ, TX>(xs, slot * R, x_row, q0, R, a.x_rows, col0, fcv, a.x_vec);
        else
          stage_rows<kNQ, TX>(xs, slot * R, x, q0, R, a.x_rows, hf, col0, fcv, a.x_vec);
        for (int it = threadIdx.x; it < R; it += kBandThreads) {
          const int64_t q = q0 + it;
          as_s[slot * R + it] = q >= 0 && q < a.x_rows ? __ldg(a.as + q * a.heads + h) : 0.0f;
        }
        tag[slot] = want;
        if constexpr (kRound) staged |= 1 << slot;
      }
      // a row's ids, stats, g chunk and fallback range; the first row's are
      // in flight while the window arrives, each next row's while the row
      // before it is walked
      struct Row {
        int32_t ids[kIds];
        float4 sr;
        float gv[4 * kNQT];
        int64_t fp0, fp1;
      };
      auto load_row = [&](Row& w, int i) {
        const int64_t r = b * R + i;
        const bool ok = i < R && r < a.n;
        const int64_t rx = r + a.col_offset;
#pragma unroll
        for (int m = 0; m < kIds; ++m) {
          const int kk = kSub * m + s;
          w.ids[m] = ok && kk < a.k_width ? a.ell[r * a.k_width + kk] : -1;
        }
        w.sr = make_float4(0.0f, 0.0f, 1.0f, 0.0f);
        w.fp0 = w.fp1 = 0;
        if (ok) {
          w.sr = __ldg(a.st + rx * a.heads + h);
          const float* g_r = kParts ? static_cast<const float*>(a.gp.own) + r * hf : a.g + rx * hf;
          load_team_chunk<kNQT>(g_r + col0, s, fcv, a.g_vec, w.gv);
          w.fp0 = a.fb_rowptr[r];
          w.fp1 = a.fb_rowptr[r + 1];
        }
      };
      Row cur, nxt;
      load_row(cur, team);
      cp_async_wait_all();
      __syncthreads();   // the window is in shared memory
      // bfloat16 x is exact in bfloat16 already
      if constexpr (kRound && std::is_same<TX, float>::value) round_slots<kFC>(xs, staged, R);
      for (int i = team; i < R; i += kTeams) {
        const int64_t r = b * R + i;
        if (r >= a.n) break;   // the same in the whole team
        if (i + kTeams < R) load_row(nxt, i + kTeams);
        const float4 sr = cur.sr;
        const int64_t fp0 = cur.fp0, fp1 = cur.fp1;
        // the first round of fallback sources, in flight during the band
        const int32_t fb_first = fp0 + s < fp1 ? a.fb_src[fp0 + s] : -1;
        float d = 0.0f, w_sum = 0.0f;   // this thread's parts
        const int rofs = kFar ? rofs0 + (i >= bnd ? (int)a.ell_R : 0) : 0;
        auto band_round = [&](int32_t id) {
          int idx = -1;   // window row; kFar: -2 - input row of a source past the window
          float w = 0.0f;
          if constexpr (kFar) {
            const int j = id + rofs;
            if (id >= 0 && base + j >= 0 && base + j < a.x_rows) {
              if (j < 3 * R && j >= 0) {
                idx = window_index(j, R, b3);
                float aa;
                edge_weights<kExp>(sr, as_s[idx], a.slope, aa, w);
                w_sum += w;
              } else {
                idx = -2 - (int)(base + j);   // its weight below
              }
            }
          } else if (id >= 0 && base + id >= 0 && base + id < a.x_rows) {
            idx = window_index(id, R, b3);
            float aa;
            edge_weights<kExp>(sr, as_s[idx], a.slope, aa, w);
            w_sum += w;
          }
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            const int iu = from_team(idx, u);
            const float wu = from_team(w, u);
            if (iu < 0) continue;
            float dot = 0.0f;
#pragma unroll
            for (int j = 0; j < kNQT; ++j) {
              const float4 v = window_quad<kNQ>(xs, iu, kSub * j + s);
              if (kDots) {   // kRound: the window's x was rounded when staged
                dot = fmaf(band_operand<float, kRound>(cur.gv[4 * j]), v.x, dot);
                dot = fmaf(band_operand<float, kRound>(cur.gv[4 * j + 1]), v.y, dot);
                dot = fmaf(band_operand<float, kRound>(cur.gv[4 * j + 2]), v.z, dot);
                dot = fmaf(band_operand<float, kRound>(cur.gv[4 * j + 3]), v.w, dot);
              } else {
                const float vv[4] = {v.x, v.y, v.z, v.w};
                sink<4>(vv);
              }
            }
            d = fmaf(wu, dot, d);
          }
          // kFar: the round's sources past the window (rare), after its
          // window sources: every team thread computes the weight (thread 0
          // adds it to w_sum) and reads its part of the row from global memory
          if (kFar && __any_sync(row_io::team_mask<kSub>(), idx < -1)) {
#pragma unroll 1
            for (int u = 0; u < kSub; ++u) {
              const int iu = from_team(idx, u);
              if (iu >= -1) continue;
              const int64_t c = -2 - iu;
              float aa, wu;
              edge_weights<kExp>(sr, __ldg(a.as + c * a.heads + h), a.slope, aa, wu);
              if (s == 0) w_sum += wu;
              float xf[4 * kNQT];
              load_team_chunk<kNQT>(x_row(c) + col0, s, fcv, a.x_vec, xf);
              float dot = 0.0f;
#pragma unroll
              for (int q = 0; q < 4 * kNQT; ++q)
                dot = fmaf(band_operand<float, kRound>(cur.gv[q]),
                           band_operand<TX, kRound>(xf[q]), dot);
              d = fmaf(wu, dot, d);
            }
          }
        };
#pragma unroll
        for (int m = 0; m < kIds; ++m) band_round(cur.ids[m]);
        for (int64_t kk0 = kMaxIds; kk0 < a.k_width; kk0 += kSub)
          band_round(kk0 + s < a.k_width ? a.ell[r * a.k_width + kk0 + s] : -1);
        for (int64_t e0 = fp0; e0 < fp1; e0 += kSub) {
          int32_t c = e0 == fp0 ? fb_first : e0 + s < fp1 ? a.fb_src[e0 + s] : -1;
          if (c >= fb_rows) c = -1;
          float w = 0.0f;
          if (c >= 0) {
            float aa;
            edge_weights<kExp>(sr, as_of(c, h), a.slope, aa, w);
            w_sum += w;
          }
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            const int32_t cu = from_team(c, u);
            const float wu = from_team(w, u);
            if (cu < 0) continue;
            float xf[4 * kNQT];
            load_team_chunk<kNQT>(x_row(cu) + col0, s, fcv, a.x_vec, xf);
            float dot = 0.0f;
#pragma unroll
            for (int q = 0; q < 4 * kNQT; ++q) dot = fmaf(cur.gv[q], xf[q], dot);
            if (!kDots) sink<4 * kNQT>(xf);
            d = fmaf(wu, kDots ? dot : 0.0f, d);
          }
        }
        if (!kDots) sink<4 * kNQT>(cur.gv);
        d = team_sum(d);
        w_sum = team_sum(w_sum);
        if (s == 0) {
          const int64_t o = r * a.heads + h;
          float v = k == 0 ? d : a.dad[o] + d;
          if (last) v -= sr.w * w_sum;
          a.dad[o] = v;
        }
        cur = nxt;
      }
      __syncthreads();   // the window is read; the next tile may restage it
    }
  }
}

// src pass: dx[c, h] = sum_r a_rc g[r] and das[c, h] = x[c] . (sum_r w_rc
// g[r]) - sum_r w_rc t[r] over column c's band in-edges (the band CSR by
// source; g and the stats of the window in shared memory) and fallback
// in-edges (global memory; a column with more than kLongFb of them is taken
// by the whole CTA, its shares added in a fixed order).  Team thread s
// reads in-edges s, s + kSub, ... and computes their weights.
template <typename TX, int kNQT, bool kExp, bool kDots, bool kFar = false, bool kRound = false,
          bool kParts = false>
__global__ void __launch_bounds__(kBandThreads, 1) band_src_kernel(BandArgs a) {
  constexpr int kNQ = kSub * kNQT, kFC = 4 * kNQ;
  extern __shared__ __align__(16) float smem[];
  const int R = (int)a.R;
  float* gs = smem;                                            // [3R][kFC]
  float4* st_s = reinterpret_cast<float4*>(gs + 3 * R * kFC);  // [3R]
  float* red = reinterpret_cast<float*>(st_s + 3 * R);         // [kBandWarps][kFC + 2]
  unsigned char* long_col = reinterpret_cast<unsigned char*>(red + kBandWarps * (kFC + 2));
  const TX* x = static_cast<const TX*>(a.x);
  const int s = threadIdx.x % kSub, team = threadIdx.x / kSub;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t hf = a.heads * a.f;
  // kParts: destination rows from table B (g, a tail row's stats in its
  // head), a column's own x from table A's own part
  auto g_row = [&](int64_t r) -> const float* {
    if constexpr (kParts) return attn::part_row<float>(a.gp, r, hf);
    else return a.g + r * hf;
  };
  auto st_of = [&](int64_t r, int64_t h) -> float4 {
    if constexpr (kParts) {
      if (r >= a.gp.band) return __ldg(reinterpret_cast<const float4*>(attn::tail_head(a.gp, r)) + h);
    }
    return __ldg(a.st + r * a.heads + h);
  };
  auto x_own = [&](int64_t c) -> const TX* {
    if constexpr (kParts) return static_cast<const TX*>(a.xp.own) + c * hf;
    else return x + (c + a.col_offset) * hf;
  };
  const int64_t fb_rows = kParts ? a.gp.rows : a.x_rows;
  const int64_t n_blocks = (a.n + R - 1) / R;
  const int64_t tiles = n_blocks * a.heads;
  const int64_t p0 = tiles * blockIdx.x / gridDim.x, p1 = tiles * (blockIdx.x + 1) / gridDim.x;
  // chunk-major: every chunk walks all of the CTA's tiles, so the ring keeps
  // two slots from one tile to the next
  for (int k = 0; k < a.n_chunks; ++k) {
    const int fcv = (int)(a.f - (int64_t)k * kFC < kFC ? a.f - (int64_t)k * kFC : kFC);
    const bool last = k == a.n_chunks - 1;
    int64_t tag[3] = {-1, -1, -1};
    for (int64_t p = p0; p < p1; ++p) {
      const int64_t h = p / n_blocks, b = p % n_blocks;
      const int64_t base = (b - 1) * R + a.col_offset;
      const int b3 = (int)(b % 3);
      const int64_t col0 = h * a.f + (int64_t)k * kFC;
      int staged = 0;   // the slots staged for this tile
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int64_t lb = b + i;
        const int slot = (int)(lb % 3);
        const int64_t want = h * (n_blocks + 2) + lb;
        if (tag[slot] == want) continue;   // the same in every thread
        const int64_t q0 = (lb - 1) * R + a.col_offset;
        if constexpr (kParts)
          stage_rows_at<kNQ, float>(gs, slot * R, g_row, q0, R, a.x_rows, col0, fcv, a.g_vec);
        else
          stage_rows<kNQ, float>(gs, slot * R, a.g, q0, R, a.x_rows, hf, col0, fcv, a.g_vec);
        stage_stats(st_s, slot * R, a.st, q0, R, a.x_rows, a.heads, h);
        tag[slot] = want;
        if constexpr (kRound) staged |= 1 << slot;
      }
      // a column's x chunk, alpha_src and in-edge ranges; the first
      // column's are in flight while the window arrives, each next
      // column's while the column before it is walked
      struct Col {
        float xv[4 * kNQT];
        float as_c;
        int64_t tp0, tp1, fb0, fb1;
      };
      auto load_col = [&](Col& w, int i) {
        const int64_t c = b * R + i;
        w.as_c = 0.0f;
        w.tp0 = w.tp1 = w.fb0 = w.fb1 = 0;
        if (i < R && c < a.n) {
          const int64_t cx = c + a.col_offset;
          load_team_chunk<kNQT>(x_own(c) + col0, s, fcv, a.x_vec, w.xv);
          w.as_c = __ldg(a.as + cx * a.heads + h);
          w.tp0 = a.t_rowptr[c];
          w.tp1 = a.t_rowptr[c + 1];
          w.fb0 = a.fbt_rowptr[c];
          w.fb1 = a.fbt_rowptr[c + 1];
        }
      };
      Col cur, nxt;
      load_col(cur, team);
      cp_async_wait_all();
      __syncthreads();   // the window is in shared memory
      if constexpr (kRound) round_slots<kFC>(gs, staged, R);
      bool any_long = false;
      for (int i = team; i < R; i += kTeams) {
        const int64_t c = b * R + i;
        if (c >= a.n) break;   // the same in the whole team
        if (i + kTeams < R) load_col(nxt, i + kTeams);
        const float as_c = cur.as_c;
        const int64_t tp0 = cur.tp0, tp1 = cur.tp1, fb0 = cur.fb0, fb1 = cur.fb1;
        // the first round of fallback in-edges, in flight during the band
        const int32_t fb_first = fb0 + s < fb1 ? a.fbt_dst[fb0 + s] : -1;
        float acc[4 * kNQT];
#pragma unroll
        for (int q = 0; q < 4 * kNQT; ++q) acc[q] = 0.0f;
        float d = 0.0f, wt_sum = 0.0f;   // this thread's parts
        // an in-edge with weights (au, wu) and the team thread's part of its
        // g chunk: dx += au g, d += wu (g . x); ``band`` std::true_type for
        // a band edge (kRound: x rounded here, au and g by the caller)
        auto add = [&](float au, float wu, const float* gq, auto band) {
          constexpr bool kR = kRound && decltype(band)::value;
          float dot = 0.0f;
#pragma unroll
          for (int q = 0; q < 4 * kNQT; ++q) {
            if (kDots) {
              acc[q] = fmaf(au, gq[q], acc[q]);
              dot = fmaf(band_operand<TX, kR>(cur.xv[q]), gq[q], dot);
            }
          }
          if (!kDots) sink<4 * kNQT>(gq);
          d = fmaf(wu, dot, d);
        };
        // band in-edges: destination rows in c's window (kFar: or past it)
        for (int64_t e0 = tp0; e0 < tp1; e0 += kSub) {
          const int32_t q = e0 + s < tp1 ? a.t_rows[e0 + s] : -1;
          int idx = -1;
          float aa = 0.0f, w = 0.0f;
          if (q >= 0 && q < a.x_rows) {
            const int j = (int)(q - base);
            if (!kFar || (j >= 0 && j < 3 * R)) {
              idx = window_index(j, R, b3);
              const float4 s4 = st_s[idx];
              edge_weights<kExp>(s4, as_c, a.slope, aa, w);
              wt_sum = fmaf(w, s4.w, wt_sum);
            } else {   // kFar: a destination row past the window, below
              idx = -2 - q;
            }
          }
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            const int iu = from_team(idx, u);
            const float au = from_team(aa, u), wu = from_team(w, u);
            if (iu < 0) continue;
            float gq[4 * kNQT];
#pragma unroll
            for (int j = 0; j < kNQT; ++j) {
              const float4 v = window_quad<kNQ>(gs, iu, kSub * j + s);
              gq[4 * j] = v.x;
              gq[4 * j + 1] = v.y;
              gq[4 * j + 2] = v.z;
              gq[4 * j + 3] = v.w;
            }
            add(band_operand<float, kRound>(au), wu, gq, std::true_type());
          }
          // kFar: the round's destinations past the window (rare), after
          // its window destinations: every team thread computes the weights
          // (thread 0 adds to wt_sum) and reads its part of the row from
          // global memory
          if (kFar && __any_sync(row_io::team_mask<kSub>(), idx < -1)) {
#pragma unroll 1
            for (int u = 0; u < kSub; ++u) {
              const int iu = from_team(idx, u);
              if (iu >= -1) continue;
              const int64_t r = -2 - iu;
              const float4 s4 = __ldg(a.st + r * a.heads + h);
              float au, wu;
              edge_weights<kExp>(s4, as_c, a.slope, au, wu);
              if (s == 0) wt_sum = fmaf(wu, s4.w, wt_sum);
              float gq[4 * kNQT];
              load_team_chunk<kNQT>(g_row(r) + col0, s, fcv, a.g_vec, gq);
              if constexpr (kRound) {
#pragma unroll
                for (int q = 0; q < 4 * kNQT; ++q) gq[q] = attn::round_bf16(gq[q]);
              }
              add(band_operand<float, kRound>(au), wu, gq, std::true_type());
            }
          }
        }
        const bool is_long = fb1 - fb0 > kLongFb;
        if (s == 0) long_col[i] = is_long;
        any_long |= is_long;
        for (int64_t e0 = fb0; !is_long && e0 < fb1; e0 += kSub) {
          const int32_t r = e0 == fb0 ? fb_first : e0 + s < fb1 ? a.fbt_dst[e0 + s] : -1;
          const bool ok = r >= 0 && r < fb_rows;
          float aa = 0.0f, w = 0.0f;
          if (ok) {
            const float4 s4 = st_of(r, h);
            edge_weights<kExp>(s4, as_c, a.slope, aa, w);
            wt_sum = fmaf(w, s4.w, wt_sum);
          }
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            const int32_t ru = from_team(ok ? r : -1, u);
            const float au = from_team(aa, u), wu = from_team(w, u);
            if (ru < 0) continue;
            float gq[4 * kNQT];
            load_team_chunk<kNQT>(g_row(ru) + col0, s, fcv, a.g_vec, gq);
            add(au, wu, gq, std::false_type());
          }
        }
        if (!kDots) sink<4 * kNQT>(cur.xv);
        float* dxp = a.dx + c * hf + col0;
#pragma unroll
        for (int j = 0; j < kNQT; ++j) {
          const int e = 4 * (kSub * j + s);
          if (a.g_vec && e + 4 <= fcv) {
            *reinterpret_cast<float4*>(dxp + e) =
                make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
          } else {
#pragma unroll
            for (int i2 = 0; i2 < 4; ++i2)
              if (e + i2 < fcv) dxp[e + i2] = acc[4 * j + i2];
          }
        }
        d = team_sum(d);
        wt_sum = team_sum(wt_sum);
        if (s == 0) {
          const int64_t o = c * a.heads + h;
          float v = k == 0 ? d : a.das[o] + d;
          if (last) v -= wt_sum;
          a.das[o] = v;
        }
        cur = nxt;
      }
      // columns with many fallback in-edges (the transpose's hub columns):
      // each team a fixed share, summed by a fixed tree
      if (__syncthreads_or(any_long)) {
        for (int i = 0; i < R && b * R + i < a.n; ++i) {
          if (!long_col[i]) continue;   // the same in every thread
          const int64_t c = b * R + i;
          const int64_t cx = c + a.col_offset;
          const int64_t e0 = a.fbt_rowptr[c], len = a.fbt_rowptr[c + 1] - e0;
          float xv[4 * kNQT];
          load_team_chunk<kNQT>(x_own(c) + col0, s, fcv, a.x_vec, xv);
          const float as_c = __ldg(a.as + cx * a.heads + h);
          float acc[4 * kNQT];
#pragma unroll
          for (int q = 0; q < 4 * kNQT; ++q) acc[q] = 0.0f;
          float d = 0.0f, wt_sum = 0.0f;
          const int64_t s0 = e0 + len * team / kTeams, s1 = e0 + len * (team + 1) / kTeams;
          for (int64_t e = s0; e < s1; ++e) {   // the team walks its share
            const int32_t r = a.fbt_dst[e];
            if (r < 0 || r >= fb_rows) continue;
            const float4 s4 = st_of(r, h);
            float aa, w;
            edge_weights<kExp>(s4, as_c, a.slope, aa, w);
            if (s == 0) wt_sum = fmaf(w, s4.w, wt_sum);
            float gq[4 * kNQT];
            load_team_chunk<kNQT>(g_row(r) + col0, s, fcv, a.g_vec, gq);
            float dot = 0.0f;
#pragma unroll
            for (int q = 0; q < 4 * kNQT; ++q) {
              acc[q] = fmaf(aa, gq[q], acc[q]);
              dot = fmaf(xv[q], gq[q], dot);
            }
            d = fmaf(w, dot, d);
          }
          // the warp's teams (same s) by a fixed tree, then its threads' d
#pragma unroll
          for (int off = kSub; off < 32; off <<= 1) {
#pragma unroll
            for (int q = 0; q < 4 * kNQT; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
            d += __shfl_xor_sync(0xffffffffu, d, off);
            wt_sum += __shfl_xor_sync(0xffffffffu, wt_sum, off);
          }
          d = team_sum(d);
          wt_sum = team_sum(wt_sum);
          if (lane < kSub) {
#pragma unroll
            for (int j = 0; j < kNQT; ++j)
#pragma unroll
              for (int i2 = 0; i2 < 4; ++i2)
                red[warp * (kFC + 2) + 4 * (kSub * j + s) + i2] = acc[4 * j + i2];
            if (lane == 0) {
              red[warp * (kFC + 2) + kFC] = d;
              red[warp * (kFC + 2) + kFC + 1] = wt_sum;
            }
          }
          __syncthreads();
          if (threadIdx.x <= kFC) {   // the warps in order
            const int q = threadIdx.x;
            float v = 0.0f, wt = 0.0f;
            for (int w2 = 0; w2 < kBandWarps; ++w2) {
              v += red[w2 * (kFC + 2) + q];
              if (q == kFC) wt += red[w2 * (kFC + 2) + kFC + 1];
            }
            if (q < fcv)
              a.dx[c * hf + col0 + q] += v;
            else if (q == kFC)
              a.das[c * a.heads + h] += v - (last ? wt : 0.0f);
          }
          __syncthreads();
        }
      }
      __syncthreads();   // the window is read; the next tile may restage it
    }
  }
}

// Shared memory of the band kernels at kNQ quads a chunk: the window rows,
// the stats of the window (src; alpha_src for dst, smaller), the reduction
// rows of the hub columns and a flag a column.
inline size_t band_smem(int64_t R, int kNQ) {
  return sizeof(float) * (3 * R * 4 * kNQ + 3 * R * 4 + kBandWarps * (4 * kNQ + 2)) + R;
}

// Quads a team thread holds in a chunk of the band kernels (a chunk is
// 32 kNQT elements): 2 where the whole head (F <= 64), or an even part of a
// wider one, takes more than 32 elements, else 1.
inline int band_quads(int64_t f) {
  const int64_t chunks = (f + kMaxChunk - 1) / kMaxChunk;
  return (int)(((f + chunks - 1) / chunks + 4 * kSub - 1) / (4 * kSub));
}

// The kernels a pair takes, decided by shape before any launch.
// - The band kernels over shared-memory windows where the pair has the
//   band CSR by source and a window of 3R rows fits the device's shared
//   memory a block at 32-element chunks (R <= 526 on the H100): tiles of R
//   rows with the head in chunks of 32 nqt elements where that window fits
//   (R <= 274 at 64-element chunks on the H100; F = 64 at R = 256: 196 KB),
//   else (such as R = 512) tiles of the largest multiple of 32 rows whose
//   window fits the chunk (256 on the H100), at most R, so that a tile
//   spans at most two of the pair's blocks: the band edges that reach past
//   a tile's window (|c - r| > its rows; a few thousandths of the banded
//   graph's at R = 512) read their rows from global memory.
// - Else the warp-per-node kernels where the pair has t_ell, else none.
enum Design { kNoDesign = 0, kWindows = 1, kWarpPerNode = 2 };

struct Plan {
  Design design = kNoDesign;
  int nqt = 0;        // quads a team thread (window kernels)
  int64_t tile = 0;   // rows a tile (window kernels)
};

int choose_design(int64_t R, int64_t f, bool band_csr, bool t_ell, Plan* plan) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const auto fits = [&](int64_t rows, int nqt) {
    return band_smem(rows, kSub * nqt) <= (size_t)smem_max;
  };
  *plan = Plan{};
  if (band_csr && fits(R, 1)) {
    const int nqt = band_quads(f);
    if (fits(R, nqt)) {
      *plan = Plan{kWindows, nqt, R};
    } else {
      int64_t tile = R / 32 * 32;
      while (tile > 32 && !fits(tile, nqt)) tile -= 32;
      *plan = Plan{kWindows, nqt, tile};
    }
  } else if (t_ell) {
    plan->design = kWarpPerNode;
  }
  return 0;
}

// Probe phases (slab_attn_bwd_probe): which passes run, and whether the
// edge weights take expf and the per-edge FMAs run.  The real entry runs
// every phase.
constexpr int kDstPass = 1, kSrcPass = 2, kExpPhase = 4, kDotPhase = 8;
constexpr int kAllPhases = kDstPass | kSrcPass | kExpPhase | kDotPhase;

// The warp-per-node kernels: the whole backward over a pair's t_ell.
template <typename TX, int kPer, bool kExp, bool kDots, bool kRound, bool kParts = false>
int launch_passes(const Args& a, int phases, cudaStream_t stream) {
  int64_t blocks = (a.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the node loops stride over the rest
  const TX* x = static_cast<const TX*>(a.x);
  const float* g = static_cast<const float*>(a.g);
  const float* as = static_cast<const float*>(a.as);
  const float4* st = static_cast<const float4*>(a.st);
  if (phases & kDstPass) {
    attn_bwd_dst_kernel<TX, kPer, kExp, kDots, kRound, kParts>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            x, g, as, st, a.n, a.col_offset, a.x_rows, a.heads, a.f, a.slope,
            static_cast<const int32_t*>(a.ell),
            a.k_width, a.block_rows, static_cast<const int64_t*>(a.fb_rowptr),
            static_cast<const int32_t*>(a.fb_src), static_cast<float*>(a.dad), a.xp, a.gp);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (phases & kSrcPass) {
    attn_bwd_src_kernel<TX, kPer, kExp, kDots, kRound, kParts>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            x, g, as, st, a.n, a.col_offset, a.x_rows, a.heads, a.f, a.slope,
            static_cast<const int32_t*>(a.t_ell),
            a.t_width, a.block_rows, static_cast<const int64_t*>(a.fbt_rowptr),
            static_cast<const int32_t*>(a.fbt_dst), static_cast<float*>(a.dx),
            static_cast<float*>(a.das), a.xp, a.gp);
  }
  return (int)cudaGetLastError();
}

// One band kernel (the src pass where kSrc, else the dst pass) over tiles
// of ``tile`` rows, kNQT quads a team thread, so 32 kNQT elements a chunk;
// kFar where tiles are shorter than the pair's blocks.
template <typename TX, int kNQT, bool kSrc, bool kExp, bool kDots, bool kFar, bool kRound,
          bool kParts = false>
int launch_band(const Args& a, int64_t tile, cudaStream_t stream) {
  constexpr int kFC = 4 * kSub * kNQT;
  const BandArgs b{a.x, static_cast<const float*>(a.g), static_cast<const float*>(a.as),
                   static_cast<const float4*>(a.st), a.n, a.col_offset, a.x_rows, a.heads,
                   a.f, tile, a.block_rows, a.slope, static_cast<const int32_t*>(a.ell),
                   a.k_width, static_cast<const int64_t*>(a.t_rowptr),
                   static_cast<const int32_t*>(a.t_rows),
                   static_cast<const int64_t*>(a.fb_rowptr),
                   static_cast<const int32_t*>(a.fb_src),
                   static_cast<const int64_t*>(a.fbt_rowptr),
                   static_cast<const int32_t*>(a.fbt_dst), static_cast<float*>(a.dx),
                   static_cast<float*>(a.dad), static_cast<float*>(a.das),
                   (int)((a.f + kFC - 1) / kFC),
                   a.f % 4 == 0 && row_io::aligned(a.x, 4 * sizeof(TX)) &&
                       (!kParts || attn::parts_aligned(a.xp, a.heads * a.f * sizeof(TX),
                                                       4 * sizeof(TX))),
                   a.f % 4 == 0 && row_io::aligned(a.g, 16) && row_io::aligned(a.dx, 16) &&
                       (!kParts || attn::parts_aligned(a.gp, a.heads * a.f * 4, 16)),
                   a.xp, a.gp};
  const size_t smem = band_smem(tile, kSub * kNQT);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  void (*kernel)(BandArgs);
  if constexpr (kSrc)
    kernel = band_src_kernel<TX, kNQT, kExp, kDots, kFar, kRound, kParts>;
  else
    kernel = band_dst_kernel<TX, kNQT, kExp, kDots, kFar, kRound, kParts>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBandThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // persistent: as many CTAs as are resident at once
  const int64_t tiles = (a.n + tile - 1) / tile * a.heads;
  const int64_t resident = (int64_t)per_sm * sms;
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  kernel<<<grid, kBandThreads, smem, stream>>>(b);
  return (int)cudaGetLastError();
}

}  // namespace
