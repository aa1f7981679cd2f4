// Fused slab attention forward: for every row r < n and head h, over the
// row's edges r <- c (the band ELL's and the fallback's alike; c indexes x
// and as, whose x_rows rows hold the band's columns at col_offset: 0 and n
// for a whole graph, R and n + 2R for a row shard's halo-extended operands),
//   e_rc       = leakyrelu(ad[r,h] + as[c,h])
//   m[r,h]     = max_c e_rc                (0 for a row with no edge)
//   s[r,h]     = sum_c exp(e_rc - m[r,h])
//   out[r,h,:] = sum_c exp(e_rc - m[r,h]) x[c,h,:] / max(s[r,h], 1e-16)
// x is (x_rows, H, F) float32 or bfloat16; ad, m, s are (n, H) and as
// (x_rows, H) float32; out is float32.  With round_bf16 the band edges'
// weights and x elements are rounded to bfloat16 before they are multiplied
// (the JAX package's MXU operands for compute_dtype bfloat16); the fallback
// edges and every sum stay float32.  Sums run in the plain version's order:
// the band in ELL order, then the fallback in CSR order.
//
// Replaces cugraph_gnn_tpu/ops/pallas/slab_kernel.py::slab_attention_spmm_mh
// (:438; pallas_call :503 over _slab_attn_fwd_kernel :386; H = 1 through
// slab_attention_spmm :546) and, in the shard entry slab_attn_fwd_shard
// (one row shard's whole forward over its table of halo and remote rows,
// the kParts instances), the whole sharded forwards of
// cugraph_gnn_tpu/ops/dist_full_batch.py: _attn_fwd_sharded (:585;
// pallas_call :628, then the fallback edges' distributed gather, segment
// sums and log-sum-exp merge, :642-669) and _attn_fwd_sharded_mh (:974;
// :1019, then :1035-1061).  The TPU kernel builds the (R, 3R) adjacency of a
// row block, takes each head's masked row softmax over the window on the VPU
// and multiplies it with the block's 3R-row window of x on the MXU, G blocks
// stacked in VMEM; the fallback edges join afterwards through segment ops
// and a log-sum-exp merge (slab_kernel.py:517-539), several XLA passes over
// (N, H, F).  Here the fallback edges join the row's softmax through the
// host-built row pointer over the fallback COO (SlabGraph.fb_rowptr), so
// each row's softmax is taken in one place and no (N, H, F) intermediate is
// written.
//
// Bound on the H100: bytes.  A call must read x once, the ELL's real
// entries, the fallback ids and row pointer once, the alphas once, and write
// out, m and s once: at n = 2,449,029, H*F = 256 float32 and 2.76M fallback
// edges that is ~5.4 GB, ~1.6 ms at 3.35 TB/s (chip_smoke.py computes the
// exact count for its inputs); a world-1 shard's call the same, its table's
// parts and tail read once.  The arithmetic is one exp per edge and head
// and one FMA per element and edge (~17 GFLOP), far below the card's rate.
// A warp per row, the first design, re-read each band edge's source row from
// the L2 (32.6 GB a call at that shape) and had every lane recompute each
// edge's score.
//
// Design:
// - The window in shared memory.  Every band edge of row block b has its
//   source in the 3R-row window [(b-1)R, (b+2)R), so a tile is one head (one
//   column chunk of it) of one row block, and the window's rows of that head
//   sit in a ring of three R-row slots of shared memory in x's own type (16
//   quads of 16 bytes a row: F = 64 float32 at R = 256 is 196 KB), with the
//   window's alpha_src; cp.async fills them (4-byte copies for float32 rows
//   that are not 16-byte aligned, such as F = 47).  One 1024-thread CTA a
//   multiprocessor walks a contiguous run of tiles, so moving from block b to
//   b + 1 stages one new slot and x crosses device memory about once per
//   head.  Rows of a head are H*F apart; window ids are 32-bit.
// - A team of kNQ threads owns a row, each thread one quad of the chunk.
//   Team thread s computes the scores of the row's ELL slots s, s + kNQ,
//   ... (up to the row's length, built once with the graph) and of its
//   fallback slots once, keeps them in registers (64 ELL slots; more are
//   recomputed) between the max pass and the weight pass, and the team
//   shares weights and window rows by shuffles.  The exact two-pass
//   softmax keeps each weight as the plain version computes it, which
//   bfloat16 rounding of the weights needs.
// - The block's row scalars (alpha_dst, ELL length, fallback range) and
//   then its fallback slots (source ids and their alpha_src; up to 1024) are
//   loaded into shared memory while the window arrives, so no team waits on
//   a chain of dependent loads.  The fallback edges' rows come from global
//   memory; the next row's ELL slots and first fallback row are in flight
//   while the current row is summed.
// - No atomics: every sum has a fixed order, so two launches agree bit for
//   bit.
// - A row shard's table in parts (attn::Parts: its rows, the R rows before
//   and after them, the packed remote rows with their alpha_src) is read
//   where it lies, no copy of x: each window row from the part that holds
//   it, a fallback slot's row and alpha_src from its id.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_edges.cuh"
#include "row_io.cuh"

namespace {

using row_io::Quad;

constexpr int kThreads = 1024;
constexpr int kKeepIds = 64;   // ELL slots whose scores a team keeps in registers
constexpr int kFbStage = 1024;   // a block's fallback slots staged in shared memory

using attn::round_bf16;

struct Args {
  const void* x;
  const float* ad;
  const float* as;
  int64_t n, col_offset, x_rows, heads, f;
  const int32_t* ell;
  const int32_t* ell_len;   // the slots of each row to read
  int64_t k_width;
  int R;
  const int64_t* fb_rowptr;
  const int32_t* fb_src;
  float slope;
  float *out, *m, *s;
  int n_chunks;
  bool x_vec, out_vec;   // 16-byte aligned rows of x; of out
  attn::Parts xp;        // kParts: x as a shard's table (x unused; x_rows its band)
};

// Shared memory: the window ([3R][kNQ] quads), its alpha_src ([3R]), four
// 4-byte scalars a row of the block and two a staged fallback slot.
inline size_t smem_bytes(int R, int nq) {
  return (size_t)3 * R * nq * 16 + (size_t)3 * R * 4 + (size_t)4 * R * 4 +
         (size_t)2 * kFbStage * 4;
}

template <int kT>
__device__ __forceinline__ float team_max(float v) {
#pragma unroll
  for (int off = 1; off < kT; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(row_io::team_mask<kT>(), v, off, kT));
  return v;
}

template <typename TX, bool kRound, int kNQ, bool kParts>
__global__ void __launch_bounds__(kThreads, 1) attn_fwd_kernel(Args a) {
  constexpr int kE = Quad<TX>::kElems;   // elements a quad
  constexpr int kT = kNQ;                // threads a row, one quad each
  constexpr int kTeams = kThreads / kT;  // rows at once
  constexpr int kFC = kNQ * kE;          // elements a chunk
  constexpr int kKeep = kKeepIds / kT < 4 ? kKeepIds / kT : 4;   // ELL rounds kept
  extern __shared__ __align__(16) uint4 smem[];
  const int R = a.R;
  uint4* win = smem;
  float* as_s = reinterpret_cast<float*>(win + 3 * R * kNQ);   // the window's alpha_src
  // the block's rows (alpha_dst, ELL length, fallback range) and its first
  // kFbStage fallback slots (source, alpha_src)
  float* ad_s = as_s + 3 * R;
  int* len_s = reinterpret_cast<int*>(ad_s + R);
  int* fp0_s = len_s + R;
  int* fp1_s = fp0_s + R;
  int32_t* fbc_s = fp1_s + R;
  float* fba_s = reinterpret_cast<float*>(fbc_s + kFbStage);
  const TX* x = static_cast<const TX*>(a.x);
  const int s = threadIdx.x % kT, team = threadIdx.x / kT;
  const int64_t hf = a.heads * a.f;
  // kParts: x rows from their part of the shard's table, a tail row's
  // alpha_src from its head; fallback ids may name any row of the table
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
  const int64_t tiles = n_blocks * a.heads * a.n_chunks;
  const int64_t p0 = tiles * blockIdx.x / gridDim.x, p1 = tiles * (blockIdx.x + 1) / gridDim.x;
  int64_t tag[3] = {-1, -1, -1};   // what each slot holds: (h, chunk) * (n_blocks + 2) + lb
  for (int64_t p = p0; p < p1; ++p) {
    const int64_t hk = p / n_blocks, b = p % n_blocks;
    const int64_t h = hk / a.n_chunks, k = hk % a.n_chunks;
    const int64_t col0 = h * a.f + k * kFC;   // the chunk's first element in a row
    const int fcv = (int)(a.f - k * kFC < kFC ? a.f - k * kFC : kFC);
    const int b3 = (int)(b % 3);
    const int base = (int)((b - 1) * R + a.col_offset);   // input row of window id 0
    const int e_q = s * kE;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int64_t lb = b + i;
      const int slot = (int)(lb % 3);
      const int64_t want = hk * (n_blocks + 2) + lb;
      if (tag[slot] == want) continue;   // the same in every thread
      const int64_t q0 = (lb - 1) * R + a.col_offset;
      if constexpr (kParts)
        row_io::stage_rows_at<kNQ, kThreads, TX>(win, slot * R, x_row, q0, R, a.x_rows, col0,
                                                  fcv, a.x_vec);
      else
        row_io::stage_rows<kNQ, kThreads, TX>(win, slot * R, x, q0, R, a.x_rows, hf, col0, fcv,
                                               a.x_vec);
      for (int it = threadIdx.x; it < R; it += kThreads) {
        const int64_t q = q0 + it;
        as_s[slot * R + it] = q >= 0 && q < a.x_rows ? __ldg(a.as + q * a.heads + h) : 0.0f;
      }
      tag[slot] = want;
    }
    // the rows' scalars, then the block's fallback slots (ids, alpha_src),
    // loaded while the window arrives
    const int64_t fb_end = a.fb_rowptr[a.n];
    for (int it = threadIdx.x; it < R; it += kThreads) {
      const int64_t r = b * R + it;
      int len = 0;
      int64_t fp0 = fb_end, fp1 = fb_end;
      float adr = 0.0f;
      if (r < a.n) {
        adr = __ldg(a.ad + r * a.heads + h);
        len = a.ell_len[r];
        fp0 = a.fb_rowptr[r];
        fp1 = a.fb_rowptr[r + 1];
      }
      ad_s[it] = adr;
      len_s[it] = len;
      fp0_s[it] = (int)fp0;
      fp1_s[it] = (int)fp1;
    }
    __syncthreads();
    const int fpb = fp0_s[0];   // the block's first fallback slot
    {
      const int cnt = fp1_s[R - 1] - fpb < kFbStage ? fp1_s[R - 1] - fpb : kFbStage;
      for (int e = threadIdx.x; e < cnt; e += kThreads) {
        const int32_t c = a.fb_src[fpb + e];
        const bool ok = c >= 0 && c < fb_rows;
        fbc_s[e] = ok ? c : -1;
        fba_s[e] = ok ? as_of(c, h) : 0.0f;
      }
    }
    // fallback slot e's source (-1: none) and its alpha_src
    auto fb_slot = [&](int e, int32_t& c, float& asc) {
      if (e - fpb < kFbStage) {
        c = fbc_s[e - fpb];
        asc = fba_s[e - fpb];
      } else {
        c = a.fb_src[e];
        if (c >= fb_rows) c = -1;
        asc = c >= 0 ? as_of(c, h) : 0.0f;
      }
    };

    // a row's first ELL slot (this thread's) and its first fallback row
    // (this thread's quad)
    struct Row {
      int32_t id;
      uint4 fq;
    };
    auto load_row = [&](Row& w, int i) {
      w.id = -1;
      w.fq = make_uint4(0u, 0u, 0u, 0u);
      if (i >= R) return;
      if (s < len_s[i]) w.id = a.ell[(b * R + i) * a.k_width + s];
      if (fp1_s[i] > fp0_s[i]) {
        int32_t c;
        float asc;
        fb_slot(fp0_s[i], c, asc);
        if (c >= 0) w.fq = row_io::load_quad(x_row(c) + col0, e_q, fcv, a.x_vec);
      }
    };

    row_io::cp_async_wait_all();
    __syncthreads();   // the window and the block's scalars are in shared memory
    Row cur, nxt;
    load_row(cur, team);
    for (int i = team; i < R; i += kTeams) {
      const int64_t r = b * R + i;
      if (r >= a.n) break;   // the same in the whole team
      load_row(nxt, i + kTeams);   // in flight while this row is summed
      const float adr = ad_s[i];
      const int len = len_s[i], fp0 = fp0_s[i], fp1 = fp1_s[i];
      // pass 1: the scores (kept for the first kKeep rounds) and their max
      int idx_k[kKeep];
      float e_k[kKeep];
      float mx = -INFINITY;
      auto band_slot = [&](int k0, int& idx, float& e) {
        const int32_t id = k0 == 0 ? cur.id : (k0 + s < len ? a.ell[r * a.k_width + k0 + s] : -1);
        idx = -1;
        e = -INFINITY;
        if (id >= 0 && base + id >= 0 && base + id < a.x_rows) {
          idx = row_io::window_index(id, R, b3);
          e = attn::lrelu(adr + as_s[idx], a.slope);
        }
      };
#pragma unroll
      for (int j = 0; j < kKeep; ++j) {
        idx_k[j] = -1;
        e_k[j] = -INFINITY;
        if (j * kT < len) band_slot(j * kT, idx_k[j], e_k[j]);
        mx = fmaxf(mx, e_k[j]);
      }
      for (int k0 = kKeep * kT; k0 < len; k0 += kT) {
        int idx;
        float e;
        band_slot(k0, idx, e);
        mx = fmaxf(mx, e);
      }
      // fallback slot e's source and score (-1 and -inf past the row)
      auto fb_score = [&](int e, int32_t& c, float& sc) {
        c = -1;
        sc = -INFINITY;
        if (e < fp1) {
          float asc;
          fb_slot(e, c, asc);
          if (c >= 0) sc = attn::lrelu(adr + asc, a.slope);
        }
      };
      int32_t fc0;
      float fe0;
      fb_score(fp0 + s, fc0, fe0);   // the first round, kept
      mx = fmaxf(mx, fe0);
      for (int e0 = fp0 + kT; e0 < fp1; e0 += kT) {
        int32_t c;
        float sc;
        fb_score(e0 + s, c, sc);
        mx = fmaxf(mx, sc);
      }
      mx = team_max<kT>(mx);
      const float m = mx == -INFINITY ? 0.0f : mx;

      // pass 2: the weights, their sum (every thread, in edge order) and
      // the weighted rows
      float acc[kE];
#pragma unroll
      for (int q = 0; q < kE; ++q) acc[q] = 0.0f;
      float ssum = 0.0f;
      auto band_round = [&](int k0, int idx, float e) {
        const float pw = idx >= 0 ? expf(e - m) : 0.0f;
        const int cnt = len - k0 < kT ? len - k0 : kT;
#pragma unroll
        for (int u = 0; u < kT; ++u) {
          if (u < cnt) {   // the same in the whole team
            const int iu = row_io::from_team<kT>(idx, u);
            const float pu = row_io::from_team<kT>(pw, u);
            if (iu >= 0) {
              ssum += pu;
              const float wu = kRound ? round_bf16(pu) : pu;
              float v[kE];
              row_io::unpack(win[iu * kNQ + s], v);
#pragma unroll
              for (int q = 0; q < kE; ++q) acc[q] = fmaf(wu, kRound ? round_bf16(v[q]) : v[q], acc[q]);
            }
          }
        }
      };
#pragma unroll
      for (int j = 0; j < kKeep; ++j)
        if (j * kT < len) band_round(j * kT, idx_k[j], e_k[j]);
      for (int k0 = kKeep * kT; k0 < len; k0 += kT) {
        int idx;
        float e;
        band_slot(k0, idx, e);
        band_round(k0, idx, e);
      }
      for (int e0 = fp0; e0 < fp1; e0 += kT) {
        int32_t c = fc0;
        float sc = fe0;
        if (e0 > fp0) fb_score(e0 + s, c, sc);
        const float pw = c >= 0 ? expf(sc - m) : 0.0f;
        const int cnt = fp1 - e0 < kT ? fp1 - e0 : kT;
        for (int u = 0; u < cnt; ++u) {   // the same in the whole team
          const int32_t cu = row_io::from_team<kT>(c, u);
          const float pu = row_io::from_team<kT>(pw, u);
          if (cu < 0) continue;
          ssum += pu;
          const uint4 q4 = e0 == fp0 && u == 0
                               ? cur.fq
                               : row_io::load_quad(x_row(cu) + col0, e_q, fcv, a.x_vec);
          float v[kE];
          row_io::unpack(q4, v);
#pragma unroll
          for (int q = 0; q < kE; ++q) acc[q] = fmaf(pu, v[q], acc[q]);
        }
      }
      const float denom = fmaxf(ssum, 1e-16f);
      float o[kE];
#pragma unroll
      for (int q = 0; q < kE; ++q) o[q] = acc[q] / denom;
      float* dst = a.out + r * hf + col0;
      if (a.out_vec && e_q + kE <= fcv) {
#pragma unroll
        for (int j = 0; j < kE; j += 4) row_io::store4(dst + e_q + j, o + j);
      } else {
#pragma unroll
        for (int q = 0; q < kE; ++q)
          if (e_q + q < fcv) dst[e_q + q] = o[q];
      }
      if (k == 0 && s == 0) {
        a.m[r * a.heads + h] = m;
        a.s[r * a.heads + h] = ssum;
      }
      cur = nxt;
    }
    __syncthreads();   // the window is read; the next tile may restage it
  }
}

template <typename TX, bool kRound, int kNQ, bool kParts>
int launch_nq(Args a, cudaStream_t stream) {
  constexpr int kE = Quad<TX>::kElems;
  const size_t smem = smem_bytes(a.R, kNQ);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  void (*kernel)(Args) = attn_fwd_kernel<TX, kRound, kNQ, kParts>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  a.n_chunks = (int)((a.f + kNQ * kE - 1) / (kNQ * kE));
  // persistent: as many CTAs as are resident at once
  const int64_t tiles = (a.n + a.R - 1) / a.R * a.heads * a.n_chunks;
  const int64_t resident = (int64_t)per_sm * sms;
  kernel<<<(unsigned)(tiles < resident ? tiles : resident), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// kNQ quads a window row: as few as cover one head's F (at least 4), at
// most 16, and fewer where the window would not fit (a larger R): a head
// wider than that runs in column chunks, each taking the softmax anew.
template <typename TX, bool kRound, bool kParts = false>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kE = Quad<TX>::kElems;
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t quads = (a.f + kE - 1) / kE;
  int nq = 16;
  while (nq > 4 && (nq / 2 >= quads || smem_bytes(a.R, nq) > (size_t)smem_max)) nq /= 2;
  if (smem_bytes(a.R, nq) > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  if (nq == 16) return launch_nq<TX, kRound, 16, kParts>(a, stream);
  if (nq == 8) return launch_nq<TX, kRound, 8, kParts>(a, stream);
  return launch_nq<TX, kRound, 4, kParts>(a, stream);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  x (x_rows, heads, f); alpha_src
// float32 (x_rows, heads); alpha_dst, m, s float32 (n, heads); ell int32
// (>= n rows, k_width); ell_len int32 (>= n) the slots of each row to read
// (entries past them are -1); fb_rowptr int64 (n + 1)
// over fb_src int32 (ids into x); out float32 (n, heads, f).  col_offset: 0
// for a whole graph (x_rows = n), block_rows for a shard's halo-extended x
// and alpha_src.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int slab_attn_fwd(const void* x, int x_dtype, const void* alpha_dst,
                             const void* alpha_src, int64_t n, int64_t col_offset,
                             int64_t x_rows, int64_t heads, int64_t f, const void* ell,
                             const void* ell_len, int64_t k_width, int64_t block_rows,
                             const void* fb_rowptr, const void* fb_src, float slope,
                             int round_bf16, void* out, void* m, void* s, void* stream) {
  Args a{x, static_cast<const float*>(alpha_dst), static_cast<const float*>(alpha_src), n,
         col_offset, x_rows, heads, f, static_cast<const int32_t*>(ell),
         static_cast<const int32_t*>(ell_len), k_width, (int)block_rows,
         static_cast<const int64_t*>(fb_rowptr), static_cast<const int32_t*>(fb_src), slope,
         static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(s), 1, false,
         false};
  const size_t xs = x_dtype == 0 ? 4 : 2;
  a.x_vec = (f * xs) % 16 == 0 && row_io::aligned(x, 16);
  a.out_vec = f % 4 == 0 && row_io::aligned(out, 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return round_bf16 ? launch<float, true>(a, st) : launch<float, false>(a, st);
  if (x_dtype == 1)
    return round_bf16 ? launch<__nv_bfloat16, true>(a, st) : launch<__nv_bfloat16, false>(a, st);
  return (int)cudaErrorInvalidValue;
}

// One row shard's whole attention forward over its table X_A = [x_prev | x |
// x_next | tail] (see attn::Parts): x (n, heads, f), x_prev and x_next
// (block_rows, heads, f) in x_dtype (0 = float32, 1 = bfloat16); the tail's
// tail_rows rows tail_stride bytes apart, each alpha_src's heads float32 at
// byte 0 and the row's heads * f elements of x_dtype at byte tail_off (both
// multiples of 16; tail null when empty); alpha_src float32 (n + 2 block_rows,
// heads) the halo-extended rows' (zeros past the graph's ends); alpha_dst,
// m, s float32 (n, heads); the band ELL as slab_attn_fwd's, its ids
// window-local to the halo-extended rows; fb_rowptr int64 (n + 1) over
// fb_src int32 ids into X_A (ops/dist_full_batch.py::plan_fallback_table);
// out float32 (n, heads, f).  float32 products (no bfloat16 rounding).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int slab_attn_fwd_shard(const void* x, const void* x_prev, const void* x_next,
                                   const void* tail, int64_t tail_rows, int64_t tail_stride,
                                   int64_t tail_off, int x_dtype, const void* alpha_dst,
                                   const void* alpha_src, int64_t n, int64_t heads, int64_t f,
                                   const void* ell, const void* ell_len, int64_t k_width,
                                   int64_t block_rows, const void* fb_rowptr,
                                   const void* fb_src, float slope, void* out, void* m,
                                   void* s, void* stream) {
  const int64_t r = block_rows;
  Args a{x, static_cast<const float*>(alpha_dst), static_cast<const float*>(alpha_src), n, r,
         n + 2 * r, heads, f, static_cast<const int32_t*>(ell),
         static_cast<const int32_t*>(ell_len), k_width, (int)block_rows,
         static_cast<const int64_t*>(fb_rowptr), static_cast<const int32_t*>(fb_src), slope,
         static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(s), 1, false,
         false, attn::Parts{x_prev, x, x_next, static_cast<const unsigned char*>(tail), r,
                            n + r, n + 2 * r, n + 2 * r + tail_rows, tail_stride, tail_off}};
  const size_t xs = x_dtype == 0 ? 4 : 2;
  a.x_vec = (f * xs) % 16 == 0 && attn::parts_aligned(a.xp, heads * f * xs, 16);
  a.out_vec = f % 4 == 0 && row_io::aligned(out, 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch<float, false, true>(a, st);
  if (x_dtype == 1) return launch<__nv_bfloat16, false, true>(a, st);
  return (int)cudaErrorInvalidValue;
}
