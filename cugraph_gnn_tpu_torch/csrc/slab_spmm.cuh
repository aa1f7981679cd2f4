// The slab SpMM's shared-memory window kernel, shared by slab_spmm.cu (a
// whole graph's rows) and slab_spmm_shard.cu (a row shard's rows over its
// table in parts, the kParts instances).  For every row r < n it computes
//   out[r] = (sum_k w[r,k] X[(r / R) * R - R + col_offset + ell[r,k]]
//             + sum_e fb_w[e] X[fb_src[e]]) / max(degree[r], 1)
// over the row's ELL entries (ids >= 0 whose X row lies in the rows the band
// may read) and its fallback slots e in [fb_rowptr[r], fb_rowptr[r + 1])
// (ids into [0, x_rows)), the divide for 'mean' only, rounded once to the
// output type; w = 1 for an unweighted graph.  X is x (x_rows rows), or a
// row shard's table in parts (XParts): [prev | x | next | tail].  The band
// is summed in ELL order, then the fallback in CSR order, then divided and
// rounded once.
//
// Design:
// - The window in shared memory.  Every band edge of row block b has its
//   source in the 3R-row window [(b-1)R, (b+2)R), so a tile is one column
//   chunk of one row block, and the window's rows of that chunk sit in a
//   ring of three R-row slots of shared memory, in x's own type (16 quads
//   of 16 bytes a row at R = 256: 128 bfloat16 or 64 float32 columns, 196 KB;
//   fewer quads for narrow rows or a larger R), filled by cp.async (4-byte
//   copies for float32 rows that are not 16-byte aligned, plain loads for
//   such bfloat16 rows).  Each part of a shard's X is a whole number of
//   R-row blocks, so each slot is staged from the one part that holds it.
//   One 1024-thread CTA a multiprocessor walks a contiguous run of tiles,
//   so moving from block b to b + 1 stages one new slot and x crosses
//   device memory about once per chunk.
// - A team of kNQ threads owns a row, each thread one quad of the chunk: a
//   team reads a window row as one contiguous run of shared memory (no bank
//   conflicts).  Team thread s loads ELL slots s, s + kNQ, ... up to the
//   row's length (the last valid slot + 1, built with the graph: the ELL keeps
//   holes where parallel edges were dropped, and the transposed graph's ELL,
//   64 wide for its two hub rows, is ~80% padding); the team shares the
//   window rows by shuffles.  32-bit window indexing.
// - The block's row scalars (ELL length, fallback range, degree) and then
//   its fallback slots (source ids, weights; up to 1024) are loaded into
//   shared memory while the window arrives, so no team waits on a chain of
//   dependent loads.  The fallback edges follow in the same team, their rows
//   read from global memory; the next row's ELL slots and first fallback
//   row are in flight while the current row is summed.  A row with more than 64 fallback slots (the transposed
//   banded graph's nodes 0 and N - 1 have ~750) is taken by the whole CTA
//   after the block, each team a contiguous share, the shares added by a
//   fixed shuffle tree and then warp by warp, and added to the band's sum.
// - No atomics: every sum has a fixed order, so two launches agree bit for
//   bit.
// - A row shard's remote tail is read by its fallback slots only; its band
//   reads stay within the halo-extended rows [0, band_rows).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_io.cuh"

namespace {

using row_io::Quad;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLongFb = 64;   // rows with more fallback slots: the whole CTA
constexpr int kFbUnroll = 2;  // fallback source rows in flight a thread
constexpr int kFbStage = 1024;   // a block's fallback slots staged in shared memory

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Args {
  const void* x;
  int64_t n, col_offset, x_rows;
  const int32_t* ell;
  const float* ell_w;         // null: unweighted
  const int32_t* ell_len;     // the slots of each row to read (the window kernel)
  int64_t k_width;
  int R;
  const int64_t* fb_rowptr;   // null: the band only
  const int32_t* fb_src;
  const float* fb_w;          // null: unweighted
  const int32_t* deg;         // null: no divide
  void* out;
  int64_t f;
  int n_chunks;
  bool x_vec, out_vec;        // 16-byte aligned rows of x; of out
};

// A row shard's table X, x_rows rows, when it comes in parts (the window
// kernel's kParts instances; Args::x holds rows [lo, hi)).
struct XParts {
  const void* prev;           // X rows [0, lo)
  const void* next;           // X rows [hi, band)
  const void* tail;           // X rows [band, x_rows)
  int64_t lo, hi, band;
};

// Row q of a table in parts (0 <= q < x_rows).
template <typename TX>
__device__ __forceinline__ const TX* part_row(const Args& a, const XParts& p, int64_t q) {
  const void* base = q < p.lo ? p.prev : q < p.hi ? a.x : q < p.band ? p.next : p.tail;
  const int64_t q0 = q < p.lo ? 0 : q < p.hi ? p.lo : q < p.band ? p.hi : p.band;
  return static_cast<const TX*>(base) + (q - q0) * a.f;
}

// Shared memory: the window ([3R][kNQ] quads), the per-warp shares of a long
// row ([kWarps][kNQ * kE] float32), four 4-byte scalars a row and two a
// staged fallback slot.
inline size_t smem_bytes(int R, int nq, int elems) {
  return (size_t)3 * R * nq * 16 + (size_t)kWarps * nq * elems * 4 + (size_t)4 * R * 4 +
         (size_t)2 * kFbStage * 4;
}

// acc += w * v (kWeighted) or acc += v for the kE elements of a quad, each
// rounded to bfloat16 first where kRound.
template <typename TX, bool kWeighted, bool kRound>
__device__ __forceinline__ void add_quad(float (&acc)[Quad<TX>::kElems], const uint4& q, float w) {
  constexpr int kE = Quad<TX>::kElems;
  float v[kE];
  row_io::unpack(q, v);
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const float xv = kRound ? round_bf16(v[i]) : v[i];
    acc[i] = kWeighted ? fmaf(w, xv, acc[i]) : acc[i] + xv;
  }
}

// Elements [e, e + kE) of an output row (only those below fcv).
template <typename TO, int kE>
__device__ __forceinline__ void store_elems(TO* p, const float (&v)[kE], int e, int fcv, bool vec) {
  if (vec && e + kE <= fcv) {
#pragma unroll
    for (int j = 0; j < kE; j += 4) row_io::store4(p + e + j, v + j);
  } else {
#pragma unroll
    for (int i = 0; i < kE; ++i)
      if (e + i < fcv) p[e + i] = row_io::from_float<TO>(v[i]);
  }
}

template <typename TX, typename TO, bool kWeighted, bool kRound, int kNQ, bool kParts>
__global__ void __launch_bounds__(kThreads, 1) slab_spmm_kernel(Args a, XParts xp) {
  constexpr int kE = Quad<TX>::kElems;       // elements a quad
  constexpr int kT = kNQ;                    // threads a row, one quad each
  constexpr int kTeams = kThreads / kT;      // rows at once
  constexpr int kFC = kNQ * kE;              // elements a chunk
  constexpr bool kRoundX = kRound && sizeof(TX) == 4;
  extern __shared__ __align__(16) uint4 smem[];
  const int R = a.R;
  uint4* win = smem;
  float* red = reinterpret_cast<float*>(win + 3 * R * kNQ);
  // the block's rows (ELL length, fallback range, degree) and its first
  // kFbStage fallback slots (source, weight)
  int* len_s = reinterpret_cast<int*>(red + kWarps * kFC);
  int* fp0_s = len_s + R;
  int* fp1_s = fp0_s + R;
  int* deg_s = fp1_s + R;
  int32_t* fbc_s = deg_s + R;
  float* fbw_s = reinterpret_cast<float*>(fbc_s + kFbStage);
  const TX* x = static_cast<const TX*>(a.x);
  TO* out = static_cast<TO*>(a.out);
  const int s = threadIdx.x % kT, team = threadIdx.x / kT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool has_fb = a.fb_rowptr != nullptr;
  const bool fb_weighted = kWeighted && a.fb_w != nullptr;
  const int64_t n_blocks = (a.n + R - 1) / R;
  const int64_t tiles = n_blocks * a.n_chunks;
  const int64_t p0 = tiles * blockIdx.x / gridDim.x, p1 = tiles * (blockIdx.x + 1) / gridDim.x;
  int64_t tag[3] = {-1, -1, -1};   // what each slot holds: chunk * (n_blocks + 2) + lb
  for (int64_t p = p0; p < p1; ++p) {
    const int64_t k = p / n_blocks, b = p % n_blocks;
    const int64_t col0 = k * kFC;
    const int fcv = (int)(a.f - col0 < kFC ? a.f - col0 : kFC);
    const int b3 = (int)(b % 3);
    const int base = (int)((b - 1) * R + a.col_offset);   // input row of window id 0
    const int e_q = s * kE;                                 // this thread's first element
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int64_t lb = b + i;
      const int slot = (int)(lb % 3);
      const int64_t want = k * (n_blocks + 2) + lb;
      if (tag[slot] == want) continue;   // the same in every thread
      if constexpr (kParts) {
        // X rows [q0, q0 + R), from the part that holds them
        const int64_t q0 = (lb - 1) * R + a.col_offset;
        const void* part = q0 < xp.lo ? xp.prev : q0 < xp.hi ? a.x : xp.next;
        const int64_t lo = q0 < xp.lo ? 0 : q0 < xp.hi ? xp.lo : xp.hi;
        const int64_t hi = q0 < xp.lo ? xp.lo : q0 < xp.hi ? xp.hi : xp.band;
        row_io::stage_rows<kNQ, kThreads, TX>(win, slot * R, static_cast<const TX*>(part),
                                               q0 - lo, R, hi - lo, a.f, col0, fcv, a.x_vec);
      } else {
        row_io::stage_rows<kNQ, kThreads, TX>(win, slot * R, x, (lb - 1) * R + a.col_offset, R,
                                               a.x_rows, a.f, col0, fcv, a.x_vec);
      }
      tag[slot] = want;
    }
    // the rows' scalars, then the block's fallback slots (ids, weights),
    // loaded while the window arrives
    const int64_t fb_end = has_fb ? a.fb_rowptr[a.n] : 0;
    for (int it = threadIdx.x; it < R; it += kThreads) {
      const int64_t r = b * R + it;
      int len = 0, deg = 1;
      int64_t fp0 = fb_end, fp1 = fb_end;
      if (r < a.n) {
        len = a.ell_len[r];
        if (has_fb) {
          fp0 = a.fb_rowptr[r];
          fp1 = a.fb_rowptr[r + 1];
        }
        if (a.deg != nullptr) deg = a.deg[r];
      }
      len_s[it] = len;
      fp0_s[it] = (int)fp0;
      fp1_s[it] = (int)fp1;
      deg_s[it] = deg;
    }
    __syncthreads();
    const int fpb = fp0_s[0];   // the block's first fallback slot
    {
      const int cnt = fp1_s[R - 1] - fpb < kFbStage ? fp1_s[R - 1] - fpb : kFbStage;
      for (int e = threadIdx.x; e < cnt; e += kThreads) {
        const int32_t c = a.fb_src[fpb + e];
        fbc_s[e] = c >= 0 && c < a.x_rows ? c : -1;
        if (fb_weighted) fbw_s[e] = a.fb_w[fpb + e];
      }
    }
    // fallback slot e's source (-1: none) and weight
    auto fb_slot = [&](int e, int32_t& c, float& w) {
      if (e - fpb < kFbStage) {
        c = fbc_s[e - fpb];
        w = fb_weighted ? fbw_s[e - fpb] : 1.0f;
      } else {
        c = a.fb_src[e];
        if (c >= a.x_rows) c = -1;
        w = fb_weighted ? a.fb_w[e] : 1.0f;
      }
    };

    // a row's first ELL slot (this thread's) and its first fallback row
    // (this thread's quad)
    struct Row {
      int32_t id;
      float w;
      uint4 fq;
    };
    auto load_row = [&](Row& w, int i) {
      w.id = -1;
      w.w = 1.0f;
      w.fq = make_uint4(0u, 0u, 0u, 0u);
      if (i >= R) return;
      const int64_t r = b * R + i;
      if (s < len_s[i]) {
        w.id = a.ell[r * a.k_width + s];
        if (kWeighted) w.w = a.ell_w[r * a.k_width + s];
      }
      const int fp0 = fp0_s[i], fp1 = fp1_s[i];
      if (fp1 > fp0 && fp1 - fp0 <= kLongFb) {
        int32_t c;
        float fw;
        fb_slot(fp0, c, fw);
        if constexpr (kParts) {
          if (c >= 0) w.fq = row_io::load_quad(part_row<TX>(a, xp, c) + col0, e_q, fcv, a.x_vec);
        } else {
          if (c >= 0) w.fq = row_io::load_quad(x + (int64_t)c * a.f + col0, e_q, fcv, a.x_vec);
        }
      }
    };

    // the band: the row's ELL slots in order, rows from the window
    auto band_sum = [&](float (&acc)[kE], const Row& w, int64_t r, int len) {
#pragma unroll
      for (int q = 0; q < kE; ++q) acc[q] = 0.0f;
      for (int k0 = 0; k0 < len; k0 += kT) {
        int32_t id = w.id;
        float wt = w.w;
        if (k0 > 0) {
          id = -1;
          wt = 1.0f;
          if (k0 + s < len) {
            id = a.ell[r * a.k_width + k0 + s];
            if (kWeighted) wt = a.ell_w[r * a.k_width + k0 + s];
          }
        }
        int idx = -1;
        // a shard's band reads only its halo-extended rows
        if (id >= 0 && base + id >= 0 && base + id < (kParts ? xp.band : a.x_rows))
          idx = row_io::window_index(id, R, b3);
        if (kRound) wt = round_bf16(wt);
        const int cnt = len - k0 < kT ? len - k0 : kT;
#pragma unroll
        for (int u = 0; u < kT; ++u) {
          if (u < cnt) {   // the same in the whole team
            const int iu = row_io::from_team<kT>(idx, u);
            const float wu = kWeighted ? row_io::from_team<kT>(wt, u) : 1.0f;
            if (iu >= 0) add_quad<TX, kWeighted, kRoundX>(acc, win[iu * kNQ + s], wu);
          }
        }
      }
    };

    // fallback slots [e0, e1): rows from global memory, kFbUnroll at a time
    auto fb_range = [&](float (&fb)[kE], int e0, int e1) {
      for (int e = e0; e < e1; e += kFbUnroll) {
        int32_t c[kFbUnroll];
        float wt[kFbUnroll];
        uint4 q[kFbUnroll];
#pragma unroll
        for (int u = 0; u < kFbUnroll; ++u) {
          c[u] = -1;
          wt[u] = 1.0f;
          if (e + u < e1) fb_slot(e + u, c[u], wt[u]);
        }
#pragma unroll
        for (int u = 0; u < kFbUnroll; ++u)
          if constexpr (kParts) {
            if (c[u] >= 0)
              q[u] = row_io::load_quad(part_row<TX>(a, xp, c[u]) + col0, e_q, fcv, a.x_vec);
          } else {
            if (c[u] >= 0) q[u] = row_io::load_quad(x + (int64_t)c[u] * a.f + col0, e_q, fcv, a.x_vec);
          }
#pragma unroll
        for (int u = 0; u < kFbUnroll; ++u)
          if (c[u] >= 0) add_quad<TX, kWeighted, false>(fb, q[u], wt[u]);
      }
    };

    auto finish = [&](float (&acc)[kE], int64_t r, int deg) {
      if (a.deg != nullptr) {
        const float d = (float)(deg > 1 ? deg : 1);
#pragma unroll
        for (int q = 0; q < kE; ++q) acc[q] = acc[q] / d;
      }
      store_elems<TO, kE>(out + r * a.f + col0, acc, e_q, fcv, a.out_vec);
    };

    row_io::cp_async_wait_all();
    __syncthreads();   // the window and the block's scalars are in shared memory
    Row cur, nxt;
    load_row(cur, team);
    bool any_long = false;
    for (int i = team; i < R; i += kTeams) {
      const int64_t r = b * R + i;
      if (r >= a.n) break;   // the same in the whole team
      load_row(nxt, i + kTeams);   // in flight while this row is summed
      const int fp0 = fp0_s[i], fp1 = fp1_s[i];
      if (fp1 - fp0 > kLongFb) {
        any_long = true;
      } else {
        float acc[kE];
        band_sum(acc, cur, r, len_s[i]);
        if (fp1 > fp0) {
          int32_t c;
          float fw;
          fb_slot(fp0, c, fw);
          if (c >= 0) add_quad<TX, kWeighted, false>(acc, cur.fq, fw);
        }
        fb_range(acc, fp0 + 1, fp1);
        finish(acc, r, deg_s[i]);
      }
      cur = nxt;
    }
    // rows with many fallback slots: each team a contiguous share, the
    // shares added by a fixed tree, team 0 adds them to the band and writes
    // the row
    if (__syncthreads_or(any_long)) {
      for (int i = 0; i < R && b * R + i < a.n; ++i) {
        const int e0 = fp0_s[i], len = fp1_s[i] - e0;
        if (len <= kLongFb) continue;   // the same in every thread
        const int64_t r = b * R + i;
        float fb[kE];
#pragma unroll
        for (int q = 0; q < kE; ++q) fb[q] = 0.0f;
        fb_range(fb, e0 + (int)((int64_t)len * team / kTeams),
                 e0 + (int)((int64_t)len * (team + 1) / kTeams));
#pragma unroll
        for (int off = kT; off < 32; off <<= 1)
#pragma unroll
          for (int q = 0; q < kE; ++q) fb[q] += __shfl_xor_sync(0xffffffffu, fb[q], off);
        if (lane < kT) {
#pragma unroll
          for (int q = 0; q < kE; ++q) red[warp * kFC + e_q + q] = fb[q];
        }
        __syncthreads();
        if (team == 0) {
          Row w;
          load_row(w, i);
          float acc[kE];
          band_sum(acc, w, r, len_s[i]);
          for (int w2 = 0; w2 < kWarps; ++w2) {
#pragma unroll
            for (int q = 0; q < kE; ++q) acc[q] += red[w2 * kFC + e_q + q];
          }
          finish(acc, r, deg_s[i]);
        }
        __syncthreads();
      }
    }
    __syncthreads();   // the window is read; the next tile may restage it
  }
}

template <typename TX, typename TO, bool kW, bool kR, int kNQ, bool kParts>
int launch_nq(Args a, const XParts& xp, cudaStream_t stream) {
  constexpr int kE = Quad<TX>::kElems;
  const size_t smem = smem_bytes(a.R, kNQ, kE);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  void (*kernel)(Args, XParts) = slab_spmm_kernel<TX, TO, kW, kR, kNQ, kParts>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  a.n_chunks = (int)((a.f + kNQ * kE - 1) / (kNQ * kE));
  // persistent: as many CTAs as are resident at once
  const int64_t tiles = (a.n + a.R - 1) / a.R * a.n_chunks;
  const int64_t resident = (int64_t)per_sm * sms;
  kernel<<<(unsigned)(tiles < resident ? tiles : resident), kThreads, smem, stream>>>(a, xp);
  return (int)cudaGetLastError();
}

// kNQ quads a window row: as few as cover F (at least 4), at most 16, and
// fewer where the window would not fit in shared memory (a larger R).
template <typename TX, typename TO, bool kW, bool kR, bool kParts>
int launch(const Args& a, const XParts& xp, cudaStream_t stream) {
  constexpr int kE = Quad<TX>::kElems;
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t quads = (a.f + kE - 1) / kE;
  int nq = 16;
  while (nq > 4 && (nq / 2 >= quads || smem_bytes(a.R, nq, kE) > (size_t)smem_max)) nq /= 2;
  if (smem_bytes(a.R, nq, kE) > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  if (nq == 16) return launch_nq<TX, TO, kW, kR, 16, kParts>(a, xp, stream);
  if (nq == 8) return launch_nq<TX, TO, kW, kR, 8, kParts>(a, xp, stream);
  return launch_nq<TX, TO, kW, kR, 4, kParts>(a, xp, stream);
}

}  // namespace
