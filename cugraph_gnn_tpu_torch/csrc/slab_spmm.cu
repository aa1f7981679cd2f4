// Slab SpMM: for every row r < n of a banded graph, the whole function
//   out[r] = (sum_k w[r,k] x[(r / R) * R - R + col_offset + ell[r,k]]
//             + sum_e fb_w[e] x[fb_src[e]]) / max(degree[r], 1)
// over the row's ELL entries (ids >= 0 whose x row lies in [0, x_rows)) and
// its fallback slots e in [fb_rowptr[r], fb_rowptr[r + 1]), the divide for
// 'mean' only, rounded once to the output type.  w = 1 for an unweighted
// graph.  A whole graph passes col_offset 0 and x_rows n; a row shard its x
// with one R-row halo on each side (x_rows = n + 2R) and col_offset R, and no
// fallback (the band-only mode: float32 output, no divide; the sharded glue
// adds the fallback).  x is float32 or bfloat16; the output float32 or x's
// type; every sum is float32.  With round_bf16 (compute dtype bfloat16) the
// band's x elements and weights are rounded to bfloat16 before they are
// used, as the MXU's operands are in the JAX package; the fallback terms use
// x as it is.  The band is summed in ELL order, then the fallback in CSR
// order, then divided and rounded once (the plain version, slab_kernel.py,
// sums the fallback apart and adds it to the band: the same terms in another
// order).
//
// Replaces cugraph_gnn_tpu/ops/pallas/slab_kernel.py::slab_spmm (:267;
// pallas_call :333 over _slab_bits_kernel :198 and _slab_kernel :177, then
// the fallback segment sum, the 'mean' divide and the cast, :341-354) and,
// band only with the shard offset, the per-shard band kernel of
// cugraph_gnn_tpu/ops/dist_full_batch.py::_shard_spmm_body (:178;
// pallas_call :218).  The TPU kernel multiplies a 0/1 (R, 3R) block with the
// block's 3R-row window of x on the MXU, G blocks stacked in VMEM so that
// neighbouring windows share their rows; the rest of the function is XLA
// passes over (N, F).
//
// Bound on the H100: bytes.  A call must read the ELL's real entries, x once
// (the fallback's source rows are rows of x), the fallback row pointer and
// ids and the degrees ('mean'), and write the output once in its type: for
// the three calls of a GraphSAGE step at 2,449,029 nodes (bf16; graph F =
// 128, graph F = 256, transpose F = 256) ~6.7 GB, ~2.01 ms at 3.35 TB/s
// (chip_smoke.py counts each call's bytes).  The arithmetic is one FMA per
// edge and element, three orders below the card's rate.
//
// Design:
// - The window in shared memory.  Every band edge of row block b has its
//   source in the 3R-row window [(b-1)R, (b+2)R), so a tile is one column
//   chunk of one row block, and the window's rows of that chunk sit in a
//   ring of three R-row slots of shared memory, in x's own type (16 quads
//   of 16 bytes a row at R = 256: 128 bfloat16 or 64 float32 columns, 196 KB;
//   fewer quads for narrow rows or a larger R), filled by cp.async (4-byte
//   copies for float32 rows that are not 16-byte aligned, plain loads for
//   such bfloat16 rows).  One 1024-thread CTA a multiprocessor walks a
//   contiguous run of tiles, so moving from block b to b + 1 stages one new
//   slot and x crosses device memory about once per chunk.
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
// The band-only mode (float32 output, no fallback, no divide: slab_spmm_band
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

template <typename TX, typename TO, bool kWeighted, bool kRound, int kNQ>
__global__ void __launch_bounds__(kThreads, 1) slab_spmm_kernel(Args a) {
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
      row_io::stage_rows<kNQ, kThreads, TX>(win, slot * R, x, (lb - 1) * R + a.col_offset, R,
                                             a.x_rows, a.f, col0, fcv, a.x_vec);
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
        if (c >= 0) w.fq = row_io::load_quad(x + (int64_t)c * a.f + col0, e_q, fcv, a.x_vec);
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
        if (id >= 0 && base + id >= 0 && base + id < a.x_rows) idx = row_io::window_index(id, R, b3);
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
          if (c[u] >= 0) q[u] = row_io::load_quad(x + (int64_t)c[u] * a.f + col0, e_q, fcv, a.x_vec);
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

template <typename TX, typename TO, bool kW, bool kR, int kNQ>
int launch_nq(Args a, cudaStream_t stream) {
  constexpr int kE = Quad<TX>::kElems;
  const size_t smem = smem_bytes(a.R, kNQ, kE);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  void (*kernel)(Args) = slab_spmm_kernel<TX, TO, kW, kR, kNQ>;
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
  kernel<<<(unsigned)(tiles < resident ? tiles : resident), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// kNQ quads a window row: as few as cover F (at least 4), at most 16, and
// fewer where the window would not fit in shared memory (a larger R).
template <typename TX, typename TO, bool kW, bool kR>
int launch(const Args& a, cudaStream_t stream) {
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
  if (nq == 16) return launch_nq<TX, TO, kW, kR, 16>(a, stream);
  if (nq == 8) return launch_nq<TX, TO, kW, kR, 8>(a, stream);
  return launch_nq<TX, TO, kW, kR, 4>(a, stream);
}

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
  if (w) return round ? launch<TX, TO, true, true>(a, s) : launch<TX, TO, true, false>(a, s);
  return round ? launch<TX, TO, false, true>(a, s) : launch<TX, TO, false, false>(a, s);
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
