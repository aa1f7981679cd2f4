// Fused one-hop uniform neighbor sampler without replacement: for each seed,
// Floyd's k-subset positions from the given uniforms, then the neighbor ids.
//
//   d = degree(seed), start = indptr[seed]
//   d <= k : positions 0..d-1, then -1
//   d >  k : for i in 0..k-1, m = d-k+i, t = clamp(floor(u[i]*(m+1)), 0, m),
//            take m if t was already taken, else t
//   edge_ids = start + pos, neighbors = indices[start + pos], num = min(d, k)
//   seed -1: -1 / -1 / 0
//
// Replaces cugraph_gnn_tpu/ops/pallas/sample_kernel.py::window_select_neighbors
// (the neighbor-id read: window DMA plus a one-hot select on the MXU, rows of
// degree <= 128 only) and fuses in cugraph_gnn_tpu/ops/sample.py::
// floyd_positions, which XLA ran as separate passes over the batch.
//
// What bounds it on the H100.  Counted at 4 bytes a read, as a byte bound
// counts, a seed at k = 10 moves ~176 bytes (seed, two indptr entries, k
// uniforms, k index reads, the three outputs): ~20 MB for the training path's
// 112,640-seed second hop, ~6 us at 3.35 TB/s.  That bound cannot be reached:
// the indptr and indices reads land at random addresses, and each moves a
// whole 32-byte sector.  Counted in sectors (32 bytes for each distinct
// indptr and indices sector the seeds touch, the coalesced parts at their
// bytes) the same hop needs ~50 MB, ~15 us; hop 0 (10,240 seeds) ~1 us.  And
// each seed's reads form a chain (seed -> indptr -> indices), so a call also
// pays a few memory latencies however little it moves.
//
// Design.  One group of k lanes per seed, 32 / k groups packed into each warp
// (k <= 32): lane i of a group owns draw i.  So a warp reads its seeds'
// uniforms and writes their (S, k) neighbor and edge-id rows as one
// contiguous span (4 * k * 32/k bytes, not 32 rows 4k bytes apart), the k
// index reads of a seed are independent loads issued together, and hop 0's
// 10,240 seeds make ~3,400 warps over all 132 SMs (one thread a seed made 40
// blocks).  Floyd's duplicate check runs in k steps: at step j lane j's draw
// is final (it depends on draws 0..j-1 only) and is broadcast to its group by
// __shfl_sync; lanes after it compare it with their own draw.  For k > 32
// one thread a seed walks the draws in turn, its duplicate check re-reading
// the edge-id row it has written.  The product u * (m + 1) is an explicit
// IEEE round-to-nearest multiply (__fmul_rn) and the file is built without
// --use_fast_math, so positions are bit-equal to the XLA version given the
// same uniforms.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;

__device__ __forceinline__ int floyd_draw(float u, int m) {
  int t = (int)floorf(__fmul_rn(u, (float)(m + 1)));
  return min(max(t, 0), m);
}

// indptr[seed] and the degree; ids past the last node read the end of
// indptr, as an XLA gather clamps them
__device__ __forceinline__ void row_of(const int* __restrict__ indptr, int64_t n_nodes,
                                       int seed, int& start, int& d) {
  const int64_t lo = seed < n_nodes ? seed : n_nodes;
  const int64_t hi = (int64_t)seed + 1 < n_nodes ? (int64_t)seed + 1 : n_nodes;
  start = __ldg(indptr + lo);
  d = __ldg(indptr + hi) - start;
}

// k <= 32: groups of k lanes, per_warp = 32 / k seeds a warp
__global__ void __launch_bounds__(kThreads)
uniform_sample_groups(const int* __restrict__ indptr, int64_t n_nodes,
                      const int* __restrict__ indices, const int* __restrict__ seeds,
                      const float* __restrict__ u, int* __restrict__ neighbors,
                      int* __restrict__ edge_ids, int* __restrict__ num_sampled,
                      int64_t num_seeds, int k, int per_warp) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kWarp;
  const int g = lane / k;
  const int i = lane - g * k;
  const int64_t s = warp * per_warp + g;
  const bool active = g < per_warp && s < num_seeds;
  const int64_t slot = s * k + i;
  int seed = -1;
  float draw = 0.f;
  if (active) {
    seed = __ldg(seeds + s);
    draw = __ldg(u + slot);
  }
  int start = 0, d = 0;
  if (seed >= 0) row_of(indptr, n_nodes, seed, start, d);
  const int m = d - k + i;
  const int t = floyd_draw(draw, m);
  // every lane of the warp takes part in the shuffles; a lane outside a
  // group reads lane 31 and discards the value
  const int base = g * k;
  bool dup = false;
  for (int j = 0; j < k; ++j) {
    const int taken = __shfl_sync(0xffffffffu, dup ? m : t, min(base + j, kWarp - 1));
    dup |= j < i && taken == t;
  }
  if (!active) return;
  const int pos = d > k ? (dup ? m : t) : (i < d ? i : -1);
  if (pos < 0) {
    edge_ids[slot] = -1;
    neighbors[slot] = -1;
  } else {
    const int e = start + pos;
    edge_ids[slot] = e;
    neighbors[slot] = __ldg(indices + e);
  }
  if (i == 0) num_sampled[s] = min(d, k);
}

// k > 32 (and k = 0): one thread a seed
__global__ void __launch_bounds__(kThreads)
uniform_sample_rows(const int* __restrict__ indptr, int64_t n_nodes,
                    const int* __restrict__ indices, const int* __restrict__ seeds,
                    const float* __restrict__ u, int* __restrict__ neighbors,
                    int* __restrict__ edge_ids, int* __restrict__ num_sampled,
                    int64_t num_seeds, int k) {
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (s >= num_seeds) return;
  int* nb = neighbors + s * k;
  int* ei = edge_ids + s * k;
  const int seed = seeds[s];
  int start = 0, d = 0;
  if (seed >= 0) row_of(indptr, n_nodes, seed, start, d);
  num_sampled[s] = min(d, k);
  if (d <= k) {
    for (int i = 0; i < k; ++i) {
      ei[i] = i < d ? start + i : -1;
      nb[i] = i < d ? __ldg(indices + start + i) : -1;
    }
    return;
  }
  const float* us = u + s * k;
  for (int i = 0; i < k; ++i) {
    const int m = d - k + i;
    const int t = start + floyd_draw(us[i], m);
    bool dup = false;
    for (int j = 0; j < i && !dup; ++j) dup = ei[j] == t;
    const int e = dup ? start + m : t;
    ei[i] = e;
    nb[i] = __ldg(indices + e);
  }
}

}  // namespace

// indptr (n_nodes + 1,), indices (E,), seeds (num_seeds,) int32; u (num_seeds, k)
// float32; outputs neighbors, edge_ids (num_seeds, k) and num_sampled
// (num_seeds,) int32.  Returns cudaGetLastError() after the launch.
extern "C" int uniform_sample(const void* indptr, int64_t n_nodes, const void* indices,
                              const void* seeds, const void* u, void* neighbors,
                              void* edge_ids, void* num_sampled, int64_t num_seeds,
                              int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const int* sd = static_cast<const int*>(seeds);
  const float* uu = static_cast<const float*>(u);
  int* nb = static_cast<int*>(neighbors);
  int* ei = static_cast<int*>(edge_ids);
  int* ns = static_cast<int*>(num_sampled);
  if (k >= 1 && k <= kWarp) {
    const int per_warp = kWarp / k;
    const int64_t warps = (num_seeds + per_warp - 1) / per_warp;
    const unsigned blocks = (unsigned)((warps * kWarp + kThreads - 1) / kThreads);
    uniform_sample_groups<<<blocks, kThreads, 0, st>>>(
        ip, n_nodes, ix, sd, uu, nb, ei, ns, num_seeds, k, per_warp);
  } else {
    const unsigned blocks = (unsigned)((num_seeds + kThreads - 1) / kThreads);
    uniform_sample_rows<<<blocks, kThreads, 0, st>>>(
        ip, n_nodes, ix, sd, uu, nb, ei, ns, num_seeds, k);
  }
  return (int)cudaGetLastError();
}
