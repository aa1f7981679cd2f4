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
// Bound on the H100: bytes, and in practice latency.  A seed needs ~176 bytes
// (seed, two indptr entries, k uniforms, k index reads, the three outputs at
// k = 10), ~20 MB for the 112,640-seed second hop, ~6 us at 3.35 TB/s.  But the
// indptr and indices reads land at random addresses and each waits on the one
// before it (seed -> indptr -> indices), so the kernel is bound by how many
// such chains are in flight rather than by the byte rate.
//
// Design: one thread per seed, so every seed's chain runs independently and
// the card keeps ~10^5 of them in flight; no degree cap, so hub rows need no
// second path.  For k <= kRegK the taken positions stay in registers (the loops
// are fully unrolled); for larger k the duplicate check re-reads the part of
// the edge-id row this thread has already written.  The product u * (m + 1) is
// an explicit IEEE round-to-nearest multiply (__fmul_rn) and the file is built
// without --use_fast_math, so positions are bit-equal to the XLA version given
// the same uniforms.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegK = 16;

__device__ __forceinline__ int floyd_draw(float u, int m) {
  int t = (int)floorf(__fmul_rn(u, (float)(m + 1)));
  return min(max(t, 0), m);
}

template <bool kInRegisters>
__global__ void __launch_bounds__(kThreads)
uniform_sample_kernel(const int* __restrict__ indptr, int64_t n_nodes,
                      const int* __restrict__ indices, const int* __restrict__ seeds,
                      const float* __restrict__ u, int* __restrict__ neighbors,
                      int* __restrict__ edge_ids, int* __restrict__ num_sampled,
                      int64_t num_seeds, int k) {
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (s >= num_seeds) return;
  int* nb = neighbors + s * k;
  int* ei = edge_ids + s * k;
  const int seed = seeds[s];
  if (seed < 0) {
    for (int i = 0; i < k; ++i) { nb[i] = -1; ei[i] = -1; }
    num_sampled[s] = 0;
    return;
  }
  // ids past the last node read the end of indptr, as an XLA gather clamps
  const int64_t lo = seed < n_nodes ? seed : n_nodes;
  const int64_t hi = (int64_t)seed + 1 < n_nodes ? (int64_t)seed + 1 : n_nodes;
  const int start = indptr[lo];
  const int d = indptr[hi] - start;
  num_sampled[s] = min(d, k);
  if (d <= k) {
    for (int i = 0; i < k; ++i) {
      if (i < d) {
        ei[i] = start + i;
        nb[i] = __ldg(indices + start + i);
      } else {
        ei[i] = -1;
        nb[i] = -1;
      }
    }
    return;
  }
  const float* us = u + s * k;
  if constexpr (kInRegisters) {
    int sel[kRegK];
#pragma unroll
    for (int i = 0; i < kRegK; ++i) {
      if (i < k) {
        const int m = d - k + i;
        const int t = floyd_draw(us[i], m);
        bool dup = false;
#pragma unroll
        for (int j = 0; j < i; ++j) dup |= sel[j] == t;
        sel[i] = dup ? m : t;
      }
    }
#pragma unroll
    for (int i = 0; i < kRegK; ++i) {
      if (i < k) {
        const int e = start + sel[i];
        ei[i] = e;
        nb[i] = __ldg(indices + e);
      }
    }
  } else {
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
}

}  // namespace

// indptr (n_nodes + 1,), indices (E,), seeds (num_seeds,) int32; u (num_seeds, k)
// float32; outputs neighbors, edge_ids (num_seeds, k) and num_sampled
// (num_seeds,) int32.  Returns cudaGetLastError() after the launch.
extern "C" int uniform_sample(const void* indptr, int64_t n_nodes, const void* indices,
                              const void* seeds, const void* u, void* neighbors,
                              void* edge_ids, void* num_sampled, int64_t num_seeds,
                              int k, void* stream) {
  const unsigned blocks = (unsigned)((num_seeds + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const int* sd = static_cast<const int*>(seeds);
  const float* uu = static_cast<const float*>(u);
  int* nb = static_cast<int*>(neighbors);
  int* ei = static_cast<int*>(edge_ids);
  int* ns = static_cast<int*>(num_sampled);
  if (k <= kRegK) {
    uniform_sample_kernel<true><<<blocks, kThreads, 0, st>>>(
        ip, n_nodes, ix, sd, uu, nb, ei, ns, num_seeds, k);
  } else {
    uniform_sample_kernel<false><<<blocks, kThreads, 0, st>>>(
        ip, n_nodes, ix, sd, uu, nb, ei, ns, num_seeds, k);
  }
  return (int)cudaGetLastError();
}
