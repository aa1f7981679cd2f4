// Row gather with a fused dtype conversion: out[i] = convert(table[ids[i]]),
// a zero row where ids[i] < 0.  Ids at or past the last row read the last row,
// as an XLA gather clamps them.
//
// Replaces cugraph_gnn_tpu/ops/pallas/gather_kernel.py::gather_rows_tpu (one
// async DMA per row through a 32-deep slot pipeline on the TPU).
//
// Bound on the H100: bytes.  Per call the work is one read of each needed table
// row, one write of each output row and one read of the ids; there is no
// arithmetic to speak of.  At the sampled-training shape (123,904 ids into a
// 2,449,029 x 128 f32 table, bf16 out) that is ~95 MB, ~28 us at 3.35 TB/s.
//
// Design: one warp per output row.  Where F % 4 == 0 and both base pointers
// are aligned, each lane moves 4 elements at a time (16-byte f32 loads, 8-byte
// bf16 loads), so a 128-wide f32 row is one fully coalesced 512-byte warp
// read; otherwise every lane moves single elements.  Enough warps are resident
// (64 per SM) to keep several MB of row reads in flight, which is what a
// random-row gather needs to approach the memory rate.  The f32 -> bf16 cast
// uses __float2bfloat16_rn, round-to-nearest-even like Tensor.to(bfloat16), so
// the result is bit-equal to the plain PyTorch version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

using row_io::aligned;
using row_io::from_float;
using row_io::load4;
using row_io::store4;
using row_io::to_float;

template <typename TIn, typename TOut, typename TId>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const TIn* __restrict__ table, const TId* __restrict__ ids,
                   TOut* __restrict__ out, int64_t n_rows, int64_t f, int64_t b,
                   bool vec) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < b; row += stride) {
    const int64_t id = (int64_t)ids[row];
    TOut* dst = out + row * f;
    if (id < 0) {
      for (int64_t j = lane; j < f; j += 32) dst[j] = from_float<TOut>(0.0f);
      continue;
    }
    const TIn* src = table + (id < n_rows ? id : n_rows - 1) * f;
    if (vec) {
      float v[4];
      for (int64_t j = 4 * lane; j < f; j += 128) {
        load4(src + j, v);
        store4(dst + j, v);
      }
    } else {
      for (int64_t j = lane; j < f; j += 32) dst[j] = from_float<TOut>(to_float(src[j]));
    }
  }
}

template <typename TIn, typename TOut, typename TId>
int launch(const void* table, const void* ids, void* out, int64_t n_rows, int64_t f,
           int64_t b, cudaStream_t stream) {
  const bool vec = f % 4 == 0 && aligned(table, 4 * sizeof(TIn)) &&
                   aligned(out, 4 * sizeof(TOut));
  int64_t blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the row loop strides over the rest
  gather_rows_kernel<TIn, TOut, TId><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TIn*>(table), static_cast<const TId*>(ids),
      static_cast<TOut*>(out), n_rows, f, b, vec);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch_ids(int ids_dtype, const void* table, const void* ids, void* out,
               int64_t n_rows, int64_t f, int64_t b, cudaStream_t stream) {
  if (ids_dtype == 0) return launch<TIn, TOut, int32_t>(table, ids, out, n_rows, f, b, stream);
  if (ids_dtype == 1) return launch<TIn, TOut, int64_t>(table, ids, out, n_rows, f, b, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: table/out 0 = float32, 1 = bfloat16; ids 0 = int32, 1 = int64.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gather_rows(const void* table, int table_dtype, const void* ids,
                           int ids_dtype, void* out, int out_dtype, int64_t n_rows,
                           int64_t f, int64_t b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 0 && out_dtype == 0)
    return launch_ids<float, float>(ids_dtype, table, ids, out, n_rows, f, b, s);
  if (table_dtype == 0 && out_dtype == 1)
    return launch_ids<float, __nv_bfloat16>(ids_dtype, table, ids, out, n_rows, f, b, s);
  if (table_dtype == 1 && out_dtype == 0)
    return launch_ids<__nv_bfloat16, float>(ids_dtype, table, ids, out, n_rows, f, b, s);
  if (table_dtype == 1 && out_dtype == 1)
    return launch_ids<__nv_bfloat16, __nv_bfloat16>(ids_dtype, table, ids, out, n_rows, f, b, s);
  return (int)cudaErrorInvalidValue;
}
