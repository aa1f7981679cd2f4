"""Row gather with a fused dtype conversion: a CUDA kernel for Hopper.

Replaces ``cugraph_gnn_tpu/ops/pallas/gather_kernel.py::gather_rows_tpu``,
which starts one async DMA per row on the TPU.  Source:
``csrc/gather_rows.cu``, whose header says what bounds it on the H100 (bytes:
~95 MB, ~28 us at 3.35 TB/s at the training path's shape) and how its
warp-per-row, 16-byte-vector design meets that.  Unlike the Pallas kernel it
also converts (f32 table to bf16 rows in one pass), which the training path
asks for.

``gather_rows`` runs the kernel for CUDA tensors and the plain version,
``gather_rows_ref``, for CPU tensors; ``gather_rows.launches`` counts kernel
launches.  ``read_rows`` is the dispatch by dtype of the stores and caches:
the kernel for 2-D float32 and bfloat16 tables, plain indexing for others.
"""

from __future__ import annotations

import ctypes

import torch

from cugraph_gnn_tpu_torch import _build
from cugraph_gnn_tpu_torch.ops.gather import local_gather

_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ID_CODES = {torch.int32: 0, torch.int64: 1}
# table, table dtype, ids, ids dtype, out, out dtype, n_rows, f, b, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p]


def gather_rows_ref(table, ids, out_dtype=None):
    """Plain PyTorch version of :func:`gather_rows`."""
    return local_gather(table, ids, out_dtype=out_dtype)


def gather_rows(table, ids, out_dtype=None):
    """out[i] = table[ids[i]] as ``out_dtype`` (default: the table's), a zero
    row where ids[i] < 0.

    table: (N, F) float32 or bfloat16, contiguous.  ids: (B,) int32 or int64.
    Returns (B, F).  CUDA tensors launch the kernel on the current stream
    without synchronising; CPU tensors run :func:`gather_rows_ref`.
    """
    out_dtype = table.dtype if out_dtype is None else out_dtype
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"need a 2-D table and 1-D ids, got {tuple(table.shape)} "
                         f"and {tuple(ids.shape)}")
    if table.dtype not in _FLOAT_CODES or out_dtype not in _FLOAT_CODES:
        raise TypeError(f"table and out dtypes must be float32 or bfloat16, "
                        f"got {table.dtype} -> {out_dtype}")
    if ids.dtype not in _ID_CODES:
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device}, ids on {ids.device}")
    if table.shape[0] == 0:
        raise ValueError("gather from an empty table")
    if table.device.type == "cpu":
        return gather_rows_ref(table, ids, out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    n, f = table.shape
    b = ids.shape[0]
    out = torch.empty((b, f), dtype=out_dtype, device=table.device)
    if b == 0 or f == 0:
        return out
    fn = _build.function("gather_rows", _ARGTYPES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(table.data_ptr(), _FLOAT_CODES[table.dtype], ids.data_ptr(),
                    _ID_CODES[ids.dtype], out.data_ptr(),
                    _FLOAT_CODES[out_dtype], n, f, b, stream)
    _build.check(status, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0

KERNEL_DTYPES = tuple(_FLOAT_CODES)


def read_rows(table, ids):
    """table[ids] in the table's dtype, a zero row where ids[i] < 0 and the
    last row past the end: :func:`gather_rows` for a 2-D float32 or bfloat16
    table, plain indexing for any other (labels, integer columns, 3-D
    tables).  The choice is by dtype and shape, never a fallback on a
    failure."""
    if table.dim() == 2 and table.dtype in KERNEL_DTYPES:
        return gather_rows(table, ids)
    rows = table[ids.clamp(0, table.shape[0] - 1).long()]
    ok = (ids >= 0).view(ids.shape + (1,) * (rows.dim() - ids.dim()))
    return torch.where(ok, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
