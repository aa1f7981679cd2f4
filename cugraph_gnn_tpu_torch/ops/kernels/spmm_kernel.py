"""CSR SpMM over a destination-sorted, -1-padded COO: a CUDA kernel for Hopper.

Replaces ``cugraph_gnn_tpu/ops/pallas/spmm_kernel.py::csr_spmm_pallas``, which
walks ``build_padded_blocks`` edge tiles with one DMA per edge.  Source:
``csrc/csr_spmm.cu``, whose header says what bounds it on the H100 (bytes,
and the latency of random row reads) and how its warp-per-row design meets
that.  In the port it also serves the slab SpMM's fallback edges (the JAX
package sends those to XLA's ``segment_spmm``), accumulating into the band's
float32 sums.

``csr_spmm`` runs the kernel for CUDA tensors and the plain version,
``csr_spmm_ref``, for CPU tensors; ``csr_spmm.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch import _build
from cugraph_gnn_tpu_torch._device import resolve_device

_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# x, x dtype, n_x, cols, weights, rowptr, out, out dtype, n_rows, f,
# accumulate, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]


class PaddedCSR(NamedTuple):
    """Destination-sorted COO in fixed-size edge tiles, -1 padded.

    cols:     (n_blocks * edge_tile,) int32 source node per slot, -1 pad.
    rows:     same shape, destination row per slot, nondecreasing over the
              valid slots, which come first; -1 pad after them.
    n_blocks: number of edge tiles (the TPU kernel's grid).
    num_rows: number of destination rows.
    rowptr:   (num_rows + 1,) int64, built on the host: the slots of row r
              are [rowptr[r], rowptr[r+1]).  The kernel's row index.
    weights:  optional (n_slots,) float32 edge weights.
    """

    cols: torch.Tensor
    rows: torch.Tensor
    n_blocks: int
    num_rows: int
    rowptr: torch.Tensor
    weights: Optional[torch.Tensor] = None


def padded_from_coo(cols, rows, num_rows: int, weights=None, *,
                    edge_tile: int = 128, device=None) -> PaddedCSR:
    """A :class:`PaddedCSR` of host arrays already in its slot layout (valid
    slots first, sorted by destination row, then -1 pads; the length a
    multiple of ``edge_tile``), on ``device`` (default: the card).  Raises
    when the layout does not hold."""
    dev = resolve_device(device)
    cols = np.asarray(cols, np.int32)
    rows = np.asarray(rows, np.int32)
    if cols.shape != rows.shape or cols.ndim != 1 or len(cols) % edge_tile:
        raise ValueError(f"cols {cols.shape} and rows {rows.shape} must be one "
                         f"length, a multiple of {edge_tile}")
    nv = int((rows >= 0).sum())
    valid = rows[:nv]
    if (rows[nv:] >= 0).any() or (np.diff(valid) < 0).any() or (
            nv and valid[-1] >= num_rows):
        raise ValueError("rows must be nondecreasing ids below num_rows, "
                         "followed only by -1 pads")
    rowptr = np.searchsorted(valid, np.arange(num_rows + 1), side="left")
    w = None
    if weights is not None:
        w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
    return PaddedCSR(torch.as_tensor(cols, device=dev),
                     torch.as_tensor(rows, device=dev),
                     len(cols) // edge_tile, int(num_rows),
                     torch.as_tensor(rowptr.astype(np.int64), device=dev), w)


def build_padded_blocks(indptr, indices, edge_tile: int = 512, *,
                        weights=None, device=None) -> PaddedCSR:
    """Host-side: flatten a CSR into fixed-size edge tiles carrying their
    destination row ids, padded with -1 (the JAX package's arrays), plus the
    row pointer, on ``device`` (default: the card)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    n = len(indptr) - 1
    e = len(indices)
    rows = np.repeat(np.arange(n, dtype=np.int32),
                     (indptr[1:] - indptr[:-1]).astype(np.int64))
    pad = (-e) % edge_tile
    cols = np.concatenate([indices.astype(np.int32), np.full(pad, -1, np.int32)])
    rows = np.concatenate([rows, np.full(pad, -1, np.int32)])
    if weights is not None:
        weights = np.concatenate([np.asarray(weights, np.float32),
                                  np.zeros(pad, np.float32)])
    return padded_from_coo(cols, rows, n, weights, edge_tile=edge_tile,
                           device=device)


def csr_spmm_ref(padded: PaddedCSR, x, reduce: str = "sum", *, out=None):
    """Plain PyTorch version of :func:`csr_spmm`."""
    _check(padded, x, reduce, out)
    ok = (padded.cols >= 0) & (padded.cols < x.shape[0]) & (padded.rows >= 0)
    msgs = x[padded.cols[ok].long()].float()
    if padded.weights is not None:
        msgs = msgs * padded.weights[ok][:, None]
    acc = torch.zeros((padded.num_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device).index_add_(0, padded.rows[ok].long(), msgs)
    if out is None:
        return acc.to(x.dtype)
    out.copy_(out.float() + acc)
    return out


def csr_spmm(padded: PaddedCSR, x, reduce: str = "sum", *, out=None):
    """out[r] = sum over the slots e with rows[e] == r of w[e] * x[cols[e]]
    (w = 1 without weights); slots whose column is outside [0, N) are
    skipped.  ``reduce`` is 'sum' only, as in the JAX package.

    x: (N, F) float32 or bfloat16, contiguous; summed in float32.  Without
    ``out``, returns a new (num_rows, F) tensor in x's dtype.  With ``out``
    ((num_rows, F) float32 or bfloat16, contiguous, not sharing x's
    storage), adds the sums into it in place, rounding once per row, and
    returns it.  CUDA tensors launch the kernel on the current stream without
    synchronising; CPU tensors run :func:`csr_spmm_ref`.
    """
    _check(padded, x, reduce, out)
    if x.device.type == "cpu":
        return csr_spmm_ref(padded, x, reduce, out=out)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n_rows, f = padded.num_rows, x.shape[1]
    accumulate = out is not None
    if out is None:
        out = torch.empty((n_rows, f), dtype=x.dtype, device=x.device)
    if n_rows == 0 or f == 0:
        return out
    fn = _build.function("csr_spmm", _ARGTYPES)
    w = padded.weights
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), _FLOAT_CODES[x.dtype], x.shape[0],
                    padded.cols.data_ptr(), None if w is None else w.data_ptr(),
                    padded.rowptr.data_ptr(), out.data_ptr(),
                    _FLOAT_CODES[out.dtype], n_rows, f, int(accumulate), stream)
    _build.check(status, "csr_spmm")
    csr_spmm.launches += 1
    return out


csr_spmm.launches = 0


def _check(padded: PaddedCSR, x, reduce, out) -> None:
    if reduce != "sum":
        raise ValueError(f"csr_spmm supports reduce='sum' only, got {reduce!r}")
    if x.dim() != 2 or x.dtype not in _FLOAT_CODES:
        raise TypeError(f"x must be 2-D float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    arrays = [padded.cols, padded.rows, padded.rowptr]
    if padded.weights is not None:
        arrays.append(padded.weights)
    if any(a.device != x.device for a in arrays):
        raise ValueError(f"the PaddedCSR and x must be on one device ({x.device})")
    if (padded.cols.dtype != torch.int32 or padded.rowptr.dtype != torch.int64
            or tuple(padded.rowptr.shape) != (padded.num_rows + 1,)):
        raise TypeError("PaddedCSR needs int32 cols and an int64 rowptr of "
                        "num_rows + 1 entries")
    if padded.weights is not None and padded.weights.dtype != torch.float32:
        raise TypeError("PaddedCSR weights must be float32")
    if out is not None:
        if (out.device != x.device or out.dtype not in _FLOAT_CODES
                or tuple(out.shape) != (padded.num_rows, x.shape[1])
                or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous float32 or bfloat16 "
                             f"({padded.num_rows}, {x.shape[1]}) tensor on "
                             f"{x.device}")
        if out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
            raise ValueError("out must not share x's storage")
