"""Slab SpMM: aggregation over a banded graph, a CUDA kernel for Hopper.

Counterpart of ``cugraph_gnn_tpu/ops/pallas/slab_kernel.py`` (``SlabGraph``,
``build_slab_graph``, ``slab_spmm``).  A graph in a locality order (RCM, or
banded by construction) is split on the host into a banded ELL, whose row r
lists neighbors in the 3R-row window ``[(r//R)*R - R, (r//R)*R + 2R)``, and a
fallback COO of the out-of-band, duplicate and past-``max_k`` edges.  The
host arrays equal the JAX package's.

``slab_spmm`` computes the whole function in one launch of
``csrc/slab_spmm.cu`` (replacing the Pallas slab kernels and the XLA passes
after them; its header says what bounds it on the H100 and how its
shared-memory window design meets that): the band, the fallback edges
(where the JAX package uses XLA's ``segment_spmm``), the 'mean' divide and
the cast to x's dtype.  It runs ``slab_spmm_ref`` for CPU tensors and counts
``slab_spmm.launches``.  ``slab_spmm_shard`` launches the same function on
one row shard of a graph (``ops/dist_full_batch.py``): its rows read a table
X of the previous rank's last R rows, its own rows, the next rank's first R
rows and the remote rows its fallback edges need, passed as four tensors
and read in place; it counts ``slab_spmm_shard.launches``.
``slab_spmm_band`` launches the same source's band-only mode (float32
output, no fallback, no divide; one warp a row, the faster design for that
function), runs ``slab_spmm_band_ref`` for CPU tensors, and counts
``slab_spmm_band.launches``.  ``slab_spmm_band_shard`` launches the
band-only mode on one row shard, whose x carries one R-row halo on each
side (the sharded graph's balanced fallback plan), and counts its own
launches.

Unlike the JAX package, a bfloat16 result is rounded once, after the band,
the fallback and the divide are summed in float32 (the JAX bit-plane path
rounds the band to bfloat16 first).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch import _build
from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import (
    PaddedCSR,
    csr_spmm_ref,
    padded_from_coo,
)

_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# x, x dtype, n, col_offset, x_rows, ell, ell_w, ell_len, k_width,
# block_rows, round_bf16, fb_rowptr, fb_src, fb_w, degrees, out, out dtype,
# f, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
# x, x_prev, x_next, x_tail, x dtype, n, tail_rows, ell, ell_w, ell_len,
# k_width, block_rows, round_bf16, fb_rowptr, fb_src, fb_w, degrees, out, f,
# stream
_SHARD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64] + [
    ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int] + [
    ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p]
_FB_TILE = 128   # fallback COO padding, as in the JAX package


class SlabGraph(NamedTuple):
    """Banded-ELL + fallback-COO split of a CSR graph (device tensors).

    ell:        (n_blocks * R, K) int32 window-local neighbor ids in [0, 3R),
                -1 padded.  Row i of block b is global row b*R + i; id j
                means global column b*R - R + j.
    ell_w:      optional (n_blocks * R, K) float32 edge weights.
    fb_src/fb_dst/fb_w: the other edges as COO (global ids, sorted by
                destination, -1 padded to a multiple of 128); fb_w None when
                the graph is unweighted.
    degrees:    (num_rows,) int32 total degree (band + fallback) for 'mean'.
    fb_rowptr:  (num_rows + 1,) int64 row pointer over fb_dst, built on the
                host, for the CSR SpMM kernel.
    ell_len:    (n_blocks * R,) int32 ``ell_lengths(ell)``: the ELL slots
                the fused SpMM and attention kernels read in each row (its
                last valid slot + 1: the ELL keeps holes where parallel
                edges were dropped).  Take another ELL with :meth:`with_ell`,
                which rebuilds it.
    ell_bits:   the JAX package's bit-plane adjacency ((n_blocks * R, 128)
                int8; column c at byte c % 128, bit c // 128), or None when
                3R > 1024.  A host numpy array: the port's kernel reads the
                ELL, so the planes never go to the device.
    """

    ell: torch.Tensor
    ell_w: Optional[torch.Tensor]
    fb_src: torch.Tensor
    fb_dst: torch.Tensor
    fb_w: Optional[torch.Tensor]
    degrees: torch.Tensor
    num_rows: int
    block_rows: int
    n_blocks: int
    fb_rowptr: torch.Tensor
    ell_len: torch.Tensor
    ell_bits: Optional[np.ndarray] = None

    @property
    def band_fraction(self) -> float:
        """Fraction of edges served by the band kernel."""
        e_fb = int((self.fb_src >= 0).sum())
        e_all = int(self.degrees.sum())
        return 1.0 - e_fb / max(e_all, 1)

    @property
    def fallback(self) -> PaddedCSR:
        """The fallback COO as the CSR SpMM kernel's input."""
        return PaddedCSR(self.fb_src, self.fb_dst, self.fb_src.shape[0] // _FB_TILE,
                         self.num_rows, self.fb_rowptr, self.fb_w)

    def with_ell(self, ell: torch.Tensor, ell_w: Optional[torch.Tensor] = None) -> "SlabGraph":
        """The same graph with another ELL (and its weights, or none)."""
        return self._replace(ell=ell, ell_w=ell_w, ell_len=ell_lengths(ell))

    def to(self, device) -> "SlabGraph":
        """The same graph with its tensors on ``device``."""
        return self._replace(**{
            k: v.to(device) for k, v in self._asdict().items()
            if isinstance(v, torch.Tensor)})


def build_slab_graph(indptr, indices, weights=None, *, block_rows: int = 256,
                     max_k: int = 64, device=None) -> SlabGraph:
    """Split a CSR into the banded ELL (|col - row| <= block_rows, up to
    max_k per row, the first of parallel edges only) and the fallback COO.
    One-time host preprocessing; the tensors go to ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int32)
    n = len(indptr) - 1
    r_blk = int(block_rows)
    n_blocks = max(-(-n // r_blk), 1)
    n_pad = n_blocks * r_blk
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = indices.astype(np.int64)
    valid = (cols >= 0) & (cols < n)
    inband = valid & (np.abs(cols - rows) <= r_blk)
    # rank of each in-band edge within its row (CSR edge order), 1-based
    cs = np.cumsum(inband.astype(np.int64))
    cs0 = np.concatenate([[0], cs])
    rank = cs0[1:] - cs0[indptr[rows]]
    keep = inband & (rank <= max_k)
    # only the first instance of a parallel (r, c) edge stays in the band;
    # the others ride the fallback, so degrees still count them
    keep &= _first_occurrence_mask(rows, cols, keep, n)
    k_eff = int(rank[keep].max()) if keep.any() else 1
    k_eff = max(-(-k_eff // 8) * 8, 8)

    ell = np.full((n_pad, k_eff), -1, np.int32)
    blk = rows[keep] // r_blk
    slab_local = (cols[keep] - blk * r_blk + r_blk).astype(np.int32)
    ell[rows[keep], rank[keep] - 1] = slab_local
    ell_bits = _pack_bits(rows[keep], slab_local, n_pad, r_blk)
    ell_w = None
    if weights is not None:
        weights = np.asarray(weights, np.float32)
        ell_w = np.zeros((n_pad, k_eff), np.float32)
        ell_w[rows[keep], rank[keep] - 1] = weights[keep]

    fb = valid & ~keep
    pad = (-int(fb.sum())) % _FB_TILE
    fb_src = np.concatenate([cols[fb].astype(np.int32), np.full(pad, -1, np.int32)])
    fb_dst = np.concatenate([rows[fb].astype(np.int32), np.full(pad, -1, np.int32)])
    fb_w = None
    if weights is not None:
        fb_w = np.concatenate([weights[fb], np.zeros(pad, np.float32)])
    fallback = padded_from_coo(fb_src, fb_dst, n, fb_w, edge_tile=_FB_TILE,
                               device=dev)

    def t(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    return SlabGraph(
        ell=t(ell), ell_w=t(ell_w), fb_src=fallback.cols, fb_dst=fallback.rows,
        fb_w=fallback.weights,
        degrees=t(np.bincount(rows[valid], minlength=n).astype(np.int32)),
        num_rows=n, block_rows=r_blk, n_blocks=n_blocks,
        fb_rowptr=fallback.rowptr, ell_bits=ell_bits, ell_len=ell_lengths(t(ell)))


def ell_lengths(ell: torch.Tensor) -> torch.Tensor:
    """(rows,) int32 on ``ell``'s device: each ELL row's last valid slot + 1
    (0 for none), the ``SlabGraph.ell_len`` of every constructor."""
    if ell.shape[1] == 0:
        return torch.zeros(ell.shape[0], dtype=torch.int32, device=ell.device)
    slot = torch.arange(1, ell.shape[1] + 1, dtype=torch.int32, device=ell.device)
    return torch.where(ell >= 0, slot, 0).amax(1).to(torch.int32)


def _first_occurrence_mask(rows, cols, keep, n):
    """True at the first instance of each kept (row, col) pair."""
    first = np.ones(len(rows), bool)
    idx = np.nonzero(keep)[0]
    if len(idx):
        key = rows[idx] * np.int64(n) + cols[idx]
        order = np.argsort(key, kind="stable")
        dup = np.zeros(len(idx), bool)
        dup[order[1:]] = key[order[1:]] == key[order[:-1]]
        first[idx[dup]] = False
    return first


def _pack_bits(kept_rows, slab_local, n_pad, r_blk):
    """Bit-plane packing of the in-band adjacency: window column c -> byte
    c % 128, bit c // 128.  None when 3R exceeds the 8-plane capacity."""
    if 3 * r_blk > 1024:
        return None
    bits = np.zeros((n_pad, 128), np.uint8)
    c = slab_local.astype(np.int64)
    np.bitwise_or.at(bits, (kept_rows, c % 128), (1 << (c // 128)).astype(np.uint8))
    return bits.view(np.int8)


def _check(graph: SlabGraph, x, compute_dtype, col_offset: int) -> None:
    if x.dim() != 2 or x.dtype not in _FLOAT_CODES:
        raise TypeError(f"x must be 2-D float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if x.shape[0] != graph.num_rows + 2 * col_offset:
        raise ValueError(f"x has {x.shape[0]} rows, the graph {graph.num_rows}"
                         + (f" plus a {col_offset}-row halo on each side"
                            if col_offset else ""))
    if compute_dtype not in _FLOAT_CODES:
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    if graph.ell.device != x.device:
        raise ValueError(f"graph on {graph.ell.device}, x on {x.device}")


def _band_ref(graph: SlabGraph, x, compute_dtype, col_offset: int):
    _check(graph, x, compute_dtype, col_offset)
    n = graph.num_rows
    x_rows, f = x.shape
    r_blk = graph.block_rows
    ell = graph.ell[:n].long()
    base = (torch.arange(n, device=x.device) // r_blk) * r_blk - r_blk + col_offset
    cols = base[:, None] + ell
    ok = (ell >= 0) & (cols >= 0) & (cols < x_rows)
    xs = x.to(compute_dtype).float()
    w = None
    if graph.ell_w is not None:
        w = graph.ell_w[:n].to(compute_dtype).float()
    out = torch.zeros((n, f), dtype=torch.float32, device=x.device)
    for k in range(ell.shape[1]):
        term = xs[cols[:, k].clamp(0, max(x_rows - 1, 0))]
        if w is not None:
            term = term * w[:, k:k + 1]
        out += torch.where(ok[:, k:k + 1], term, 0)
    return out


def _launch(graph: SlabGraph, x, compute_dtype, col_offset: int, reduce=None):
    """The kernel on the card (x already checked): the band only (``reduce``
    None: float32 output) or the whole function ('sum' / 'mean': the
    fallback edges, the divide, output in x's dtype).  No launch when there
    is nothing to compute."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = graph.num_rows
    x_rows, f = x.shape
    if x_rows >= 2**31 or graph.fb_src.shape[0] >= 2**31:
        raise ValueError(f"{x_rows} rows or {graph.fb_src.shape[0]} fallback slots do "
                         f"not fit int32 ids")
    out_dtype = torch.float32 if reduce is None else x.dtype
    out = torch.empty((n, f), dtype=out_dtype, device=x.device)
    if n == 0 or f == 0:
        return out
    fn = _build.function("slab_spmm", _ARGTYPES)
    fb = reduce is not None and graph.fb_src.shape[0] > 0

    def ptr(t, use=True):
        return t.data_ptr() if use and t is not None else None

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), _FLOAT_CODES[x.dtype], n, col_offset, x_rows,
                    graph.ell.data_ptr(), ptr(graph.ell_w), graph.ell_len.data_ptr(),
                    graph.ell.shape[1], graph.block_rows,
                    int(compute_dtype == torch.bfloat16), ptr(graph.fb_rowptr, fb),
                    ptr(graph.fb_src, fb), ptr(graph.fb_w, fb),
                    ptr(graph.degrees, reduce == "mean"), out.data_ptr(),
                    _FLOAT_CODES[out_dtype], f, stream)
    _build.check(status, "slab_spmm")
    return out


def slab_spmm_band_ref(graph: SlabGraph, x, compute_dtype=torch.bfloat16):
    """Plain PyTorch version of :func:`slab_spmm_band`."""
    return _band_ref(graph, x, compute_dtype, 0)


def slab_spmm_band(graph: SlabGraph, x, compute_dtype=torch.bfloat16):
    """Band part of the slab SpMM, float32 (N, F): out[r] = sum over row r's
    ELL entries of w * x[(r//R)*R - R + ell[r, k]], entries whose column
    falls outside [0, N) skipped.  With ``compute_dtype`` bfloat16, x and
    the weights are rounded to bfloat16 first (the JAX package's MXU
    operands); the sum is float32 either way.

    x: (N, F) float32 or bfloat16, contiguous, N = graph.num_rows.  CUDA
    tensors launch the kernel on the current stream without synchronising;
    CPU tensors run :func:`slab_spmm_band_ref`.
    """
    _check(graph, x, compute_dtype, 0)
    if x.device.type == "cpu":
        return _band_ref(graph, x, compute_dtype, 0)
    out = _launch(graph, x, compute_dtype, 0)
    if out.numel():
        slab_spmm_band.launches += 1
    return out


slab_spmm_band.launches = 0


def slab_spmm_band_shard_ref(graph: SlabGraph, x_ext, compute_dtype=torch.bfloat16):
    """Plain PyTorch version of :func:`slab_spmm_band_shard`."""
    return _band_ref(graph, x_ext, compute_dtype, graph.block_rows)


def slab_spmm_band_shard(graph: SlabGraph, x_ext, compute_dtype=torch.bfloat16):
    """Band part of one row shard's slab SpMM, float32 (rs, F).  ``graph``
    holds the shard's rs rows (its ELL rows, rs a multiple of R, the shard's
    first row a multiple of R); ``x_ext`` (rs + 2R, F) is the shard's x with
    the R rows before it and the R rows after it (zeros past the graph's
    ends), so local row r reads ``x_ext[(r//R)*R + ell[r, k]]``.  Otherwise as
    :func:`slab_spmm_band`; counts ``slab_spmm_band_shard.launches``."""
    _check(graph, x_ext, compute_dtype, graph.block_rows)
    if x_ext.device.type == "cpu":
        return _band_ref(graph, x_ext, compute_dtype, graph.block_rows)
    out = _launch(graph, x_ext, compute_dtype, graph.block_rows)
    if out.numel():
        slab_spmm_band_shard.launches += 1
    return out


slab_spmm_band_shard.launches = 0


def _check_reduce(reduce: str) -> None:
    if reduce not in ("sum", "mean"):
        raise ValueError(f"slab_spmm supports sum/mean, got {reduce!r}")


def slab_spmm_ref(graph: SlabGraph, x, reduce: str = "sum",
                  compute_dtype=torch.bfloat16):
    """Plain PyTorch version of :func:`slab_spmm`: the band, plus the
    fallback's float32 sum, divided, rounded once to x's dtype."""
    _check_reduce(reduce)
    out = slab_spmm_band_ref(graph, x, compute_dtype)
    if graph.fb_src.shape[0]:
        csr_spmm_ref(graph.fallback, x, out=out)
    if reduce == "mean":
        out.div_(graph.degrees.clamp(min=1)[:, None])
    return out.to(x.dtype)


def slab_spmm(graph: SlabGraph, x, reduce: str = "sum",
              compute_dtype=torch.bfloat16):
    """out[r] = reduce over CSR row r of w * x[cols]: the band edges, then
    the fallback edges, summed in float32, divided by max(degree, 1) for
    'mean', returned in x's dtype (rounded once).  reduce: 'sum' | 'mean'.
    x: (N, F) float32 or bfloat16, contiguous, on the graph's device; the
    fallback reads x as it is, only the band honours ``compute_dtype``, as
    in the JAX package.  CUDA tensors launch the kernel once on the current
    stream without synchronising; CPU tensors run :func:`slab_spmm_ref`."""
    _check_reduce(reduce)
    _check(graph, x, compute_dtype, 0)
    if x.device.type == "cpu":
        return slab_spmm_ref(graph, x, reduce, compute_dtype)
    out = _launch(graph, x, compute_dtype, 0, reduce)
    if out.numel():
        slab_spmm.launches += 1
    return out


slab_spmm.launches = 0


def _check_shard_parts(graph: SlabGraph, x, prev, nxt, tail) -> None:
    r_blk = graph.block_rows
    for name, t, rows in (("halo_prev", prev, r_blk), ("halo_next", nxt, r_blk),
                          ("tail", tail, None)):
        if (t.dim() != 2 or t.shape[1] != x.shape[1] or t.dtype != x.dtype
                or t.device != x.device or (rows is not None and t.shape[0] != rows)):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} does not "
                             f"match x {tuple(x.shape)} {x.dtype} and R = {r_blk}")


def _launch_shard(graph: SlabGraph, x, prev, nxt, tail, reduce, compute_dtype):
    """``csrc/slab_spmm_shard.cu`` on the card (inputs already checked):
    the four parts read in place, the output in x's dtype.  No launch when
    there is nothing to compute."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not all(t.is_contiguous() for t in (x, prev, nxt, tail)):
        raise ValueError("x and its table's parts must be contiguous")
    n, f = x.shape
    x_rows = n + prev.shape[0] + nxt.shape[0] + tail.shape[0]
    if x_rows >= 2**31 or graph.fb_src.shape[0] >= 2**31:
        raise ValueError(f"{x_rows} rows or {graph.fb_src.shape[0]} fallback slots do "
                         f"not fit int32 ids")
    out = torch.empty((n, f), dtype=x.dtype, device=x.device)
    if n == 0 or f == 0:
        return out
    fn = _build.function("slab_spmm_shard", _SHARD_ARGTYPES)
    fb = graph.fb_src.shape[0] > 0

    def ptr(t, use=True):
        return t.data_ptr() if use and t is not None and t.numel() else None

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), prev.data_ptr(), nxt.data_ptr(), ptr(tail),
                    _FLOAT_CODES[x.dtype], n, tail.shape[0], graph.ell.data_ptr(),
                    ptr(graph.ell_w), graph.ell_len.data_ptr(), graph.ell.shape[1],
                    graph.block_rows, int(compute_dtype == torch.bfloat16),
                    ptr(graph.fb_rowptr, fb), ptr(graph.fb_src, fb), ptr(graph.fb_w, fb),
                    ptr(graph.degrees, reduce == "mean"), out.data_ptr(), f, stream)
    _build.check(status, "slab_spmm_shard")
    return out


def slab_spmm_shard_ref(graph: SlabGraph, x, halo_prev, halo_next, tail, reduce: str = "sum",
                        compute_dtype=torch.bfloat16):
    """Plain PyTorch version of :func:`slab_spmm_shard`: builds X, sums the
    band and the fallback in float32, divides, rounds once to x's dtype."""
    _check_reduce(reduce)
    _check(graph, x, compute_dtype, 0)
    _check_shard_parts(graph, x, halo_prev, halo_next, tail)
    r_blk = graph.block_rows
    table = torch.cat([halo_prev, x, halo_next, tail])
    out = _band_ref(graph, table[:x.shape[0] + 2 * r_blk], compute_dtype, r_blk)
    if graph.fb_src.shape[0]:
        csr_spmm_ref(graph.fallback, table, out=out)
    if reduce == "mean":
        out.div_(graph.degrees.clamp(min=1)[:, None])
    return out.to(x.dtype)


def slab_spmm_shard(graph: SlabGraph, x, halo_prev, halo_next, tail, reduce: str = "sum",
                    compute_dtype=torch.bfloat16):
    """One row shard's whole slab SpMM, in x's dtype (rs, F): out[r] =
    reduce over local row r's band and fallback edges of w * X[.], where X =
    [halo_prev | x | halo_next | tail] is the shard's table: the previous
    rank's last R rows (R, F), this rank's rows x (rs, F), the next rank's
    first R rows (R, F; zeros past the graph's ends) and the U remote rows
    its fallback edges read (U, F).  ``graph`` holds the shard's rs rows: its
    ELL rows (row r reads ``X[(r//R)*R + ell[r, k]]``), its fallback edges as
    a CSR by local row into X (``fb_rowptr``, ``fb_src``, ``fb_w``) and its
    degrees for 'mean'.  The band honours ``compute_dtype``, the fallback
    reads X as it is, as in :func:`slab_spmm`.

    CUDA tensors launch the kernel once on the current stream without
    synchronising, reading the four parts in place; CPU tensors run
    :func:`slab_spmm_shard_ref`.  Counts ``slab_spmm_shard.launches``."""
    _check_reduce(reduce)
    _check(graph, x, compute_dtype, 0)
    _check_shard_parts(graph, x, halo_prev, halo_next, tail)
    if x.device.type == "cpu":
        return slab_spmm_shard_ref(graph, x, halo_prev, halo_next, tail, reduce, compute_dtype)
    out = _launch_shard(graph, x, halo_prev, halo_next, tail, reduce, compute_dtype)
    if out.numel():
        slab_spmm_shard.launches += 1
    return out


slab_spmm_shard.launches = 0
