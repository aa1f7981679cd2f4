"""Fused slab attention forward (SDDMM + edge softmax + aggregate over a
banded graph): a CUDA kernel for Hopper.

Counterpart of ``cugraph_gnn_tpu/ops/pallas/slab_kernel.py``
(``slab_attention_spmm_mh``, ``slab_attention_spmm``).  Per destination row
r and head h, over every edge r <- c of a ``SlabGraph`` (the band ELL and the
fallback edges alike):

    e_rc   = leakyrelu(alpha_dst[r, h] + alpha_src[c, h])
    m, s   = max_c e_rc,  sum_c exp(e_rc - m)
    out[r] = sum_c exp(e_rc - m) x[c, h] / max(s, 1e-16)

``slab_attention_spmm_mh`` launches ``csrc/slab_attn_fwd.cu`` for CUDA
tensors (its header says what bounds it on the H100 and how its design, the
window of a row block in shared memory, meets that), runs ``slab_attention_spmm_mh_ref`` for CPU tensors, and counts
``slab_attention_spmm_mh.launches``.  The JAX package merges the fallback
edges into the band's softmax by a log-sum-exp outside its kernel; here the
kernel reads them through the graph's ``fb_rowptr`` and takes one softmax
over all of a row's edges.

``slab_attention_spmm_mh_shard`` and ``slab_attention_spmm_shard`` (H = 1)
compute one row shard's whole forward (``ops/dist_full_batch.py``) in one
launch of the same kernel's shard entry (``slab_attn_fwd_shard``): the band
and the fallback edges in one softmax over the shard's table A (a
:class:`ShardTable`: its own rows, the R rows before and after them, and the
remote rows its fallback edges read, packed with their alpha_src), read in
place; alpha_dst and the outputs cover the shard's rows.  Each counts its
own launches.

The stats differ from the JAX package's where a row lacks band or fallback
edges: its merged ``m`` is max(true max, 0) and its ``s`` is scaled to
match, while the port returns the true max.  Both give the same
``m + log(s)`` and the same ``exp(e - m) / s``, which is all that the output
and the backward use.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from cugraph_gnn_tpu_torch import _build
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import SlabGraph

_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEADS = 64   # the JAX kernel's packed-stats limit, kept as the port's
_FB_CHUNK = 1 << 20   # fallback edges per step of the plain version
# x, x dtype, alpha_dst, alpha_src, n, col_offset, x_rows, heads, f, ell,
# ell_len, k_width, block_rows, fb_rowptr, fb_src, negative_slope,
# round_bf16, out, m, s, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]


# x, x_prev, x_next, tail, tail rows, tail stride, tail offset, x dtype,
# alpha_dst, alpha_src, n, heads, f, ell, ell_len, k_width, block_rows,
# fb_rowptr, fb_src, negative_slope, out, m, s, stream (slab_attn_fwd_shard)
_SHARD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 4)


def lrelu(z, negative_slope: float):
    return torch.where(z >= 0, z, negative_slope * z)


class PackedRows(NamedTuple):
    """Rows of a shard table's tail, packed so that one exchange moves them:
    row i of ``data`` ((U, stride) uint8, stride a multiple of 16) holds
    ``head`` float32 values (a node's scalars) at byte 0 and ``body``
    elements of ``dtype`` at byte ``offset`` (a multiple of 16)."""

    data: torch.Tensor
    head: int
    body: int
    dtype: torch.dtype

    @property
    def offset(self) -> int:
        return packed_layout(self.head, self.body, self.dtype)[0]


def packed_layout(head: int, body: int, dtype):
    """(offset, stride) in bytes of a packed row: the head's float32 values,
    then the body's elements, each part padded to 16 bytes."""
    offset = -(-4 * head // 16) * 16
    return offset, offset + -(-body * torch.empty(0, dtype=dtype).element_size() // 16) * 16


def pack_rows(head, body) -> PackedRows:
    """The packed rows of ``head`` (k, h) float32 and ``body`` (k, ...) on
    the same device."""
    k, h = head.shape
    body = body.reshape(k, math.prod(body.shape[1:]))
    offset, stride = packed_layout(h, body.shape[1], body.dtype)
    data = torch.zeros((k, stride), dtype=torch.uint8, device=head.device)
    data[:, :4 * h] = head.float().contiguous().view(torch.uint8)
    data[:, offset:offset + body.shape[1] * body.element_size()] = (
        body.contiguous().view(torch.uint8))
    return PackedRows(data, h, body.shape[1], body.dtype)


def unpack_rows(rows: PackedRows):
    """(head (U, h) float32, body (U, body) of the rows' dtype)."""
    el = torch.empty(0, dtype=rows.dtype).element_size()
    data = rows.data
    head = data[:, :4 * rows.head].contiguous().view(torch.float32)
    body = data[:, rows.offset:rows.offset + rows.body * el].contiguous().view(rows.dtype)
    return head, body


class ShardTable(NamedTuple):
    """A row shard's table of per-node rows in parts, read where they lie:
    ``own`` (rs, ...) its rows, ``prev`` and ``next`` (R, ...) the previous
    rank's last and the next rank's first R rows (zeros past the graph's
    ends), ``tail`` the remote rows its fallback edges read (ids past the rs
    + 2R halo-extended rows), each packed with its scalars."""

    own: torch.Tensor
    prev: torch.Tensor
    next: torch.Tensor
    tail: PackedRows

    def squeeze_heads(self) -> "ShardTable":
        """The parts of a one-head table as (rows, F)."""
        return self._replace(own=self.own[:, 0], prev=self.prev[:, 0], next=self.next[:, 0])

    def unsqueeze_heads(self) -> "ShardTable":
        """The parts of a one-head table as (rows, 1, F)."""
        return self._replace(own=self.own[:, None], prev=self.prev[:, None],
                             next=self.next[:, None])

    def whole(self):
        """(rows of the table (rs + 2R + U, ...) in the parts' dtype, the
        tail's heads (U, h) float32): the plain versions' table."""
        head, body = unpack_rows(self.tail)
        body = body.reshape((body.shape[0],) + tuple(self.own.shape[1:]))
        return torch.cat([self.prev, self.own, self.next, body.to(self.own.dtype)]), head


def _check_table(table: ShardTable, r_blk: int, heads: int, tail_head: int) -> None:
    own = table.own
    for name, t in (("prev", table.prev), ("next", table.next)):
        if (tuple(t.shape) != (r_blk,) + tuple(own.shape[1:]) or t.dtype != own.dtype
                or t.device != own.device):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} does not "
                             f"match own rows {tuple(own.shape)} {own.dtype} and R = {r_blk}")
    tail = table.tail
    body = math.prod(own.shape[1:])
    if (tail.data.dtype != torch.uint8 or tail.data.dim() != 2 or tail.head != tail_head
            or tail.body != body or tail.dtype != own.dtype
            or tail.data.device != own.device
            or packed_layout(tail_head, body, own.dtype)[1] != tail.data.shape[1]):
        raise ValueError(f"the tail ({tail.head} head values, {tail.body} {tail.dtype} "
                         f"elements, {tuple(tail.data.shape)} bytes) does not match "
                         f"{tail_head} head values and the own rows' {body} {own.dtype}")


def _check(graph: SlabGraph, x, alpha_dst, alpha_src, compute_dtype,
           col_offset: int, tail_rows: int = 0) -> None:
    if x.dim() != 3 or x.dtype not in _FLOAT_CODES:
        raise TypeError(f"x must be (N, H, F) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    x_rows, heads, _ = x.shape
    if heads > MAX_HEADS:
        raise ValueError(f"slab_attention_spmm_mh supports <={MAX_HEADS} "
                         f"heads, got {heads}")
    n = graph.num_rows
    if x_rows != n + 2 * col_offset + tail_rows:
        raise ValueError(f"x has {x_rows} rows, the graph {n}"
                         + (f" plus a {col_offset}-row halo on each side"
                            if col_offset else "")
                         + (f" and {tail_rows} remote rows" if tail_rows else ""))
    for name, a, rows in (("alpha_dst", alpha_dst, n), ("alpha_src", alpha_src, x_rows)):
        if tuple(a.shape) != (rows, heads):
            raise ValueError(f"{name} must be {(rows, heads)}, got {tuple(a.shape)}")
        if a.device != x.device:
            raise ValueError(f"{name} on {a.device}, x on {x.device}")
    if compute_dtype not in _FLOAT_CODES:
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    if graph.ell.device != x.device:
        raise ValueError(f"graph on {graph.ell.device}, x on {x.device}")


def window_columns(ell, block_rows: int, x_rows: int, col_offset: int = 0):
    """(n, K) int64 rows of the per-node inputs that the n rows of a
    window-local ELL (row i's entry j: node (i//R)*R - R + j, at input row
    that plus ``col_offset``) point to, clamped into [0, x_rows), and the
    (n, K) mask of real entries."""
    n = ell.shape[0]
    ell = ell.long()
    base = ((torch.arange(n, device=ell.device) // block_rows) * block_rows
            - block_rows + col_offset)
    cols = base[:, None] + ell
    ok = (ell >= 0) & (cols >= 0) & (cols < x_rows)
    return cols.clamp(0, max(x_rows - 1, 0)), ok


def band_columns(graph: SlabGraph, x_rows: int, col_offset: int = 0):
    """:func:`window_columns` of the graph's band ELL rows."""
    return window_columns(graph.ell[:graph.num_rows], graph.block_rows, x_rows,
                          col_offset)


def fallback_edges(graph: SlabGraph, x_rows: int):
    """(src, dst) int64 of the valid fallback edges, sorted by dst: src an
    input row (< x_rows), dst a graph row."""
    src, dst = graph.fb_src.long(), graph.fb_dst.long()
    ok = (src >= 0) & (dst >= 0) & (src < x_rows) & (dst < graph.num_rows)
    return src[ok], dst[ok]


def _fwd_ref(graph: SlabGraph, x, alpha_dst, alpha_src, negative_slope,
             compute_dtype, return_stats, col_offset, tail_rows=0):
    _check(graph, x, alpha_dst, alpha_src, compute_dtype, col_offset, tail_rows)
    x_rows, heads, f = x.shape
    n = graph.num_rows
    ad, as_ = alpha_dst.float(), alpha_src.float()
    cols, ok = band_columns(graph, x_rows, col_offset)
    src, dst = fallback_edges(graph, x_rows)

    def band_scores(k):
        e = lrelu(ad + as_[cols[:, k]], negative_slope)
        return torch.where(ok[:, k, None], e, -torch.inf)

    m = torch.full((n, heads), -torch.inf, device=x.device)
    for k in range(cols.shape[1]):
        m = torch.maximum(m, band_scores(k))
    if src.numel():
        e_fb = lrelu(ad[dst] + as_[src], negative_slope)
        m = m.scatter_reduce(0, dst[:, None].expand(-1, heads), e_fb, "amax")
    m = torch.where(torch.isfinite(m), m, 0)

    s = torch.zeros((n, heads), device=x.device)
    u = torch.zeros((n, heads, f), device=x.device)
    xb = x.to(compute_dtype).float()     # the band's operand, as on the MXU
    for k in range(cols.shape[1]):
        p = torch.where(ok[:, k, None], torch.exp(band_scores(k) - m), 0)
        s += p
        u += p.to(compute_dtype).float()[..., None] * xb[cols[:, k]]
    if src.numel():
        p_fb = torch.exp(e_fb - m[dst])
        s.index_add_(0, dst, p_fb)
        x32 = x.float()
        for e0 in range(0, src.numel(), _FB_CHUNK):
            sl = slice(e0, e0 + _FB_CHUNK)
            u.index_add_(0, dst[sl], p_fb[sl, :, None] * x32[src[sl]])
    out = u / s.clamp(min=1e-16)[..., None]
    if return_stats:
        return out, m, s
    return out


def _fwd_launch(graph: SlabGraph, x, alpha_dst, alpha_src, negative_slope,
                compute_dtype, return_stats):
    """The forward kernel on the card (inputs already checked)."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x_rows, heads, f = x.shape
    n = graph.num_rows
    if x_rows >= 2**31 or graph.fb_src.shape[0] >= 2**31:
        raise ValueError(f"{x_rows} rows or {graph.fb_src.shape[0]} fallback slots do "
                         f"not fit int32 ids")
    x = x.contiguous()
    ad = alpha_dst.float().contiguous()
    as_ = alpha_src.float().contiguous()
    out = torch.empty((n, heads, f), dtype=torch.float32, device=x.device)
    m = torch.zeros((n, heads), dtype=torch.float32, device=x.device)
    s = torch.zeros((n, heads), dtype=torch.float32, device=x.device)
    if n and heads * f:
        fn = _build.function("slab_attn_fwd", _ARGTYPES)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = fn(x.data_ptr(), _FLOAT_CODES[x.dtype], ad.data_ptr(),
                        as_.data_ptr(), n, 0, x_rows, heads, f,
                        graph.ell.data_ptr(), graph.ell_len.data_ptr(),
                        graph.ell.shape[1], graph.block_rows,
                        graph.fb_rowptr.data_ptr(), graph.fb_src.data_ptr(),
                        float(negative_slope), int(compute_dtype == torch.bfloat16),
                        out.data_ptr(), m.data_ptr(), s.data_ptr(), stream)
        _build.check(status, "slab_attn_fwd")
    if return_stats:
        return out, m, s
    return out


def slab_attention_spmm_mh_ref(graph: SlabGraph, x, alpha_dst, alpha_src, *,
                               negative_slope: float = 0.2,
                               compute_dtype=torch.float32,
                               return_stats: bool = False):
    """Plain PyTorch version of :func:`slab_attention_spmm_mh`: band edges
    one ELL column at a time, fallback edges by ``index_add_`` in chunks."""
    return _fwd_ref(graph, x, alpha_dst, alpha_src, negative_slope, compute_dtype,
                    return_stats, 0)


def slab_attention_spmm_mh(graph: SlabGraph, x, alpha_dst, alpha_src, *,
                           negative_slope: float = 0.2,
                           compute_dtype=torch.float32,
                           return_stats: bool = False):
    """Multi-head fused attention aggregate over every edge of ``graph``.
    x: (N, H, F) float32 or bfloat16, H <= 64; alpha_dst/alpha_src: (N, H).
    Returns (N, H, F) float32, and with ``return_stats`` the row softmax
    stats (m, s), each (N, H) float32 (m = 0, s = 0 on a row without edges).
    With ``compute_dtype`` bfloat16 the band edges' weights and x are
    rounded to bfloat16 before they are multiplied (the JAX package's MXU
    operands); the fallback edges and all sums stay float32.

    CUDA tensors launch the kernel on the current stream without
    synchronising; CPU tensors run :func:`slab_attention_spmm_mh_ref`.
    """
    args = (graph, x, alpha_dst, alpha_src, negative_slope, compute_dtype, return_stats)
    _check(graph, x, alpha_dst, alpha_src, compute_dtype, 0)
    if x.device.type == "cpu":
        return _fwd_ref(*args, 0)
    res = _fwd_launch(*args)
    if graph.num_rows and x.shape[1] * x.shape[2]:
        slab_attention_spmm_mh.launches += 1
    return res


slab_attention_spmm_mh.launches = 0


def _first_head(res, return_stats: bool):
    if return_stats:
        out, m, s = res
        return out[:, 0], m[:, 0], s[:, 0]
    return res[:, 0]


def _check_shard(graph: SlabGraph, table: ShardTable, alpha_dst, alpha_src_ext) -> None:
    """Inputs of the shard forward, (rs, H, F) parts."""
    own = table.own
    if own.dim() != 3 or own.dtype not in _FLOAT_CODES:
        raise TypeError(f"x must be (rs, H, F) float32 or bfloat16, got "
                        f"{tuple(own.shape)} {own.dtype}")
    rs, heads, _ = own.shape
    if heads > MAX_HEADS:
        raise ValueError(f"slab_attention_spmm_mh supports <={MAX_HEADS} "
                         f"heads, got {heads}")
    if rs != graph.num_rows:
        raise ValueError(f"x has {rs} rows, the shard {graph.num_rows}")
    r_blk = graph.block_rows
    _check_table(table, r_blk, heads, heads)
    for name, a, rows in (("alpha_dst", alpha_dst, rs),
                          ("alpha_src_ext", alpha_src_ext, rs + 2 * r_blk)):
        if tuple(a.shape) != (rows, heads):
            raise ValueError(f"{name} must be {(rows, heads)}, got {tuple(a.shape)}")
        if a.device != own.device:
            raise ValueError(f"{name} on {a.device}, x on {own.device}")
    if graph.ell.device != own.device:
        raise ValueError(f"graph on {graph.ell.device}, x on {own.device}")


def _fwd_shard_ref(graph: SlabGraph, table: ShardTable, alpha_dst, alpha_src_ext,
                   negative_slope, return_stats):
    x_all, as_tail = table.whole()
    as_all = torch.cat([alpha_src_ext.float(), as_tail])
    return _fwd_ref(graph, x_all, alpha_dst, as_all, negative_slope, torch.float32,
                    return_stats, graph.block_rows, as_tail.shape[0])


def _fwd_shard_launch(graph: SlabGraph, table: ShardTable, alpha_dst, alpha_src_ext,
                      negative_slope, return_stats):
    """``slab_attn_fwd_shard`` on the card (inputs already checked): the
    table's parts read in place."""
    x = table.own
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not all(t.is_contiguous() for t in (x, table.prev, table.next, table.tail.data)):
        raise ValueError("the table's parts must be contiguous")
    n, heads, f = x.shape
    tail = table.tail.data
    if n + 2 * graph.block_rows + tail.shape[0] >= 2**31 or graph.fb_src.shape[0] >= 2**31:
        raise ValueError(f"the table's rows or {graph.fb_src.shape[0]} fallback slots do "
                         f"not fit int32 ids")
    ad = alpha_dst.float().contiguous()
    as_ = alpha_src_ext.float().contiguous()
    out = torch.empty((n, heads, f), dtype=torch.float32, device=x.device)
    m = torch.zeros((n, heads), dtype=torch.float32, device=x.device)
    s = torch.zeros((n, heads), dtype=torch.float32, device=x.device)
    if n and heads * f:
        fn = _build.function("slab_attn_fwd", _SHARD_ARGTYPES, symbol="slab_attn_fwd_shard")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = fn(x.data_ptr(), table.prev.data_ptr(), table.next.data_ptr(),
                        tail.data_ptr() if tail.numel() else None, tail.shape[0],
                        tail.shape[1], table.tail.offset, _FLOAT_CODES[x.dtype],
                        ad.data_ptr(), as_.data_ptr(), n, heads, f, graph.ell.data_ptr(),
                        graph.ell_len.data_ptr(), graph.ell.shape[1], graph.block_rows,
                        graph.fb_rowptr.data_ptr(), graph.fb_src.data_ptr(),
                        float(negative_slope), out.data_ptr(), m.data_ptr(), s.data_ptr(),
                        stream)
        _build.check(status, "slab_attn_fwd_shard")
    if return_stats:
        return out, m, s
    return out


def slab_attention_spmm_mh_shard_ref(graph: SlabGraph, table: ShardTable, alpha_dst,
                                     alpha_src_ext, *, negative_slope: float = 0.2,
                                     return_stats: bool = False):
    """Plain PyTorch version of :func:`slab_attention_spmm_mh_shard`: builds
    the table's rows, then the one-card plain forward over them."""
    _check_shard(graph, table, alpha_dst, alpha_src_ext)
    return _fwd_shard_ref(graph, table, alpha_dst, alpha_src_ext, negative_slope,
                          return_stats)


def slab_attention_spmm_mh_shard(graph: SlabGraph, table: ShardTable, alpha_dst,
                                 alpha_src_ext, *, negative_slope: float = 0.2,
                                 return_stats: bool = False):
    """One row shard's whole multi-head forward, float32 (rs, H, F) (+ (m,
    s), each (rs, H)), over every edge of its rows: ``graph`` holds the
    shard's rs rows, its band ELL (ids window-local to the halo-extended
    rows) and its fallback edges as a CSR by local row (``fb_rowptr``,
    ``fb_src``) into its table A, ``table`` (a :class:`ShardTable` of x: its
    own (rs, H, F) rows, the R rows before and after them, and the remote
    rows, packed with their alpha_src (H float32 heads)); ``alpha_dst`` (rs,
    H) its rows', ``alpha_src_ext`` (rs + 2R, H) the halo-extended rows'.
    float32 products.  CUDA tensors launch ``slab_attn_fwd_shard`` once,
    reading the parts in place; CPU tensors run
    :func:`slab_attention_spmm_mh_shard_ref`.  Counts
    ``slab_attention_spmm_mh_shard.launches``."""
    _check_shard(graph, table, alpha_dst, alpha_src_ext)
    args = (graph, table, alpha_dst, alpha_src_ext, negative_slope, return_stats)
    if table.own.device.type == "cpu":
        return _fwd_shard_ref(*args)
    res = _fwd_shard_launch(*args)
    if graph.num_rows and table.own.shape[1] * table.own.shape[2]:
        slab_attention_spmm_mh_shard.launches += 1
    return res


slab_attention_spmm_mh_shard.launches = 0


def slab_attention_spmm_shard_ref(graph: SlabGraph, table: ShardTable, alpha_dst,
                                  alpha_src_ext, *, negative_slope: float = 0.2,
                                  return_stats: bool = False):
    """Plain PyTorch version of :func:`slab_attention_spmm_shard`."""
    return _first_head(slab_attention_spmm_mh_shard_ref(
        graph, table.unsqueeze_heads(), alpha_dst[:, None], alpha_src_ext[:, None],
        negative_slope=negative_slope, return_stats=return_stats), return_stats)


def slab_attention_spmm_shard(graph: SlabGraph, table: ShardTable, alpha_dst, alpha_src_ext,
                              *, negative_slope: float = 0.2, return_stats: bool = False):
    """The single-head case of :func:`slab_attention_spmm_mh_shard`: the
    table's parts (rs, F) and (R, F), its tail packed with 1 head value,
    alpha_dst (rs,), alpha_src_ext (rs + 2R,); returns (rs, F) float32 (+
    (m, s), each (rs,)).  Counts ``slab_attention_spmm_shard.launches``, not
    the multi-head wrapper's."""
    args = (graph, table.unsqueeze_heads(), alpha_dst[:, None], alpha_src_ext[:, None],
            negative_slope, return_stats)
    _check_shard(*args[:4])
    if table.own.device.type == "cpu":
        return _first_head(_fwd_shard_ref(*args), return_stats)
    res = _fwd_shard_launch(*args)
    if graph.num_rows and table.own.shape[1]:
        slab_attention_spmm_shard.launches += 1
    return _first_head(res, return_stats)


slab_attention_spmm_shard.launches = 0


def slab_attention_spmm(graph: SlabGraph, x, alpha_dst, alpha_src, *,
                        negative_slope: float = 0.2,
                        compute_dtype=torch.float32,
                        return_stats: bool = False):
    """The single-head case of :func:`slab_attention_spmm_mh`: x (N, F),
    alpha_dst/alpha_src (N,); returns (N, F) float32 (+ (m, s), each (N,))."""
    return _first_head(slab_attention_spmm_mh(
        graph, x[:, None, :], alpha_dst[:, None], alpha_src[:, None],
        negative_slope=negative_slope, compute_dtype=compute_dtype,
        return_stats=return_stats), return_stats)
