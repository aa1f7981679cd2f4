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
launch the same kernel on one row shard of a graph (``ops/dist_full_batch.py``):
x and alpha_src carry one R-row halo on each side, alpha_dst and the outputs
cover the shard's rows, and the shard's fallback edges stay outside (the
caller merges them).  Each counts its own launches.

The stats differ from the JAX package's where a row lacks band or fallback
edges: its merged ``m`` is max(true max, 0) and its ``s`` is scaled to
match, while the port returns the true max.  Both give the same
``m + log(s)`` and the same ``exp(e - m) / s``, which is all that the output
and the backward use.
"""

from __future__ import annotations

import ctypes

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


def lrelu(z, negative_slope: float):
    return torch.where(z >= 0, z, negative_slope * z)


def _check(graph: SlabGraph, x, alpha_dst, alpha_src, compute_dtype,
           col_offset: int) -> None:
    if x.dim() != 3 or x.dtype not in _FLOAT_CODES:
        raise TypeError(f"x must be (N, H, F) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    x_rows, heads, _ = x.shape
    if heads > MAX_HEADS:
        raise ValueError(f"slab_attention_spmm_mh supports <={MAX_HEADS} "
                         f"heads, got {heads}")
    n = graph.num_rows
    if x_rows != n + 2 * col_offset:
        raise ValueError(f"x has {x_rows} rows, the graph {n}"
                         + (f" plus a {col_offset}-row halo on each side"
                            if col_offset else ""))
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
             compute_dtype, return_stats, col_offset):
    _check(graph, x, alpha_dst, alpha_src, compute_dtype, col_offset)
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
                compute_dtype, return_stats, col_offset):
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
                        as_.data_ptr(), n, col_offset, x_rows, heads, f,
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
    args = (graph, x, alpha_dst, alpha_src, negative_slope, compute_dtype, return_stats, 0)
    _check(graph, x, alpha_dst, alpha_src, compute_dtype, 0)
    if x.device.type == "cpu":
        return _fwd_ref(*args)
    res = _fwd_launch(*args)
    if graph.num_rows and x.shape[1] * x.shape[2]:
        slab_attention_spmm_mh.launches += 1
    return res


slab_attention_spmm_mh.launches = 0


def slab_attention_spmm_mh_shard_ref(graph: SlabGraph, x_ext, alpha_dst, alpha_src_ext, *,
                                     negative_slope: float = 0.2,
                                     compute_dtype=torch.float32,
                                     return_stats: bool = False):
    """Plain PyTorch version of :func:`slab_attention_spmm_mh_shard`."""
    return _fwd_ref(graph, x_ext, alpha_dst, alpha_src_ext, negative_slope,
                    compute_dtype, return_stats, graph.block_rows)


def slab_attention_spmm_mh_shard(graph: SlabGraph, x_ext, alpha_dst, alpha_src_ext, *,
                                 negative_slope: float = 0.2,
                                 compute_dtype=torch.float32,
                                 return_stats: bool = False):
    """The multi-head forward over one row shard's band: ``graph`` holds
    the shard's rs rows (no fallback edges), ``x_ext`` (rs + 2R, H, F) and
    ``alpha_src_ext`` (rs + 2R, H) the shard's rows with the R rows before
    and after it (zeros past the graph's ends), ``alpha_dst`` (rs, H) its
    own.  Returns as :func:`slab_attention_spmm_mh`, for the rs rows; counts
    ``slab_attention_spmm_mh_shard.launches``."""
    args = (graph, x_ext, alpha_dst, alpha_src_ext, negative_slope, compute_dtype,
            return_stats, graph.block_rows)
    _check(graph, x_ext, alpha_dst, alpha_src_ext, compute_dtype, graph.block_rows)
    if x_ext.device.type == "cpu":
        return _fwd_ref(*args)
    res = _fwd_launch(*args)
    if graph.num_rows and x_ext.shape[1] * x_ext.shape[2]:
        slab_attention_spmm_mh_shard.launches += 1
    return res


slab_attention_spmm_mh_shard.launches = 0


def _first_head(res, return_stats: bool):
    if return_stats:
        out, m, s = res
        return out[:, 0], m[:, 0], s[:, 0]
    return res[:, 0]


def slab_attention_spmm_shard_ref(graph: SlabGraph, x_ext, alpha_dst, alpha_src_ext, *,
                                  negative_slope: float = 0.2,
                                  compute_dtype=torch.float32,
                                  return_stats: bool = False):
    """Plain PyTorch version of :func:`slab_attention_spmm_shard`."""
    return _first_head(_fwd_ref(graph, x_ext[:, None, :], alpha_dst[:, None],
                                alpha_src_ext[:, None], negative_slope, compute_dtype,
                                return_stats, graph.block_rows), return_stats)


def slab_attention_spmm_shard(graph: SlabGraph, x_ext, alpha_dst, alpha_src_ext, *,
                              negative_slope: float = 0.2,
                              compute_dtype=torch.float32,
                              return_stats: bool = False):
    """The single-head case of :func:`slab_attention_spmm_mh_shard`: x_ext
    (rs + 2R, F), alpha_dst (rs,), alpha_src_ext (rs + 2R,); returns (rs, F)
    float32 (+ (m, s), each (rs,)).  Counts
    ``slab_attention_spmm_shard.launches``, not the multi-head wrapper's."""
    args = (graph, x_ext[:, None, :], alpha_dst[:, None], alpha_src_ext[:, None],
            negative_slope, compute_dtype, return_stats, graph.block_rows)
    _check(*args[:4], compute_dtype, graph.block_rows)
    if x_ext.device.type == "cpu":
        return _first_head(_fwd_ref(*args), return_stats)
    res = _fwd_launch(*args)
    if graph.num_rows and x_ext.shape[1]:
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
