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
tensors (its header says what bounds it on the H100 and how its design meets
that), runs ``slab_attention_spmm_mh_ref`` for CPU tensors, and counts
``slab_attention_spmm_mh.launches``.  The JAX package merges the fallback
edges into the band's softmax by a log-sum-exp outside its kernel; here the
kernel reads them through the graph's ``fb_rowptr`` and takes one softmax
over all of a row's edges.

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
# x, x dtype, alpha_dst, alpha_src, n, heads, f, ell, k_width, block_rows,
# fb_rowptr, fb_src, negative_slope, round_bf16, out, m, s, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]


def lrelu(z, negative_slope: float):
    return torch.where(z >= 0, z, negative_slope * z)


def _check(graph: SlabGraph, x, alpha_dst, alpha_src, compute_dtype) -> None:
    if x.dim() != 3 or x.dtype not in _FLOAT_CODES:
        raise TypeError(f"x must be (N, H, F) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    n, heads, _ = x.shape
    if heads > MAX_HEADS:
        raise ValueError(f"slab_attention_spmm_mh supports <={MAX_HEADS} "
                         f"heads, got {heads}")
    if n != graph.num_rows:
        raise ValueError(f"x has {n} rows, the graph {graph.num_rows}")
    for name, a in (("alpha_dst", alpha_dst), ("alpha_src", alpha_src)):
        if tuple(a.shape) != (n, heads):
            raise ValueError(f"{name} must be {(n, heads)}, got {tuple(a.shape)}")
        if a.device != x.device:
            raise ValueError(f"{name} on {a.device}, x on {x.device}")
    if compute_dtype not in _FLOAT_CODES:
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    if graph.ell.device != x.device:
        raise ValueError(f"graph on {graph.ell.device}, x on {x.device}")


def band_columns(graph: SlabGraph, n: int):
    """(n, K) int64 global columns of the band ELL's rows (clamped into
    [0, n)) and the (n, K) mask of real entries."""
    r_blk = graph.block_rows
    ell = graph.ell[:n].long()
    base = (torch.arange(n, device=ell.device) // r_blk) * r_blk - r_blk
    cols = base[:, None] + ell
    ok = (ell >= 0) & (cols >= 0) & (cols < n)
    return cols.clamp(0, max(n - 1, 0)), ok


def fallback_edges(graph: SlabGraph, n: int):
    """(src, dst) int64 of the valid fallback edges, sorted by dst."""
    src, dst = graph.fb_src.long(), graph.fb_dst.long()
    ok = (src >= 0) & (dst >= 0) & (src < n) & (dst < n)
    return src[ok], dst[ok]


def slab_attention_spmm_mh_ref(graph: SlabGraph, x, alpha_dst, alpha_src, *,
                               negative_slope: float = 0.2,
                               compute_dtype=torch.float32,
                               return_stats: bool = False):
    """Plain PyTorch version of :func:`slab_attention_spmm_mh`: band edges
    one ELL column at a time, fallback edges by ``index_add_`` in chunks."""
    _check(graph, x, alpha_dst, alpha_src, compute_dtype)
    n, heads, f = x.shape
    ad, as_ = alpha_dst.float(), alpha_src.float()
    cols, ok = band_columns(graph, n)
    src, dst = fallback_edges(graph, n)

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
    _check(graph, x, alpha_dst, alpha_src, compute_dtype)
    if x.device.type == "cpu":
        return slab_attention_spmm_mh_ref(
            graph, x, alpha_dst, alpha_src, negative_slope=negative_slope,
            compute_dtype=compute_dtype, return_stats=return_stats)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n, heads, f = x.shape
    if n >= 2**31:
        raise ValueError(f"{n} rows do not fit int32 column ids")
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
                        as_.data_ptr(), n, heads, f, graph.ell.data_ptr(),
                        graph.ell.shape[1], graph.block_rows,
                        graph.fb_rowptr.data_ptr(), graph.fb_src.data_ptr(),
                        float(negative_slope), int(compute_dtype == torch.bfloat16),
                        out.data_ptr(), m.data_ptr(), s.data_ptr(), stream)
        _build.check(status, "slab_attn_fwd")
        slab_attention_spmm_mh.launches += 1
    if return_stats:
        return out, m, s
    return out


slab_attention_spmm_mh.launches = 0


def slab_attention_spmm(graph: SlabGraph, x, alpha_dst, alpha_src, *,
                        negative_slope: float = 0.2,
                        compute_dtype=torch.float32,
                        return_stats: bool = False):
    """The single-head case of :func:`slab_attention_spmm_mh`: x (N, F),
    alpha_dst/alpha_src (N,); returns (N, F) float32 (+ (m, s), each (N,))."""
    res = slab_attention_spmm_mh(
        graph, x[:, None, :], alpha_dst[:, None], alpha_src[:, None],
        negative_slope=negative_slope, compute_dtype=compute_dtype,
        return_stats=return_stats)
    if return_stats:
        out, m, s = res
        return out[:, 0], m[:, 0], s[:, 0]
    return res[:, 0]
