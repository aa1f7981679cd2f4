"""Backward pass of the fused slab attention, a CUDA kernel for Hopper, and
the differentiable attention built from both passes.

Counterpart of ``cugraph_gnn_tpu/ops/pallas/slab_attn_grad.py``.  With
a = exp(e - m) / max(s, 1e-16) the normalised attention of the forward
(``slab_attn_kernel.py``) and t[r] = g[r] . out[r]:

    dx[c]         = sum_r a_rc g[r]
    de_rc         = a_rc (g[r] . x[c] - t[r]) lrelu'(z_rc)
    dalpha_dst[r] = sum_c de_rc
    dalpha_src[c] = sum_r de_rc

over every edge, band and fallback.  ``csrc/slab_attn_bwd.cu`` computes the
row sums in a pass over the destination rows (the forward ELL and the
fallback's ``fb_rowptr``) and dx and the column sums in a pass over the
source columns, through a transpose index of exactly the same edges: the
pair's ``t_ell`` where it has one (no bit planes, 3R > 1024), else a
host-built CSR of the band edges by source (``t_rowptr``/``t_rows``), and
always a source-major CSR of the fallback edges (``fb_t_rowptr``/
``fb_t_dst``).  The three wrappers mirror the JAX package's three kernels
and count their own launches: ``onepass_bwd`` (pairs with bit planes),
``slab_attention_bwd`` (H = 1 over ``t_ell``) and ``slab_attention_bwd_mh``
(H > 1 over ``t_ell``; H = 1 goes to ``slab_attention_bwd``).  CPU tensors
run ``slab_attention_bwd_ref``.  The JAX package's VMEM devices (G-stacking,
margin planes, packed stat lanes) have no counterpart; ``MAX_PACKED_HEADS``
stays as the head-group size of ``FullBatchGraph.attention_spmm_mh``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch import _build, _native
from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import (
    _FB_CHUNK,
    band_columns,
    fallback_edges,
    lrelu,
    slab_attention_spmm_mh,
)
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
    SlabGraph,
    _first_occurrence_mask,
    _pack_bits,
)
from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import padded_from_coo

MAX_PACKED_HEADS = 25
_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# x, x dtype, g, alpha_src, stats, n, heads, f, negative_slope, ell,
# k_width, block_rows, fb_rowptr, fb_src, t_ell, t_width, t_rowptr, t_rows,
# fb_t_rowptr, fb_t_dst, dx, dad, das, stream
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = [_P, ctypes.c_int, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float,
             _P, _I64, _I64, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P]


class AttnSlabPair(NamedTuple):
    """Banded split for attention.  ``fwd`` is a regular SlabGraph (the
    forward's input).  With bit planes (3R <= 1024) edges are kept by
    forward rank alone and ``t_ell`` is None; without them ``t_ell`` is the
    transpose-orientation ELL over the same band edges ((n_pad, k_t) int32,
    row = source node, entries = slab-local destination rows), with a
    per-row cap applied in both orientations.  Both equal the JAX package's.

    Port-only transpose indexes for the backward's source pass (device
    tensors, built on the host):
    t_rowptr/t_rows: (N + 1,) int64 / (E_band,) int32, the band edges by
                     source with global destination rows; only where
                     ``t_ell`` is None.
    fb_t_rowptr/fb_t_dst: the same for the fallback edges, always.
    """

    fwd: SlabGraph
    fb_t_rowptr: torch.Tensor
    fb_t_dst: torch.Tensor
    t_ell: Optional[torch.Tensor] = None
    t_rowptr: Optional[torch.Tensor] = None
    t_rows: Optional[torch.Tensor] = None

    def to(self, device) -> "AttnSlabPair":
        """The same pair with its tensors on ``device``."""
        moved = {k: v.to(device) for k, v in self._asdict().items()
                 if isinstance(v, torch.Tensor)}
        return self._replace(fwd=self.fwd.to(device), **moved)


def build_attention_slab_pair(indptr, indices, *, block_rows: int = 256,
                              max_k: int = 64, device=None) -> AttnSlabPair:
    """Split a CSR into a banded ELL plus fallback COO for the fused
    attention kernels (one-time host preprocessing; tensors on ``device``,
    default the card).  With bit planes (3R <= 1024) the forward rank cap
    alone decides the band; otherwise the cap applies in both orientations
    and ``t_ell`` covers exactly the band edges.  Parallel band edges keep
    their first instance; the rest ride the fallback."""
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
    # forward rank within row (CSR edge order), 1-based among in-band
    cs0 = np.concatenate([[0], np.cumsum(inband.astype(np.int64))])
    rank_f = cs0[1:] - cs0[indptr[rows]]
    cand = inband & (rank_f <= max_k)
    cand &= _first_occurrence_mask(rows, cols, cand, n)

    def width(r):
        return max(-(-max(int(r), 1) // 8) * 8, 8)

    t_ell = None
    if 3 * r_blk <= 1024:
        keep = cand
    else:
        # transpose rank within column among candidates (stable CSR
        # order); the symmetric cap
        pos = np.nonzero(cand)[0]
        pc = pos[np.argsort(cols[pos], kind="stable")]
        colc = cols[pc]
        starts = np.concatenate([[0], np.nonzero(colc[1:] != colc[:-1])[0] + 1])
        run_start = np.zeros(len(pc), np.int64)
        run_start[starts] = starts
        run_start = np.maximum.accumulate(run_start)
        rank_t = np.arange(len(pc), dtype=np.int64) - run_start   # 0-based
        keep = np.zeros(len(rows), bool)
        kept_pc = pc[rank_t < max_k]
        keep[kept_pc] = True
        kt = rank_t[rank_t < max_k]
        k_t = width((kt.max() + 1) if keep.any() else 1)
        t_ell = np.full((n_pad, k_t), -1, np.int32)
        t_blk = cols[kept_pc] // r_blk
        t_ell[cols[kept_pc], kt] = (rows[kept_pc] - t_blk * r_blk + r_blk).astype(np.int32)

    k_f = width(rank_f[keep].max()) if keep.any() else 8
    ell = np.full((n_pad, k_f), -1, np.int32)
    slab_local = (cols[keep] - (rows[keep] // r_blk) * r_blk + r_blk).astype(np.int32)
    ell[rows[keep], rank_f[keep] - 1] = slab_local
    ell_bits = _pack_bits(rows[keep], slab_local, n_pad, r_blk)

    fb = valid & ~keep
    pad = (-int(fb.sum())) % 128
    fb_src = np.concatenate([cols[fb].astype(np.int32), np.full(pad, -1, np.int32)])
    fb_dst = np.concatenate([rows[fb].astype(np.int32), np.full(pad, -1, np.int32)])
    fallback = padded_from_coo(fb_src, fb_dst, n, edge_tile=128, device=dev)

    def t(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    fwd = SlabGraph(
        ell=t(ell), ell_w=None, fb_src=fallback.cols, fb_dst=fallback.rows,
        fb_w=None, degrees=t(np.bincount(rows[valid], minlength=n).astype(np.int32)),
        num_rows=n, block_rows=r_blk, n_blocks=n_blocks,
        fb_rowptr=fallback.rowptr, ell_bits=ell_bits)
    # source-major indexes (build_csr groups by its first argument)
    fbt_ptr, fbt_dst, _ = _native.build_csr(cols[fb], rows[fb], n)
    t_ptr = t_rows = None
    if t_ell is None:
        t_ptr, t_rows, _ = _native.build_csr(cols[keep], rows[keep], n)
    return AttnSlabPair(fwd=fwd, fb_t_rowptr=t(fbt_ptr), fb_t_dst=t(fbt_dst),
                        t_ell=t(t_ell), t_rowptr=t(t_ptr), t_rows=t(t_rows))


def _check(pair: AttnSlabPair, x, stats, g) -> None:
    if x.dim() != 3 or x.dtype not in _FLOAT_CODES:
        raise TypeError(f"x must be (N, H, F) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    n, heads, f = x.shape
    if n != pair.fwd.num_rows:
        raise ValueError(f"x has {n} rows, the graph {pair.fwd.num_rows}")
    if tuple(g.shape) != (n, heads, f):
        raise ValueError(f"g must be {(n, heads, f)}, got {tuple(g.shape)}")
    for a in stats:
        if tuple(a.shape) != (n, heads):
            raise ValueError(f"per-node stats must be {(n, heads)}, got "
                             f"{tuple(a.shape)}")
    for a in (*stats, g, pair.fwd.ell):
        if a.device != x.device:
            raise ValueError(f"tensors on {a.device} and {x.device}")


def slab_attention_bwd_ref(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s,
                           t, g, *, negative_slope: float = 0.2):
    """Plain PyTorch version of the backward kernel: (dx (N, H, F),
    dalpha_dst (N, H), dalpha_src (N, H)), float32, over the forward
    orientation's edges (band one ELL column at a time, fallback in
    chunks)."""
    _check(pair, x, (alpha_dst, alpha_src, m, s, t), g)
    graph = pair.fwd
    n, heads, f = x.shape
    ad, as_, m, t = (a.float() for a in (alpha_dst, alpha_src, m, t))
    s_safe = s.float().clamp(min=1e-16)
    x32, g32 = x.float(), g.float()
    dx = torch.zeros((n, heads, f), device=x.device)
    dad = torch.zeros((n, heads), device=x.device)
    das = torch.zeros((n, heads), device=x.device)

    def add(r, c, ok=None):
        z = ad[r] + as_[c]
        a = torch.exp(lrelu(z, negative_slope) - m[r]) / s_safe[r]
        if ok is not None:
            a = torch.where(ok[:, None], a, 0)
        de = (a * torch.where(z >= 0, 1.0, negative_slope)
              * ((g32[r] * x32[c]).sum(-1) - t[r]))
        dad.index_add_(0, r, de)
        das.index_add_(0, c, de)
        dx.index_add_(0, c, a[..., None] * g32[r])

    cols, ok = band_columns(graph, n)
    rows = torch.arange(n, device=x.device)
    for k in range(cols.shape[1]):
        add(rows, cols[:, k], ok[:, k])
    src, dst = fallback_edges(graph, n)
    for e0 in range(0, src.numel(), _FB_CHUNK):
        add(dst[e0:e0 + _FB_CHUNK], src[e0:e0 + _FB_CHUNK])
    return dx, dad, das


def _launch(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s, t, g,
            negative_slope: float):
    """The backward kernel on the card: both passes, one C call."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n, heads, f = x.shape
    if n >= 2**31:
        raise ValueError(f"{n} rows do not fit int32 ids")
    graph = pair.fwd
    stats = torch.stack([alpha_dst.float(), m.float(), s.float().clamp(min=1e-16),
                         t.float()], dim=-1).contiguous()     # (N, H, 4)
    x = x.contiguous()
    g = g.float().contiguous()
    as_ = alpha_src.float().contiguous()
    dx = torch.empty((n, heads, f), dtype=torch.float32, device=x.device)
    dad = torch.zeros((n, heads), dtype=torch.float32, device=x.device)
    das = torch.zeros((n, heads), dtype=torch.float32, device=x.device)
    if not n or not heads * f:
        return dx.zero_(), dad, das

    def ptr(a):
        return None if a is None else a.data_ptr()

    fn = _build.function("slab_attn_bwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), _FLOAT_CODES[x.dtype], g.data_ptr(), as_.data_ptr(),
                    stats.data_ptr(), n, heads, f, float(negative_slope),
                    graph.ell.data_ptr(), graph.ell.shape[1], graph.block_rows,
                    graph.fb_rowptr.data_ptr(), graph.fb_src.data_ptr(),
                    ptr(pair.t_ell), 0 if pair.t_ell is None else pair.t_ell.shape[1],
                    ptr(pair.t_rowptr), ptr(pair.t_rows),
                    pair.fb_t_rowptr.data_ptr(), pair.fb_t_dst.data_ptr(),
                    dx.data_ptr(), dad.data_ptr(), das.data_ptr(), stream)
    _build.check(status, "slab_attn_bwd")
    return dx, dad, das


def onepass_bwd(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s, t, g, *,
                negative_slope: float = 0.2):
    """Gradients for a pair with bit planes (no ``t_ell``): the source pass
    reads the host-built band CSR.  x/g (N, H, F); alpha_*/m/s/t (N, H).
    Returns float32 (dx, dalpha_dst, dalpha_src), fallback edges
    included."""
    _check(pair, x, (alpha_dst, alpha_src, m, s, t), g)
    if x.device.type == "cpu":
        return slab_attention_bwd_ref(pair, x, alpha_dst, alpha_src, m, s, t, g,
                                      negative_slope=negative_slope)
    if pair.t_rows is None:
        raise ValueError("the pair has t_ell, not the band CSR: use "
                         "slab_attention_bwd(_mh)")
    out = _launch(pair, x, alpha_dst, alpha_src, m, s, t, g, negative_slope)
    onepass_bwd.launches += 1
    return out


onepass_bwd.launches = 0


def slab_attention_bwd(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s, t,
                       g, *, negative_slope: float = 0.2):
    """Single-head gradients (dx (N, F), dalpha_dst (N,), dalpha_src (N,)),
    float32, given the forward's stats (m, s) and t[r] = g[r] . out[r].
    Pairs with bit planes go to :func:`onepass_bwd`, as in the JAX
    package."""
    args = (x[:, None], alpha_dst[:, None], alpha_src[:, None], m[:, None],
            s[:, None], t[:, None], g[:, None])
    if pair.t_ell is None:
        dx, dad, das = onepass_bwd(pair, *args, negative_slope=negative_slope)
    else:
        _check(pair, args[0], args[1:6], args[6])
        if x.device.type == "cpu":
            dx, dad, das = slab_attention_bwd_ref(pair, *args,
                                                  negative_slope=negative_slope)
        else:
            dx, dad, das = _launch(pair, *args, negative_slope)
            slab_attention_bwd.launches += 1
    return dx[:, 0], dad[:, 0], das[:, 0]


slab_attention_bwd.launches = 0


def slab_attention_bwd_mh(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s,
                          t, g, *, negative_slope: float = 0.2):
    """Multi-head gradients: x/g (N, H, F); alpha_*/m/s/t (N, H).  Returns
    float32 (dx (N, H, F), dalpha_dst (N, H), dalpha_src (N, H)).
    H <= MAX_PACKED_HEADS.  Pairs with bit planes go to
    :func:`onepass_bwd`; H = 1 goes to :func:`slab_attention_bwd`."""
    heads = x.shape[1] if x.dim() == 3 else 0
    if heads > MAX_PACKED_HEADS:
        raise ValueError(f"slab_attention_bwd_mh supports "
                         f"<={MAX_PACKED_HEADS} heads, got {heads}")
    if pair.t_ell is None:
        return onepass_bwd(pair, x, alpha_dst, alpha_src, m, s, t, g,
                           negative_slope=negative_slope)
    _check(pair, x, (alpha_dst, alpha_src, m, s, t), g)
    if heads == 1:
        dx, dad, das = slab_attention_bwd(
            pair, x[:, 0], alpha_dst[:, 0], alpha_src[:, 0], m[:, 0], s[:, 0],
            t[:, 0], g[:, 0], negative_slope=negative_slope)
        return dx[:, None], dad[:, None], das[:, None]
    if x.device.type == "cpu":
        return slab_attention_bwd_ref(pair, x, alpha_dst, alpha_src, m, s, t, g,
                                      negative_slope=negative_slope)
    out = _launch(pair, x, alpha_dst, alpha_src, m, s, t, g, negative_slope)
    slab_attention_bwd_mh.launches += 1
    return out


slab_attention_bwd_mh.launches = 0


class _SlabAttention(torch.autograd.Function):
    """Forward: the fused attention kernel, keeping its stats.  Backward:
    t = sum(g * out, -1), then the backward kernel; dx in x's dtype and the
    alpha gradients in theirs, as the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, x, alpha_dst, alpha_src, pair, negative_slope):
        out, m, s = slab_attention_spmm_mh(pair.fwd, x, alpha_dst, alpha_src,
                                           negative_slope=negative_slope,
                                           return_stats=True)
        ctx.save_for_backward(x, alpha_dst, alpha_src, out, m, s)
        ctx.pair, ctx.negative_slope = pair, negative_slope
        return out

    @staticmethod
    def backward(ctx, g):
        x, alpha_dst, alpha_src, out, m, s = ctx.saved_tensors
        t = (g.float() * out).sum(-1)
        dx, dad, das = slab_attention_bwd_mh(
            ctx.pair, x, alpha_dst, alpha_src, m, s, t, g,
            negative_slope=ctx.negative_slope)
        return (dx.to(x.dtype), dad.to(alpha_dst.dtype), das.to(alpha_src.dtype),
                None, None)


def differentiable_slab_attention_mh(pair: AttnSlabPair, *,
                                     negative_slope: float = 0.2):
    """f(x (N, H, F), alpha_dst (N, H), alpha_src (N, H)) -> (N, H, F)
    float32, differentiable in all three; H <= MAX_PACKED_HEADS for the
    backward."""
    def f(x, alpha_dst, alpha_src):
        return _SlabAttention.apply(x, alpha_dst, alpha_src, pair, negative_slope)
    return f


def differentiable_slab_attention(pair: AttnSlabPair, *,
                                  negative_slope: float = 0.2):
    """f(x (N, F), alpha_dst (N,), alpha_src (N,)) -> (N, F) float32: the
    single-head case of :func:`differentiable_slab_attention_mh`."""
    f_mh = differentiable_slab_attention_mh(pair, negative_slope=negative_slope)

    def f(x, alpha_dst, alpha_src):
        return f_mh(x[:, None], alpha_dst[:, None], alpha_src[:, None])[:, 0]
    return f
