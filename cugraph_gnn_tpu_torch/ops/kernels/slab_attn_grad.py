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
source columns, through a transpose index of exactly the same edges: a
host-built CSR of the band edges by source (``t_rowptr``/``t_rows``, every
pair) where the kernel's shared-memory window fits (block_rows <= 526 on
an H100), else the pair's ``t_ell`` (no bit planes, 3R > 1024); and always
a source-major CSR of the fallback edges (``fb_t_rowptr``/``fb_t_dst``).
:func:`backward_design` says which one a pair's shape takes.  The three
wrappers mirror the JAX package's three kernels and count their own
launches: ``onepass_bwd`` (pairs with bit planes), ``slab_attention_bwd``
(H = 1, pairs with ``t_ell``) and ``slab_attention_bwd_mh`` (H > 1, pairs
with ``t_ell``; H = 1 goes to ``slab_attention_bwd``).  CPU tensors run
``slab_attention_bwd_ref``, which walks ``t_ell`` where the pair has it (the
TPU kernels' walk).  Their ``_shard`` twins compute one row shard's
whole backward (``ops/dist_full_batch.py``, the JAX package's sharded
backwards) in one call of ``csrc/slab_attn_bwd_shard.cu``, the same
kernels over the shard's two tables of halo and remote rows (table A of x,
table B of g, see "one row shard" below): band and fallback edges, every
gradient summed on its owner; each counts its own launches.  The three
whole-graph wrappers take ``compute_dtype`` as the JAX package's kernels
do: with bfloat16 the band edges' products g . x and a g take operands
rounded to bfloat16 (the TPU kernels' MXU inputs) and every sum stays
float32; the fallback edges and the shard wrappers stay float32, as the
JAX package's segment sums and sharded backwards.  The JAX package's
VMEM devices (G-stacking, margin planes, packed stat lanes) have no
counterpart; ``MAX_PACKED_HEADS`` stays as the head-group size of
``FullBatchGraph.attention_spmm_mh`` and ``DistFullBatchGraph``'s.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch import _build, _native
from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import (
    _FB_CHUNK,
    ShardTable,
    _check_table,
    band_columns,
    fallback_edges,
    lrelu,
    slab_attention_spmm_mh,
    window_columns,
)
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
    SlabGraph,
    _first_occurrence_mask,
    _pack_bits,
    ell_lengths,
)
from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import padded_from_coo

MAX_PACKED_HEADS = 25
_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# x, x dtype, g, alpha_src, stats, n, col_offset, x_rows, heads, f,
# negative_slope, ell, k_width, block_rows, fb_rowptr, fb_src, t_ell, t_width,
# t_rowptr, t_rows, fb_t_rowptr, fb_t_dst, dx, dad, das, stream, then
# round_bf16 (slab_attn_bwd) or phases (slab_attn_bwd_probe)
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = [_P, ctypes.c_int, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
             ctypes.c_float, _P, _I64, _I64, _P, _P, _P, _I64, _P, _P, _P, _P, _P,
             _P, _P, _P, ctypes.c_int]


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
                     source with global destination rows, every pair
                     (with ``t_ell``: exactly its edges, each column's in
                     its slot order).
    fb_t_rowptr/fb_t_dst: the same for the fallback edges.
    band_csr_seconds: host seconds of the ``t_rowptr``/``t_rows`` build
                      (0.0 for a pair that was not built from a CSR).
    """

    fwd: SlabGraph
    fb_t_rowptr: torch.Tensor
    fb_t_dst: torch.Tensor
    t_ell: Optional[torch.Tensor] = None
    t_rowptr: Optional[torch.Tensor] = None
    t_rows: Optional[torch.Tensor] = None
    band_csr_seconds: float = 0.0

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
    and ``t_ell`` covers exactly the band edges.  Every pair also gets the
    band edges by source as a CSR (``t_rowptr``/``t_rows``), which the
    backward kernel reads wherever its window fits.  Parallel band edges
    keep their first instance; the rest ride the fallback."""
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
        # (no candidates at all: no runs)
        starts = np.concatenate([[0], np.nonzero(colc[1:] != colc[:-1])[0] + 1])[:len(pc)]
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
        fb_rowptr=fallback.rowptr, ell_bits=ell_bits, ell_len=ell_lengths(t(ell)))
    # source-major indexes (build_csr groups by its first argument, stably:
    # a column's band edges keep their CSR order, which is t_ell's slot order)
    fbt_ptr, fbt_dst, _ = _native.build_csr(cols[fb], rows[fb], n)
    t0 = time.perf_counter()
    t_ptr, t_rows, _ = _native.build_csr(cols[keep], rows[keep], n)
    band_csr_s = time.perf_counter() - t0
    return AttnSlabPair(fwd=fwd, fb_t_rowptr=t(fbt_ptr), fb_t_dst=t(fbt_dst),
                        t_ell=t(t_ell), t_rowptr=t(t_ptr), t_rows=t(t_rows),
                        band_csr_seconds=band_csr_s)


def _check(pair: AttnSlabPair, x, stats, g) -> None:
    if x.dim() != 3 or x.dtype not in _FLOAT_CODES:
        raise TypeError(f"x must be (N, H, F) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    x_rows, heads, f = x.shape
    n = pair.fwd.num_rows
    if x_rows != n:
        raise ValueError(f"x has {x_rows} rows, the graph {n}")
    if tuple(g.shape) != (x_rows, heads, f):
        raise ValueError(f"g must be {(x_rows, heads, f)}, got {tuple(g.shape)}")
    for a in stats:
        if tuple(a.shape) != (x_rows, heads):
            raise ValueError(f"per-node stats must be {(x_rows, heads)}, got "
                             f"{tuple(a.shape)}")
    for a in (*stats, g, pair.fwd.ell):
        if a.device != x.device:
            raise ValueError(f"tensors on {a.device} and {x.device}")


def _check_compute(compute_dtype) -> None:
    if compute_dtype not in _FLOAT_CODES:
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")


def _bwd_ref(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s, t, g,
             negative_slope, compute_dtype=torch.float32):
    """The kernel's two passes in plain PyTorch: dalpha_dst over each row's
    edges by destination (band ELL, fallback), dx and dalpha_src over each
    column's edges by source (``t_ell`` where the pair has it, else the band
    CSR; then the fallback CSR).  With ``compute_dtype`` bfloat16 the band
    edges' g, x and a are rounded to it before they are multiplied."""
    _check(pair, x, (alpha_dst, alpha_src, m, s, t), g)
    _check_compute(compute_dtype)
    return _bwd_sums(pair, (x, alpha_src), (alpha_dst, m, s, t, g), negative_slope, 0,
                     compute_dtype)


def _bwd_sums(pair: AttnSlabPair, src_side, dst_side, negative_slope, col_offset,
              compute_dtype=torch.float32):
    """:func:`_bwd_ref`'s sums with the per-node inputs in two tables: an
    edge r <- c reads x and alpha_src at c's row of ``src_side`` (x,
    alpha_src) and alpha_dst, m, s, t and g at r's row of ``dst_side``; the
    band's rows are the first n + 2 col_offset of each (node i at row i +
    col_offset), the fallback edges' sources name rows of ``src_side`` and
    their destinations by source (``fb_t_dst``) rows of ``dst_side``."""
    graph = pair.fwd
    n = graph.num_rows
    x, alpha_src = src_side
    alpha_dst, m, s, t, g = dst_side
    heads, f = x.shape[1:]
    band_rows = n + 2 * col_offset
    ad, as_, m, t = (a.float() for a in (alpha_dst, alpha_src, m, t))
    s_safe = s.float().clamp(min=1e-16)
    x32, g32 = x.float(), g.float()

    def cd(v):   # a band operand, as on the TPU's MXU
        return v if compute_dtype == torch.float32 else v.to(compute_dtype).float()

    xb, gb = cd(x32), cd(g32)
    dx = torch.zeros((n, heads, f), device=x.device)
    dad = torch.zeros((n, heads), device=x.device)
    das = torch.zeros((n, heads), device=x.device)

    def edge(r, c, ok=None, band=False):
        """The weights of dx and de of the edges r <- c (r a row of
        ``dst_side``, c of ``src_side``), and g[r] as dx takes it."""
        z = ad[r] + as_[c]
        a = torch.exp(lrelu(z, negative_slope) - m[r]) / s_safe[r]
        if ok is not None:
            a = torch.where(ok[:, None], a, 0)
        xx, gg = (xb, gb) if band else (x32, g32)
        de = (a * torch.where(z >= 0, 1.0, negative_slope)
              * ((gg[r] * xx[c]).sum(-1) - t[r]))
        return (cd(a) if band else a), de, gg[r]

    def by_source(c, r, band):   # c: local columns, r: dst_side rows; in chunks
        for e0 in range(0, c.numel(), _FB_CHUNK):
            cc, rr = c[e0:e0 + _FB_CHUNK], r[e0:e0 + _FB_CHUNK]
            a, de, gr = edge(rr, cc + col_offset, band=band)
            das.index_add_(0, cc, de)
            dx.index_add_(0, cc, a[..., None] * gr)

    def csr(rowptr, ids, rows):
        cnt = (rowptr[1:n + 1] - rowptr[:n]).long()
        ids = ids.long()
        c = torch.repeat_interleave(torch.arange(n, device=x.device), cnt)
        ok = (ids >= 0) & (ids < rows)
        return c[ok], ids[ok]

    own = torch.arange(n, device=x.device) + col_offset
    cols, ok = band_columns(graph, band_rows, col_offset)
    for k in range(cols.shape[1]):
        dad += edge(own, cols[:, k], ok[:, k], band=True)[1]
    src, dst = fallback_edges(graph, x.shape[0])
    for e0 in range(0, src.numel(), _FB_CHUNK):
        d = dst[e0:e0 + _FB_CHUNK]
        dad.index_add_(0, d, edge(d + col_offset, src[e0:e0 + _FB_CHUNK])[1])

    if pair.t_ell is not None:
        rows, ok = window_columns(pair.t_ell[:n], graph.block_rows, band_rows, col_offset)
        for k in range(rows.shape[1]):
            a, de, gr = edge(rows[:, k], own, ok[:, k], band=True)
            das += de
            dx += a[..., None] * gr
    else:
        by_source(*csr(pair.t_rowptr, pair.t_rows, band_rows), band=True)
    by_source(*csr(pair.fb_t_rowptr, pair.fb_t_dst, g.shape[0]), band=False)
    return dx, dad, das


def slab_attention_bwd_ref(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s, t,
                           g, *, negative_slope: float = 0.2,
                           compute_dtype=torch.float32):
    """Plain PyTorch version of the backward kernel: (dx (N, H, F),
    dalpha_dst (N, H), dalpha_src (N, H)), float32; ``compute_dtype`` as
    :func:`onepass_bwd`'s."""
    return _bwd_ref(pair, x, alpha_dst, alpha_src, m, s, t, g, negative_slope, compute_dtype)


def _launch(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s, t, g,
            negative_slope: float, phases: Optional[int] = None,
            compute_dtype=torch.float32):
    """The backward kernel on the card: both passes, one C call (with
    ``phases``, the probe entry ``slab_attn_bwd_probe``, float32 only)."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x_rows, heads, f = x.shape
    n = pair.fwd.num_rows
    if x_rows >= 2**31:
        raise ValueError(f"{x_rows} rows do not fit int32 ids")
    graph = pair.fwd
    stats = torch.stack([alpha_dst.float(), m.float(), s.float().clamp(min=1e-16),
                         t.float()], dim=-1).contiguous()     # (x_rows, H, 4)
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

    if phases is None:
        fn = _build.function("slab_attn_bwd", _ARGTYPES)
        last = int(compute_dtype == torch.bfloat16)
    else:
        fn = _build.function("slab_attn_bwd", _ARGTYPES, symbol="slab_attn_bwd_probe")
        last = int(phases)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), _FLOAT_CODES[x.dtype], g.data_ptr(), as_.data_ptr(),
                    stats.data_ptr(), n, 0, x_rows, heads, f,
                    float(negative_slope), graph.ell.data_ptr(), graph.ell.shape[1],
                    graph.block_rows, graph.fb_rowptr.data_ptr(), graph.fb_src.data_ptr(),
                    ptr(pair.t_ell), 0 if pair.t_ell is None else pair.t_ell.shape[1],
                    ptr(pair.t_rowptr), ptr(pair.t_rows),
                    pair.fb_t_rowptr.data_ptr(), pair.fb_t_dst.data_ptr(),
                    dx.data_ptr(), dad.data_ptr(), das.data_ptr(), stream, last)
    _build.check(status, "slab_attn_bwd" if phases is None else "slab_attn_bwd_probe")
    return dx, dad, das


_DESIGNS = {1: "windows", 2: "warp_per_node"}


def backward_design(pair: AttnSlabPair, f: int):
    """Which kernels the backward launches for ``pair`` (on the card) at
    heads of ``f`` elements, as the kernel decides it by shape before any
    launch: ("windows", chunk, tile) for the band kernels over shared-memory
    windows, ``chunk`` elements of a head at a time over tiles of ``tile``
    rows (fewer than the pair's block rows where a whole head's window does
    not fit), or ("warp_per_node", 0, 0) for the kernels over ``t_ell`` (a
    window of 32-element chunks does not fit the device).  Raises where the
    pair fits neither."""
    if pair.fwd.ell.device.type != "cuda":
        raise ValueError(f"no kernel for device {pair.fwd.ell.device}")
    out = ctypes.POINTER(ctypes.c_int)
    fn = _build.function("slab_attn_bwd", [_I64, _I64, ctypes.c_int, ctypes.c_int, out, out,
                                           ctypes.POINTER(ctypes.c_int64)],
                         symbol="slab_attn_bwd_design")
    design, chunk, tile = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int64(0)
    with torch.cuda.device(pair.fwd.ell.device):
        status = fn(pair.fwd.block_rows, int(f), pair.t_rows is not None,
                    pair.t_ell is not None, ctypes.byref(design), ctypes.byref(chunk),
                    ctypes.byref(tile))
    _build.check(status, "slab_attn_bwd_design")
    if design.value not in _DESIGNS:
        raise ValueError(f"no backward kernel takes a pair of block_rows "
                         f"{pair.fwd.block_rows} without t_ell")
    return _DESIGNS[design.value], chunk.value, tile.value


def _run(counter, pair, args, negative_slope, compute_dtype=torch.float32):
    """The plain version for CPU tensors, else the kernel, counted."""
    x = args[0]
    _check(pair, x, args[1:6], args[6])
    _check_compute(compute_dtype)
    if x.device.type == "cpu":
        return _bwd_ref(pair, *args, negative_slope, compute_dtype)
    if pair.t_ell is None and pair.t_rows is None:
        raise ValueError("the pair has neither t_ell nor the band CSR by source")
    out = _launch(pair, *args, negative_slope, compute_dtype=compute_dtype)
    counter.launches += 1
    return out


def _squeeze_heads(res):
    dx, dad, das = res
    return dx[:, 0], dad[:, 0], das[:, 0]


def onepass_bwd(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s, t, g, *,
                negative_slope: float = 0.2, compute_dtype=torch.float32):
    """Gradients for a pair with bit planes (no ``t_ell``): the source pass
    reads the host-built band CSR.  x/g (N, H, F); alpha_*/m/s/t (N, H).
    Returns float32 (dx, dalpha_dst, dalpha_src), fallback edges
    included.  ``compute_dtype`` (float32 or bfloat16): the operands of the
    band edges' products g . x and a g; sums stay float32."""
    if pair.t_ell is not None and x.device.type != "cpu":
        raise ValueError("the pair has t_ell, not the band CSR: use "
                         "slab_attention_bwd(_mh)")
    return _run(onepass_bwd, pair, (x, alpha_dst, alpha_src, m, s, t, g),
                negative_slope, compute_dtype)


onepass_bwd.launches = 0


def slab_attention_bwd(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s, t,
                       g, *, negative_slope: float = 0.2, compute_dtype=torch.float32):
    """Single-head gradients (dx (N, F), dalpha_dst (N,), dalpha_src (N,)),
    float32, given the forward's stats (m, s) and t[r] = g[r] . out[r];
    ``compute_dtype`` as :func:`onepass_bwd`'s.  Pairs with bit planes go to
    :func:`onepass_bwd`, as in the JAX package."""
    args = (x[:, None], alpha_dst[:, None], alpha_src[:, None], m[:, None],
            s[:, None], t[:, None], g[:, None])
    if pair.t_ell is None:
        return _squeeze_heads(onepass_bwd(pair, *args, negative_slope=negative_slope,
                                          compute_dtype=compute_dtype))
    return _squeeze_heads(_run(slab_attention_bwd, pair, args, negative_slope,
                               compute_dtype))


slab_attention_bwd.launches = 0


def slab_attention_bwd_mh(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s,
                          t, g, *, negative_slope: float = 0.2,
                          compute_dtype=torch.float32):
    """Multi-head gradients: x/g (N, H, F); alpha_*/m/s/t (N, H).  Returns
    float32 (dx (N, H, F), dalpha_dst (N, H), dalpha_src (N, H));
    ``compute_dtype`` as :func:`onepass_bwd`'s.  H <= MAX_PACKED_HEADS.
    Pairs with bit planes go to :func:`onepass_bwd`; H = 1 goes to
    :func:`slab_attention_bwd`."""
    heads = x.shape[1] if x.dim() == 3 else 0
    if heads > MAX_PACKED_HEADS:
        raise ValueError(f"slab_attention_bwd_mh supports "
                         f"<={MAX_PACKED_HEADS} heads, got {heads}")
    if pair.t_ell is None:
        return onepass_bwd(pair, x, alpha_dst, alpha_src, m, s, t, g,
                           negative_slope=negative_slope, compute_dtype=compute_dtype)
    _check(pair, x, (alpha_dst, alpha_src, m, s, t), g)
    if heads == 1:
        dx, dad, das = slab_attention_bwd(
            pair, x[:, 0], alpha_dst[:, 0], alpha_src[:, 0], m[:, 0], s[:, 0],
            t[:, 0], g[:, 0], negative_slope=negative_slope, compute_dtype=compute_dtype)
        return dx[:, None], dad[:, None], das[:, None]
    return _run(slab_attention_bwd_mh, pair, (x, alpha_dst, alpha_src, m, s, t, g),
                negative_slope, compute_dtype)


slab_attention_bwd_mh.launches = 0


# -- phase probe -------------------------------------------------------------
# Counterpart of the JAX package's benchmarks/bwd_kernel_anatomy.py (decode /
# exp / dots) and benchmarks/attn_bwd_probe.py: variants of the one-pass
# backward with phases switched off at compile time and the memory traffic
# kept.  The port reads the band CSR by source, so there is no decode phase.
PROBE_DST, PROBE_SRC, PROBE_EXP, PROBE_DOTS = 1, 2, 4, 8
PROBE_ALL = PROBE_DST | PROBE_SRC | PROBE_EXP | PROBE_DOTS


def onepass_bwd_probe(pair: AttnSlabPair, x, alpha_dst, alpha_src, m, s, t, g, *,
                      phases: int = PROBE_ALL, negative_slope: float = 0.2):
    """:func:`onepass_bwd`'s kernel with only ``phases`` on (a mask of
    ``PROBE_DST``, ``PROBE_SRC``, ``PROBE_EXP``, ``PROBE_DOTS``): a timing
    probe on the card, not part of any path.  ``PROBE_ALL`` runs exactly the
    kernel's code and returns its (dx, dalpha_dst, dalpha_src); other masks
    take float32 x only and return meaningless values (tiles shorter than
    the pair's block rows, such as R = 512's, take only a pass alone with
    both other phases on).  CUDA tensors only; counts
    ``onepass_bwd_probe.launches``."""
    _check(pair, x, (alpha_dst, alpha_src, m, s, t), g)
    if not 0 <= phases <= PROBE_ALL:
        raise ValueError(f"phases must be a mask within {PROBE_ALL}, got {phases}")
    if pair.t_ell is not None or pair.t_rows is None:
        raise ValueError("the probe takes a pair with the band CSR by source")
    out = _launch(pair, x, alpha_dst, alpha_src, m, s, t, g, negative_slope, phases=phases)
    onepass_bwd_probe.launches += 1
    return out


onepass_bwd_probe.launches = 0


# -- one row shard -----------------------------------------------------------
# One row shard's whole backward (``ops/dist_full_batch.py``) in one call of
# ``csrc/slab_attn_bwd_shard.cu`` (its two passes): the shard's pair holds
# its rs rows of the band by destination (forward ELL) and by source (the
# band CSR by source with halo-extended destination rows, and ``t_ell`` rows
# where the pair has them) and its fallback edges planned into its two
# tables: by destination into table A (``fwd.fb_rowptr``/``fb_src``: ids of
# source rows of x) and by source into table B (``fb_t_rowptr``/``fb_t_dst``:
# ids of destination rows of g).  Table A is a ``ShardTable`` of x whose tail
# carries alpha_src (H float32 a row), table B one of g (float32) whose tail
# carries the stats (4 H float32 a row, :func:`attention_stats`'s layout);
# ``alpha_src_ext`` (rs + 2R, H) and ``stats_ext`` (rs + 2R, H, 4) hold the
# halo-extended rows' scalars.  The gradients cover the rs rows.

# x, x_prev, x_next, tail A, its rows, stride and offset, x dtype,
# alpha_src, g, g_prev, g_next, tail B, its rows, stride and offset, stats,
# n, heads, f, negative_slope, ell, k_width, block_rows, fb_rowptr, fb_src,
# t_ell, t_width, t_rowptr, t_rows, fb_t_rowptr, fb_t_dst, dx, dad, das,
# stream (slab_attn_bwd_shard)
_SHARD_ARGTYPES = ([_P] * 4 + [_I64] * 3 + [ctypes.c_int] + [_P] * 5 + [_I64] * 3 + [_P]
                   + [_I64] * 3 + [ctypes.c_float, _P, _I64, _I64, _P, _P, _P, _I64]
                   + [_P] * 8)


def attention_stats(alpha_dst, m, s, t, out=None):
    """(rows, H, 4) float32 (alpha_dst, m, max(s, 1e-16), t): the per-node
    stats as the backward kernels read them (written into ``out``, a
    contiguous (rows, H, 4) float32 tensor, where given)."""
    parts = [alpha_dst.float(), m.float(), s.float().clamp(min=1e-16), t.float()]
    if out is None:
        return torch.stack(parts, dim=-1)
    return torch.stack(parts, dim=-1, out=out)


def _check_shard(pair: AttnSlabPair, table_a: ShardTable, alpha_src_ext,
                 table_b: ShardTable, stats_ext) -> None:
    x, g = table_a.own, table_b.own
    if x.dim() != 3 or x.dtype not in _FLOAT_CODES:
        raise TypeError(f"x must be (rs, H, F) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    rs, heads, _ = x.shape
    r_blk = pair.fwd.block_rows
    if rs != pair.fwd.num_rows:
        raise ValueError(f"x has {rs} rows, the shard {pair.fwd.num_rows}")
    if tuple(g.shape) != tuple(x.shape) or g.dtype != torch.float32:
        raise ValueError(f"g must be {tuple(x.shape)} float32, got {tuple(g.shape)} {g.dtype}")
    _check_table(table_a, r_blk, heads, heads)
    _check_table(table_b, r_blk, heads, 4 * heads)
    for name, a, shape in (("alpha_src_ext", alpha_src_ext, (rs + 2 * r_blk, heads)),
                           ("stats_ext", stats_ext, (rs + 2 * r_blk, heads, 4))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    for a in (g, alpha_src_ext, stats_ext, pair.fwd.ell):
        if a.device != x.device:
            raise ValueError(f"tensors on {a.device} and {x.device}")


def _bwd_shard_ref(pair: AttnSlabPair, table_a, alpha_src_ext, table_b, stats_ext,
                   negative_slope):
    x_all, as_tail = table_a.whole()
    g_all, st_tail = table_b.whole()
    heads = x_all.shape[1]
    stats = torch.cat([stats_ext.float(), st_tail.reshape(-1, heads, 4)])
    return _bwd_sums(pair, (x_all, torch.cat([alpha_src_ext.float(), as_tail])),
                     (*stats.unbind(-1), g_all), negative_slope, pair.fwd.block_rows)


def _bwd_shard_launch(pair: AttnSlabPair, table_a, alpha_src_ext, table_b, stats_ext,
                      negative_slope):
    """The shard entry on the card (inputs already checked): both tables'
    parts read in place."""
    x = table_a.own
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if pair.t_ell is None and pair.t_rows is None:
        raise ValueError("the pair has neither t_ell nor the band CSR by source")
    parts = (*table_a[:3], table_a.tail.data, *table_b[:3], table_b.tail.data)
    if not all(t.is_contiguous() for t in parts):
        raise ValueError("the tables' parts must be contiguous")
    n, heads, f = x.shape
    r_blk = pair.fwd.block_rows
    if n + 2 * r_blk + max(table_a.tail.data.shape[0], table_b.tail.data.shape[0]) >= 2**31:
        raise ValueError("the tables' rows do not fit int32 ids")
    as_ = alpha_src_ext.float().contiguous()
    st = stats_ext.float().contiguous()
    dx = torch.empty((n, heads, f), dtype=torch.float32, device=x.device)
    dad = torch.zeros((n, heads), dtype=torch.float32, device=x.device)
    das = torch.zeros((n, heads), dtype=torch.float32, device=x.device)
    if not n or not heads * f:
        return dx.zero_(), dad, das

    def ptr(a):
        return None if a is None or not a.numel() else a.data_ptr()

    graph = pair.fwd
    ta, tb = table_a.tail, table_b.tail
    fn = _build.function("slab_attn_bwd_shard", _SHARD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), table_a.prev.data_ptr(), table_a.next.data_ptr(),
                    ptr(ta.data), ta.data.shape[0], ta.data.shape[1], ta.offset,
                    _FLOAT_CODES[x.dtype], as_.data_ptr(), table_b.own.data_ptr(),
                    table_b.prev.data_ptr(), table_b.next.data_ptr(), ptr(tb.data),
                    tb.data.shape[0], tb.data.shape[1], tb.offset, st.data_ptr(), n, heads, f,
                    float(negative_slope), graph.ell.data_ptr(), graph.ell.shape[1], r_blk,
                    graph.fb_rowptr.data_ptr(), ptr(graph.fb_src),
                    None if pair.t_ell is None else pair.t_ell.data_ptr(),
                    0 if pair.t_ell is None else pair.t_ell.shape[1],
                    None if pair.t_rowptr is None else pair.t_rowptr.data_ptr(),
                    ptr(pair.t_rows), pair.fb_t_rowptr.data_ptr(), ptr(pair.fb_t_dst),
                    dx.data_ptr(), dad.data_ptr(), das.data_ptr(), stream)
    _build.check(status, "slab_attn_bwd_shard")
    return dx, dad, das


def _run_shard(counter, pair, table_a, alpha_src_ext, table_b, stats_ext, negative_slope):
    """The plain version for CPU tensors, else the shard entry, counted."""
    _check_shard(pair, table_a, alpha_src_ext, table_b, stats_ext)
    args = (pair, table_a, alpha_src_ext, table_b, stats_ext, negative_slope)
    if table_a.own.device.type == "cpu":
        return _bwd_shard_ref(*args)
    out = _bwd_shard_launch(*args)
    counter.launches += 1
    return out


def slab_attention_bwd_shard_ref(pair: AttnSlabPair, table_a: ShardTable, alpha_src_ext,
                                 table_b: ShardTable, stats_ext, *,
                                 negative_slope: float = 0.2):
    """Plain PyTorch version of the shard backward (every shard wrapper,
    (rs, H, F) parts): builds both tables' rows, then the plain backward's
    sums over them."""
    _check_shard(pair, table_a, alpha_src_ext, table_b, stats_ext)
    return _bwd_shard_ref(pair, table_a, alpha_src_ext, table_b, stats_ext, negative_slope)


def onepass_bwd_shard(pair: AttnSlabPair, table_a: ShardTable, alpha_src_ext,
                      table_b: ShardTable, stats_ext, *, negative_slope: float = 0.2):
    """One row shard's whole backward for a pair with bit planes (the band
    CSR by source): (dx (rs, H, F), dalpha_dst, dalpha_src (rs, H)), float32,
    from (rs, H, F) tables; counts ``onepass_bwd_shard.launches``."""
    if pair.t_ell is not None and table_a.own.device.type != "cpu":
        raise ValueError("the pair has t_ell, not the band CSR: use "
                         "slab_attention_bwd(_mh)_shard")
    return _run_shard(onepass_bwd_shard, pair, table_a, alpha_src_ext, table_b, stats_ext,
                      negative_slope)


onepass_bwd_shard.launches = 0


def slab_attention_bwd_shard(pair: AttnSlabPair, table_a: ShardTable, alpha_src_ext,
                             table_b: ShardTable, stats_ext, *, negative_slope: float = 0.2):
    """The single-head shard backward: tables of (rs, F) parts (tails packed
    with 1 and 4 head values), alpha_src_ext (rs + 2R,), stats_ext (rs + 2R,
    4); returns (dx (rs, F), dalpha_dst (rs,), dalpha_src (rs,)).  Pairs with
    bit planes go to :func:`onepass_bwd_shard`; counts
    ``slab_attention_bwd_shard.launches``."""
    args = (table_a.unsqueeze_heads(), alpha_src_ext[:, None], table_b.unsqueeze_heads(),
            stats_ext[:, None])
    if pair.t_ell is None:
        return _squeeze_heads(onepass_bwd_shard(pair, *args, negative_slope=negative_slope))
    return _squeeze_heads(_run_shard(slab_attention_bwd_shard, pair, *args, negative_slope))


slab_attention_bwd_shard.launches = 0


def slab_attention_bwd_mh_shard(pair: AttnSlabPair, table_a: ShardTable, alpha_src_ext,
                                table_b: ShardTable, stats_ext, *,
                                negative_slope: float = 0.2):
    """One row shard's whole multi-head backward from (rs, H, F) tables;
    pairs with bit planes go to :func:`onepass_bwd_shard`, H = 1 to
    :func:`slab_attention_bwd_shard`; counts
    ``slab_attention_bwd_mh_shard.launches``."""
    x = table_a.own
    heads = x.shape[1] if x.dim() == 3 else 0
    if heads > MAX_PACKED_HEADS:
        raise ValueError(f"slab_attention_bwd_mh_shard supports "
                         f"<={MAX_PACKED_HEADS} heads, got {heads}")
    args = (pair, table_a, alpha_src_ext, table_b, stats_ext)
    if pair.t_ell is None:
        return onepass_bwd_shard(*args, negative_slope=negative_slope)
    _check_shard(*args)
    if heads == 1:
        res = slab_attention_bwd_shard(pair, table_a.squeeze_heads(), alpha_src_ext[:, 0],
                                       table_b.squeeze_heads(), stats_ext[:, 0],
                                       negative_slope=negative_slope)
        return tuple(a[:, None] for a in res)
    return _run_shard(slab_attention_bwd_mh_shard, *args, negative_slope)


slab_attention_bwd_mh_shard.launches = 0


class _SlabAttention(torch.autograd.Function):
    """Forward: the fused attention kernel, keeping its stats.  Backward:
    t = sum(g * out, -1), then the backward kernel; dx in x's dtype and the
    alpha gradients in theirs, as the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, x, alpha_dst, alpha_src, pair, negative_slope, bwd_compute_dtype):
        out, m, s = slab_attention_spmm_mh(pair.fwd, x, alpha_dst, alpha_src,
                                           negative_slope=negative_slope,
                                           return_stats=True)
        ctx.save_for_backward(x, alpha_dst, alpha_src, out, m, s)
        ctx.pair, ctx.negative_slope = pair, negative_slope
        ctx.bwd_compute_dtype = bwd_compute_dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, alpha_dst, alpha_src, out, m, s = ctx.saved_tensors
        t = (g.float() * out).sum(-1)
        dx, dad, das = slab_attention_bwd_mh(
            ctx.pair, x, alpha_dst, alpha_src, m, s, t, g,
            negative_slope=ctx.negative_slope, compute_dtype=ctx.bwd_compute_dtype)
        return (dx.to(x.dtype), dad.to(alpha_dst.dtype), das.to(alpha_src.dtype),
                None, None, None)


def differentiable_slab_attention_mh(pair: AttnSlabPair, *,
                                     negative_slope: float = 0.2,
                                     bwd_compute_dtype=torch.float32):
    """f(x (N, H, F), alpha_dst (N, H), alpha_src (N, H)) -> (N, H, F)
    float32, differentiable in all three; H <= MAX_PACKED_HEADS for the
    backward.  ``bwd_compute_dtype`` bfloat16 rounds the backward's band
    operands (:func:`onepass_bwd`'s ``compute_dtype``); float32 is exact."""
    _check_compute(bwd_compute_dtype)

    def f(x, alpha_dst, alpha_src):
        return _SlabAttention.apply(x, alpha_dst, alpha_src, pair, negative_slope,
                                    bwd_compute_dtype)
    return f


def differentiable_slab_attention(pair: AttnSlabPair, *,
                                  negative_slope: float = 0.2,
                                  bwd_compute_dtype=torch.float32):
    """f(x (N, F), alpha_dst (N,), alpha_src (N,)) -> (N, F) float32: the
    single-head case of :func:`differentiable_slab_attention_mh`."""
    f_mh = differentiable_slab_attention_mh(pair, negative_slope=negative_slope,
                                            bwd_compute_dtype=bwd_compute_dtype)

    def f(x, alpha_dst, alpha_src):
        return f_mh(x[:, None], alpha_dst[:, None], alpha_src[:, None])[:, 0]
    return f
