"""FullBatchGraph: full-batch message passing over a whole graph.

Counterpart of ``cugraph_gnn_tpu/ops/full_batch.py``:

    fbg = FullBatchGraph.from_coo(src, dst, n, reorder="auto")
    x_g = fbg.to_graph_order(x)         # once, at load time
    h   = fbg.spmm(x_g, reduce="mean")  # slab kernels + fallback kernel
    a   = fbg.attention_spmm_mh(wx, alpha_dst, alpha_src)   # GAT
    out = fbg.to_input_order(h)         # once, at the output boundary

Pipeline: optional RCM reorder (``ops/reorder.py``) -> banded slab split
(``ops/kernels/slab_kernel.py``) -> the slab SpMM, differentiable: its
gradient runs the same kernels over the transposed graph.  The attention
methods run the fused attention kernels over the attention pair
(``ops/kernels/slab_attn_grad.py``), built from the graph-order CSR at
first use.  A graph whose band fraction stays below ``min_band_fraction``
keeps the plain PyTorch paths (``ops/spmm.py``, ``ops/sddmm.py``), as in
the JAX package.

Train in graph order: ``to_graph_order`` is meant for features and labels
once at load time, with node ids mapped through ``map_ids``.

``RelationalFullBatch`` is the full-batch R-GCN surface: one
``FullBatchGraph`` per relation, all on the union graph's node order, so one
graph-order ``x`` serves every relation's SpMM.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_grad import (
    MAX_PACKED_HEADS,
    AttnSlabPair,
    build_attention_slab_pair,
    differentiable_slab_attention,
    differentiable_slab_attention_mh,
)
from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import lrelu
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import build_slab_graph, slab_spmm
from cugraph_gnn_tpu_torch.ops.reorder import reorder_csr
from cugraph_gnn_tpu_torch.ops.sddmm import coo_edge_softmax
from cugraph_gnn_tpu_torch.ops.spmm import EllBuckets, ell_spmm, segment_spmm


class _SlabSpmm(torch.autograd.Function):
    """Forward: the slab SpMM over the graph.  Backward: ``g / degree`` for
    'mean' (the graph's total degree, not the transpose's), then the slab
    SpMM over the transposed graph with 'sum', cast to x's dtype.  Both
    include their fallback edges, so the gradient is exact for any graph."""

    @staticmethod
    def forward(ctx, x, fbg, reduce, compute_dtype):
        ctx.fbg, ctx.reduce, ctx.compute_dtype = fbg, reduce, compute_dtype
        ctx.x_dtype = x.dtype
        return slab_spmm(fbg.slab, x, reduce, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        fbg = ctx.fbg
        g = g.contiguous()
        if ctx.reduce == "mean":
            g = g / fbg.degrees.clamp(min=1)[:, None].to(g.dtype)
        gx = slab_spmm(fbg.slab_t, g, "sum", ctx.compute_dtype)
        return gx.to(ctx.x_dtype), None, None, None


class _NodeOrder:
    """The input-order <-> graph-order maps of a reordered graph, as device
    tensors cached per device."""

    def __init__(self, reordered):
        self._order = reordered
        self._on = {}

    @property
    def order(self) -> Optional[np.ndarray]:
        """(N,) graph-order -> input-order map (None if not reordered)."""
        return None if self._order is None else self._order.order

    @property
    def inv_order(self) -> Optional[np.ndarray]:
        return None if self._order is None else self._order.inv_order

    def _order_on(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._on:
            self._on[key] = torch.as_tensor(
                getattr(self._order, name).astype(np.int64), device=device)
        return self._on[key]

    def to_graph_order(self, x):
        if self._order is None:
            return x
        return x[self._order_on("order", x.device)]

    def to_input_order(self, x):
        if self._order is None:
            return x
        return x[self._order_on("inv_order", x.device)]

    def map_ids(self, ids):
        """Input-order node ids -> graph-order ids (-1 passes through)."""
        if self._order is None:
            return ids
        inv = self._order_on("inv_order", ids.device)
        return torch.where(ids >= 0, inv[ids.clamp(min=0).long()], -1).to(ids.dtype)


class FullBatchGraph(_NodeOrder):
    """See the module docstring.  reorder: 'rcm' | 'none' | 'auto' (RCM, kept
    only if it raises the band fraction); ``min_band_fraction`` gates the
    slab path.  Device tensors live on ``device`` (default: the card).
    ``build_seconds`` holds the host seconds of the builds: the graph
    (reorder included), its transpose and, once an attention method has
    run, the attention pair ("attention_pair")."""

    def __init__(self, indptr, indices, weights=None, *,
                 reorder: str = "auto", block_rows: int = 256,
                 max_k: int = 64, min_band_fraction: float = 0.5,
                 device=None):
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        n = len(indptr) - 1
        self.num_nodes = n
        if reorder not in ("rcm", "none", "auto"):
            raise ValueError(f"unknown reorder {reorder!r}")
        rg = None
        # candidates are built on the host and only the chosen one moves
        build = dict(block_rows=block_rows, max_k=max_k, device="cpu")
        if reorder in ("rcm", "auto"):
            rg = reorder_csr(indptr, indices)
            w_r = None if weights is None else np.asarray(weights)[rg.edge_perm]
            slab = build_slab_graph(rg.indptr, rg.indices, w_r, **build)
            if reorder == "auto":
                slab_i = build_slab_graph(indptr, indices, weights, **build)
                if slab.band_fraction <= slab_i.band_fraction:
                    rg, slab = None, slab_i
            if rg is not None:
                indptr, indices, weights = rg.indptr, rg.indices, w_r
        else:
            slab = build_slab_graph(indptr, indices, weights, **build)
        super().__init__(rg)
        self.slab = slab.to(self.device)
        self.band_fraction = self.slab.band_fraction
        self.use_slab = self.band_fraction >= min_band_fraction
        self._indptr = np.asarray(indptr, np.int64)
        self._indices = np.asarray(indices, np.int32)
        self._weights = None if weights is None else np.asarray(weights, np.float32)
        self._ell: Optional[EllBuckets] = None
        self._coo = None
        self.degrees = self.slab.degrees[:n]
        t1 = time.perf_counter()
        # The transpose of a banded graph is banded with the same bandwidth,
        # so d/dx (A @ x) = A^T @ g rides the same kernels.
        deg = self._indptr[1:] - self._indptr[:-1]
        rows = np.repeat(np.arange(n, dtype=np.int32), deg)
        ok = (self._indices >= 0) & (self._indices < n)
        t_indptr, t_indices, t_perm = _native.build_csr(self._indices[ok], rows[ok], n)
        t_w = None if weights is None else self._weights[ok][t_perm]
        self.slab_t = build_slab_graph(t_indptr, t_indices, t_w, block_rows=block_rows,
                                       max_k=max_k, device=self.device)
        self.build_seconds: Dict[str, float] = {
            "graph": t1 - t0, "transpose": time.perf_counter() - t1}
        self._block_rows, self._max_k = block_rows, max_k
        self._attn_pair: Optional[AttnSlabPair] = None

    # -- aggregation ------------------------------------------------------

    def spmm(self, x, reduce: str = "mean", *, compute_dtype=torch.float32):
        """out[r] = reduce over row r's neighbors of w * x[c]; x and out in
        graph order, differentiable in x."""
        if self.use_slab and reduce in ("sum", "mean"):
            return _SlabSpmm.apply(x.contiguous(), self, reduce, compute_dtype)
        if self._weights is None and reduce in ("sum", "mean", "max"):
            if self._ell is None:
                self._ell = EllBuckets(self._indptr, self._indices,
                                       device=self.device)
            return ell_spmm(self._ell, x, reduce=reduce)
        cols, rows, w = self._coo_arrays()
        return segment_spmm(x, cols, rows, self.num_nodes, reduce=reduce,
                            edge_weight=w)

    def _coo_arrays(self):
        """(cols, rows, weights) of the graph-order CSR as device tensors."""
        if self._coo is None:
            deg = self._indptr[1:] - self._indptr[:-1]
            rows = np.repeat(np.arange(self.num_nodes, dtype=np.int32), deg)
            self._coo = tuple(
                None if a is None else torch.as_tensor(a, device=self.device)
                for a in (self._indices, rows, self._weights))
        return self._coo

    # -- attention ----------------------------------------------------------

    @property
    def attention_pair(self) -> AttnSlabPair:
        """The attention pair of the graph-order CSR (unweighted), built on
        the host at first use; its seconds go to ``build_seconds``."""
        if self._attn_pair is None:
            t0 = time.perf_counter()
            self._attn_pair = build_attention_slab_pair(
                self._indptr, self._indices, block_rows=self._block_rows,
                max_k=self._max_k, device=self.device)
            self.build_seconds["attention_pair"] = time.perf_counter() - t0
        return self._attn_pair

    def attention_spmm_mh(self, x, alpha_dst, alpha_src, *,
                          negative_slope: float = 0.2):
        """Multi-head fused attention aggregate: x (N, H, F), alpha_dst /
        alpha_src (N, H) -> (N, H, F) float32, in graph order,
        differentiable in all three.  On the slab path all heads run in one
        kernel launch per direction, in head groups of MAX_PACKED_HEADS;
        off it, one plain single-head call per head."""
        heads = x.shape[1]
        if self.use_slab:
            if heads <= MAX_PACKED_HEADS:
                return differentiable_slab_attention_mh(
                    self.attention_pair, negative_slope=negative_slope)(x, alpha_dst, alpha_src)
            return torch.cat([
                self.attention_spmm_mh(
                    x[:, h0:h0 + MAX_PACKED_HEADS],
                    alpha_dst[:, h0:h0 + MAX_PACKED_HEADS],
                    alpha_src[:, h0:h0 + MAX_PACKED_HEADS],
                    negative_slope=negative_slope)
                for h0 in range(0, heads, MAX_PACKED_HEADS)], dim=1)
        return torch.stack([
            self.attention_spmm(x[:, h], alpha_dst[:, h], alpha_src[:, h],
                                negative_slope=negative_slope)
            for h in range(heads)], dim=1)

    def attention_spmm(self, x, alpha_dst, alpha_src, *,
                       negative_slope: float = 0.2):
        """Single-head attention aggregate: x (N, F), alpha_* (N,) ->
        (N, F) float32: the fused kernels on the slab path, else the plain
        COO chain (edge scores, ``coo_edge_softmax``, ``segment_spmm``)."""
        if self.use_slab:
            return differentiable_slab_attention(
                self.attention_pair, negative_slope=negative_slope)(x, alpha_dst, alpha_src)
        cols, rows, _ = self._coo_arrays()
        rows_l = rows.long()
        e = lrelu(alpha_dst[rows_l] + alpha_src[cols.clamp(min=0).long()],
                  negative_slope)
        p = coo_edge_softmax(e, rows, self.num_nodes)
        return segment_spmm(x.float(), cols, rows, self.num_nodes, reduce="sum",
                            edge_weight=p)

    @classmethod
    def from_coo(cls, src, dst, num_nodes: int, weights=None, **kw):
        """From COO edges src -> dst (aggregation at dst); keyword arguments
        as for the constructor, ``device`` included."""
        indptr, indices, perm = _native.build_csr(
            np.asarray(dst, np.int32), np.asarray(src, np.int32), num_nodes)
        w = None if weights is None else np.asarray(weights)[perm]
        return cls(indptr, indices, w, **kw)


def _band_share(src, dst, block_rows: int) -> float:
    """The share of edges with |src - dst| <= block_rows under an order (the
    slab keeps columns within one block radius of their row block)."""
    if len(src) == 0:
        return 0.0
    return float(np.mean(np.abs(src.astype(np.int64) - dst.astype(np.int64)) <= block_rows))


class RelationalFullBatch(_NodeOrder):
    """One ``FullBatchGraph`` per relation over one shared node order: the
    full-batch R-GCN surface, out = W_root x + sum_r W_r (A_r x), each A_r x
    one launch of the slab SpMM kernel (its gradient one launch over A_r's
    transpose).  Every relation is built on the union graph's RCM order
    (``reorder='auto'`` keeps it only if it raises the union's band share),
    so one graph-order ``x`` serves every relation.  Keyword arguments as
    ``FullBatchGraph``'s, ``device`` included."""

    def __init__(self, src, dst, edge_type, num_relations: int, num_nodes: int, *,
                 reorder: str = "auto", block_rows: int = 256, max_k: int = 64,
                 min_band_fraction: float = 0.5, device=None):
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        et = np.asarray(edge_type, np.int32)
        if not len(src) == len(dst) == len(et):
            raise ValueError("src, dst and edge_type lengths differ")
        if reorder not in ("rcm", "none", "auto"):
            raise ValueError(f"unknown reorder {reorder!r}")
        self.num_nodes = int(num_nodes)
        self.num_relations = int(num_relations)
        rg = None
        if reorder in ("rcm", "auto") and len(src):
            u_indptr, u_indices, _ = _native.build_csr(dst, src, num_nodes)
            cand = reorder_csr(u_indptr, u_indices)
            ns, nd = cand.inv_order[src], cand.inv_order[dst]
            if reorder == "rcm" or (_band_share(ns, nd, block_rows)
                                    > _band_share(src, dst, block_rows)):
                rg, src, dst = cand, ns, nd
        super().__init__(rg)
        self.graphs = [
            FullBatchGraph.from_coo(src[et == r], dst[et == r], num_nodes, reorder="none",
                                    block_rows=block_rows, max_k=max_k,
                                    min_band_fraction=min_band_fraction, device=device)
            for r in range(num_relations)]
        self.band_fraction = (float(np.mean([g.band_fraction for g in self.graphs]))
                              if self.graphs else 0.0)
