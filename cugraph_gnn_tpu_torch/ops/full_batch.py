"""FullBatchGraph: full-batch message passing over a whole graph.

Counterpart of ``cugraph_gnn_tpu/ops/full_batch.py`` (without the attention
methods, which come with the GAT slice):

    fbg = FullBatchGraph.from_coo(src, dst, n, reorder="auto")
    x_g = fbg.to_graph_order(x)         # once, at load time
    h   = fbg.spmm(x_g, reduce="mean")  # slab kernels + fallback kernel
    out = fbg.to_input_order(h)         # once, at the output boundary

Pipeline: optional RCM reorder (``ops/reorder.py``) -> banded slab split
(``ops/kernels/slab_kernel.py``) -> the slab SpMM, differentiable: its
gradient runs the same kernels over the transposed graph.  A graph whose
band fraction stays below ``min_band_fraction`` keeps the plain PyTorch
degree-bucketed ELL path (``ops/spmm.py``), as in the JAX package.

Train in graph order: ``to_graph_order`` is meant for features and labels
once at load time, with node ids mapped through ``map_ids``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import build_slab_graph, slab_spmm
from cugraph_gnn_tpu_torch.ops.reorder import reorder_csr
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


class FullBatchGraph:
    """See the module docstring.  reorder: 'rcm' | 'none' | 'auto' (RCM, kept
    only if it raises the band fraction); ``min_band_fraction`` gates the
    slab path.  Device tensors live on ``device`` (default: the card).
    ``build_seconds`` holds the host seconds of the two builds: the graph
    (reorder included) and its transpose."""

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
        self._order = None
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
                self._order = rg
                indptr, indices, weights = rg.indptr, rg.indices, w_r
        else:
            slab = build_slab_graph(indptr, indices, weights, **build)
        self.slab = slab.to(self.device)
        self.band_fraction = self.slab.band_fraction
        self.use_slab = self.band_fraction >= min_band_fraction
        self._indptr = np.asarray(indptr, np.int64)
        self._indices = np.asarray(indices, np.int32)
        self._weights = None if weights is None else np.asarray(weights, np.float32)
        self._ell: Optional[EllBuckets] = None
        self._coo = None
        self._order_t = {}
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

    # -- node-order mapping ---------------------------------------------

    @property
    def order(self) -> Optional[np.ndarray]:
        """(N,) graph-order -> input-order map (None if not reordered)."""
        return None if self._order is None else self._order.order

    @property
    def inv_order(self) -> Optional[np.ndarray]:
        return None if self._order is None else self._order.inv_order

    def _order_on(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._order_t:
            self._order_t[key] = torch.as_tensor(
                getattr(self._order, name).astype(np.int64), device=device)
        return self._order_t[key]

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
        if self._coo is None:
            deg = self._indptr[1:] - self._indptr[:-1]
            rows = np.repeat(np.arange(self.num_nodes, dtype=np.int32), deg)
            self._coo = tuple(
                None if a is None else torch.as_tensor(a, device=self.device)
                for a in (self._indices, rows, self._weights))
        cols, rows, w = self._coo
        return segment_spmm(x, cols, rows, self.num_nodes, reduce=reduce,
                            edge_weight=w)

    @classmethod
    def from_coo(cls, src, dst, num_nodes: int, weights=None, **kw):
        """From COO edges src -> dst (aggregation at dst); keyword arguments
        as for the constructor, ``device`` included."""
        indptr, indices, perm = _native.build_csr(
            np.asarray(dst, np.int32), np.asarray(src, np.int32), num_nodes)
        w = None if weights is None else np.asarray(weights)[perm]
        return cls(indptr, indices, w, **kw)
