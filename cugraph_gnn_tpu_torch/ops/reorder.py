"""Locality-improving node reordering (host-side preprocessing).

Counterpart of ``cugraph_gnn_tpu/ops/reorder.py``.  Reverse Cuthill-McKee
gives neighbors nearby ids, so that most edges fall in the band the slab
SpMM reads (``ops/kernels/slab_kernel.py``); on the H100 a narrow band also
means that neighboring rows' reads hit the same L2 lines.  Runs on the host
once per graph.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from cugraph_gnn_tpu_torch import _native


class ReorderedGraph(NamedTuple):
    """A relabeled CSR plus the maps to carry node and edge data across.

    order:      (N,) int32, order[new_id] = old_id: permute node data with
                ``x_new = x_old[order]``.
    inv_order:  (N,) int32, inv_order[old_id] = new_id: map external node
                ids into the new space.
    edge_perm:  (E,) int64, new edge position -> old edge position: permute
                edge data with ``w_new = w_old[edge_perm]``.
    """

    indptr: np.ndarray
    indices: np.ndarray
    order: np.ndarray
    inv_order: np.ndarray
    edge_perm: np.ndarray


def reorder_csr(indptr, indices, method: str = "rcm") -> ReorderedGraph:
    """Compute a locality order and relabel the CSR by it.

    method: 'rcm' (reverse Cuthill-McKee) or 'none' (identity).
    """
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    n = len(indptr) - 1
    if method == "none":
        order = np.arange(n, dtype=np.int32)
    elif method == "rcm":
        order = _native.rcm_order(indptr, indices)
    else:
        raise ValueError(f"unknown reorder method {method!r}")
    new_indptr, new_indices, edge_perm = _native.apply_order_csr(
        indptr, indices, order)
    inv = np.zeros(n, np.int32)
    inv[order] = np.arange(n, dtype=np.int32)
    return ReorderedGraph(indptr=new_indptr, indices=new_indices,
                          order=order, inv_order=inv, edge_perm=edge_perm)


def bandwidth_stats(indptr, indices, percentile: float = 95.0):
    """Per-edge |dst - src| distribution: mean, p50, p``percentile`` and max
    (-1 padded entries skipped)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    n = len(indptr) - 1
    deg = indptr[1:] - indptr[:-1]
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    ok = indices >= 0
    d = np.abs(indices.astype(np.int64) - rows)[ok]
    if len(d) == 0:
        return {"mean": 0.0, "p50": 0, "p95": 0, "max": 0}
    return {
        "mean": float(d.mean()),
        "p50": int(np.percentile(d, 50)),
        "p95": int(np.percentile(d, percentile)),
        "max": int(d.max()),
    }
