"""CSR/COO graph structure utilities.

Counterpart of ``cugraph_gnn_tpu/ops/csr.py``: CSR construction is a stable
sort and a count, the self-loop insertion a shift of every edge by its row
index.  Tensors stay on the device of their inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CSR(NamedTuple):
    """CSR adjacency: ``indptr`` (N+1,), ``indices`` (E,); an edge's id is
    its position in ``indices``."""

    indptr: torch.Tensor
    indices: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]


def coo_to_csr(src, dst, num_nodes: int, sort_by: str = "src"):
    """CSR from COO tensors by a stable sort and a count.  Returns (csr,
    edge_perm), where ``edge_perm`` maps a CSR edge position to its COO
    position (int64), so that edge attributes follow with one gather."""
    src = torch.as_tensor(src)
    dst = torch.as_tensor(dst, device=src.device)
    key = src if sort_by == "src" else dst
    other = dst if sort_by == "src" else src
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key.long(), minlength=num_nodes)[:num_nodes]
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)
    return CSR(indptr=indptr, indices=other[order].to(torch.int32)), order


def coo_to_csr_np(src, dst, num_nodes: int, sort_by: str = "src"):
    """Host (numpy) CSR builder: ((indptr int64, indices), edge_perm)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    key = src if sort_by == "src" else dst
    other = dst if sort_by == "src" else src
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=num_nodes)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return (indptr, other[order]), order


def csr_add_self_loop(indptr, indices):
    """Insert a diagonal entry at the head of every row: the output has
    exactly N more edges."""
    indptr = torch.as_tensor(indptr)
    indices = torch.as_tensor(indices, device=indptr.device)
    n = indptr.shape[0] - 1
    e = indices.shape[0]
    dev = indptr.device
    new_indptr = indptr + torch.arange(n + 1, dtype=indptr.dtype, device=dev)
    row_of_edge = torch.searchsorted(
        indptr, torch.arange(e, dtype=indptr.dtype, device=dev), right=True) - 1
    new_pos = torch.arange(e, device=dev) + 1 + row_of_edge
    out = torch.zeros((e + n,), dtype=indices.dtype, device=dev)
    out[new_indptr[:-1].long()] = torch.arange(n, dtype=indices.dtype, device=dev)
    out[new_pos.long()] = indices
    return new_indptr, out


def edge_mask_valid(neighbors):
    """Mask for fixed-fanout neighbor blocks padded with -1."""
    return neighbors >= 0
