"""Fixed-fanout aggregation of sampled neighbor features, in plain PyTorch.

Counterpart of ``cugraph_gnn_tpu/ops/spmm.py::fanout_aggregate`` (the segment,
ELL and CSR SpMMs come with the full-batch slice).
"""

from __future__ import annotations

import torch


def fanout_aggregate(x_neigh, mask, reduce: str = "mean"):
    """Aggregate neighbor features over the fanout axis.

    x_neigh: (S, k, F) gathered neighbor features (padded rows arbitrary).
    mask:    (S, k) bool validity.
    reduce:  'sum' | 'mean' | 'max'; a row with no valid neighbor gives 0.
    Returns (S, F).
    """
    m = mask[..., None]
    if reduce == "sum":
        return torch.where(m, x_neigh, 0).sum(dim=1)
    if reduce == "mean":
        s = torch.where(m, x_neigh, 0).sum(dim=1)
        n = mask.sum(dim=1, keepdim=True).clamp(min=1)
        return s / n.to(s.dtype)
    if reduce == "max":
        neg = torch.finfo(x_neigh.dtype).min
        r = torch.where(m, x_neigh, neg).amax(dim=1)
        return torch.where(mask.any(dim=1, keepdim=True), r, 0)
    raise ValueError(f"unknown reduce {reduce!r}")
