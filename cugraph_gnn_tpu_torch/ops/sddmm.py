"""SDDMM: sampled dense-dense products on graph edges (attention scores), in
plain PyTorch.

Counterpart of ``cugraph_gnn_tpu/ops/sddmm.py``, which leaves these to XLA:
fixed-fanout (S, k) blocks for sampled training, COO for full batch.
"""

from __future__ import annotations

import torch


def fanout_sddmm(x_dst, x_neigh, mask):
    """Edge scores e[s, j] = <x_dst[s], x_neigh[s, j]> for fixed-fanout
    neighbor blocks.  x_dst: (S, F); x_neigh: (S, k, F); mask: (S, k).
    Returns (S, k) float32 with -inf on padding (softmax-ready)."""
    e = torch.einsum("sf,skf->sk", x_dst.float(), x_neigh.float())
    return torch.where(mask, e, -torch.inf)


def fanout_attention_softmax(scores, mask):
    """Masked softmax over the fanout axis; rows with no valid neighbor get
    all-zero weights."""
    m = torch.where(mask, scores, -torch.inf).amax(dim=1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0)
    p = torch.where(mask, torch.exp(scores - m), 0)
    z = p.sum(dim=1, keepdim=True)
    return p / z.clamp(min=1e-16)


def coo_sddmm(x_src, x_dst, src, dst):
    """Edge scores e_i = <x_src[src_i], x_dst[dst_i]> for COO edges; -1
    entries are padding -> score 0."""
    valid = (src >= 0) & (dst >= 0)
    a = x_src[torch.where(valid, src, 0).long()]
    b = x_dst[torch.where(valid, dst, 0).long()]
    return torch.where(valid, (a * b).sum(dim=-1), 0)


def coo_edge_softmax(scores, dst, num_nodes: int):
    """Per-destination softmax over COO edge scores (segment softmax).
    scores, dst: (E,); dst -1 for padding (weight 0)."""
    valid = dst >= 0
    d = torch.where(valid, dst, num_nodes).long()
    seg = scores.new_full((num_nodes + 1,), -torch.inf)
    seg_max = seg.scatter_reduce(0, d, torch.where(valid, scores, -torch.inf), "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0)
    p = torch.where(valid, torch.exp(scores - seg_max[d]), 0)
    z = torch.zeros_like(seg).index_add(0, d, p)
    return p / z[d].clamp(min=1e-16)
