"""Graph convolution layers (torch.nn).

Counterpart of ``cugraph_gnn_tpu/models/conv.py``: ``SAGEConv`` and
``GCNConv``, each with the sampled path (``forward`` over the fixed-fanout
layout), the full-batch COO path (``full``) and the full-batch path through a
``FullBatchGraph`` (``full_graph``, the slab kernels).  The other convs come
with later slices.

``dtype`` computes as flax's ``Dense(dtype=...)`` does: parameters stay float32
and are cast, together with the input, at each call, and the bias is added
after the product, in ``dtype``.  Autocast is not used, so that both
frameworks round at the same places.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from cugraph_gnn_tpu_torch.ops.spmm import fanout_aggregate, segment_spmm


def dense(lin: nn.Linear, x, dtype: Optional[torch.dtype]):
    """``lin(x)`` computed in ``dtype``; with None, in the promotion of the
    input's and the weight's dtypes (flax ``Dense`` semantics)."""
    dt = dtype or torch.promote_types(x.dtype, lin.weight.dtype)
    y = F.linear(x.to(dt), lin.weight.to(dt))
    if lin.bias is not None:
        y = y + lin.bias.to(dt)
    return y


class SAGEConv(nn.Module):
    """GraphSAGE convolution (mean/max/sum aggregator).

    h = W_self x_dst + b + W_neigh agg_{j in N(dst)} x_j   (PyG semantics)
    """

    def __init__(self, in_features: int, out_features: int, aggr: str = "mean",
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.aggr = aggr
        self.dtype = dtype
        self.lin_self = nn.Linear(in_features, out_features, bias=bias,
                                  device=device)
        self.lin_neigh = nn.Linear(in_features, out_features, bias=False,
                                   device=device)

    def forward(self, x_dst, x_neigh, mask):
        agg = fanout_aggregate(x_neigh, mask, self.aggr)
        return (dense(self.lin_self, x_dst, self.dtype)
                + dense(self.lin_neigh, agg, self.dtype))

    def full(self, x, src, dst, num_nodes: int):
        """Full batch over COO edges src -> dst (-1 padded)."""
        agg = segment_spmm(x, src, dst, num_nodes, reduce=self.aggr)
        return (dense(self.lin_self, x[:num_nodes], self.dtype)
                + dense(self.lin_neigh, agg, self.dtype))

    def full_graph(self, x, fbg):
        """Full batch through ``fbg`` (an ``ops.full_batch.FullBatchGraph``);
        x in fbg's graph order."""
        agg = fbg.spmm(x, reduce=self.aggr).to(x.dtype)
        return (dense(self.lin_self, x, self.dtype)
                + dense(self.lin_neigh, agg, self.dtype))


class GCNConv(nn.Module):
    """GCN convolution with symmetric normalization (self-loops added by
    default).

    The sampled path computes the exact normalization from the raw global
    in-degrees ``deg_dst`` (B,) and ``deg_neigh`` (B, K) when both are
    given, else the mean-aggregation minibatch approximation.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 add_self_loops: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.add_self_loops = add_self_loops
        self.dtype = dtype
        self.lin = nn.Linear(in_features, out_features, bias=bias, device=device)

    def forward(self, x_dst, x_neigh, mask, deg_dst=None, deg_neigh=None):
        if deg_dst is not None and deg_neigh is not None:
            inc = 1.0 if self.add_self_loops else 0.0
            dd = (deg_dst + inc).clamp(min=1).to(x_neigh.dtype)
            dn = (deg_neigh + inc).clamp(min=1).to(x_neigh.dtype)
            w = torch.rsqrt(dd)[:, None] * torch.rsqrt(dn)
            agg = (x_neigh * torch.where(mask, w, 0)[..., None]).sum(dim=1)
            if self.add_self_loops:
                agg = agg + x_dst / dd[:, None]
        else:
            agg = fanout_aggregate(x_neigh, mask, "mean")
            if self.add_self_loops:
                n = mask.sum(dim=1).clamp(min=1)[:, None]
                agg = (agg * n + x_dst) / (n + 1).to(agg.dtype)
        return dense(self.lin, agg, self.dtype)

    def full(self, x, src, dst, num_nodes: int):
        """Full batch over COO edges src -> dst (-1 padded)."""
        valid = (src >= 0) & (dst >= 0)
        ones = valid.to(x.dtype)
        safe_dst = torch.where(valid, dst, num_nodes).long()
        deg = ones.new_zeros(num_nodes + 1).index_add(0, safe_dst, ones)[:num_nodes]
        if self.add_self_loops:
            deg = deg + 1
        dinv = torch.rsqrt(deg.clamp(min=1))
        w = torch.where(valid, dinv[torch.where(valid, src, 0).long()]
                        * dinv[torch.where(valid, dst, 0).long()], 0.0)
        agg = segment_spmm(x, src, dst, num_nodes, reduce="sum", edge_weight=w)
        if self.add_self_loops:
            agg = agg + x[:num_nodes] * (dinv * dinv)[:, None]
        return dense(self.lin, agg, self.dtype)

    def full_graph(self, x, fbg):
        """Full batch through ``fbg``, x in its graph order.  The symmetric
        normalization factors through the unweighted aggregate,
        D^-1/2 A D^-1/2 x = dinv * A(dinv * x), so the slab kernels run
        without edge weights."""
        deg = fbg.degrees.float()
        if self.add_self_loops:
            deg = deg + 1
        dinv = torch.rsqrt(deg.clamp(min=1))[:, None].to(x.dtype)
        agg = fbg.spmm(x * dinv, reduce="sum").to(x.dtype) * dinv
        if self.add_self_loops:
            agg = agg + x * (dinv * dinv)
        return dense(self.lin, agg, self.dtype)
