"""Graph convolution layers (torch.nn) over the sampled fixed-fanout layout.

Counterpart of ``cugraph_gnn_tpu/models/conv.py`` (``SAGEConv``'s sampled path;
the other convs and the full-batch paths come with later slices).

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

from cugraph_gnn_tpu_torch.ops.spmm import fanout_aggregate


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
