"""Graph convolution layers (torch.nn).

Counterpart of ``cugraph_gnn_tpu/models/conv.py``: ``SAGEConv``,
``GCNConv`` and ``GATConv``, each with the sampled path (``forward`` over the
fixed-fanout layout), the full-batch COO path (``full``) and the full-batch
path through a ``FullBatchGraph`` (``full_graph``, the slab kernels).  The
other convs come with later slices.

``dtype`` computes as flax's ``Dense(dtype=...)`` does: parameters stay float32
and are cast, together with the input, at each call, and the bias is added
after the product, in ``dtype``.  Autocast is not used, so that both
frameworks round at the same places.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from cugraph_gnn_tpu_torch.ops.sddmm import coo_edge_softmax, fanout_attention_softmax
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


class GATConv(nn.Module):
    """Graph attention (GATv1) with multi-head attention (PyG GATConv
    scoring): per head, e = leakyrelu(a_dst . W x_dst + a_src . W x_src),
    softmax over each destination's edges, then the weighted sum of W x_src;
    heads concatenated (``concat``) or averaged, then the bias.

    Parameters as flax's: ``lin`` (no bias; heads * out_features outputs),
    ``att_src`` and ``att_dst`` (1, heads, out_features), ``bias``
    (heads * out_features with ``concat``, else out_features).
    """

    def __init__(self, in_features: int, out_features: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.heads, self.features = heads, out_features
        self.concat, self.negative_slope, self.dtype = concat, negative_slope, dtype
        self.lin = nn.Linear(in_features, heads * out_features, bias=False,
                             device=device)
        # flax glorot_uniform on (1, H, F): fan_in H, fan_out F
        limit = math.sqrt(6.0 / (heads + out_features))
        self.att_src = nn.Parameter(torch.empty((1, heads, out_features), device=device)
                                    .uniform_(-limit, limit))
        self.att_dst = nn.Parameter(torch.empty((1, heads, out_features), device=device)
                                    .uniform_(-limit, limit))
        self.bias = None
        if bias:
            width = heads * out_features if concat else out_features
            self.bias = nn.Parameter(torch.zeros(width, device=device))

    def _out(self, agg):
        # agg: (S, H, F)
        out = agg.reshape(agg.shape[0], -1) if self.concat else agg.mean(dim=1)
        return out if self.bias is None else out + self.bias

    def _project(self, x):
        """W x as (..., H, F) and its two attention scores (..., H)."""
        wx = dense(self.lin, x, self.dtype)
        wx = wx.reshape(*wx.shape[:-1], self.heads, self.features)
        return (wx, (wx * self.att_dst[0]).sum(-1), (wx * self.att_src[0]).sum(-1))

    def forward(self, x_dst, x_neigh, mask):
        s, k, _ = x_neigh.shape
        h = self.heads
        wd, a_d, _ = self._project(x_dst)                          # (S, H, F), (S, H)
        wn, _, a_n = self._project(x_neigh)                        # (S, k, H, F), (S, k, H)
        e = F.leaky_relu(a_d[:, None, :] + a_n, self.negative_slope)
        e = torch.where(mask[..., None], e, -torch.inf)
        alpha = fanout_attention_softmax(
            e.permute(0, 2, 1).reshape(s * h, k),
            mask.repeat_interleave(h, dim=0)).reshape(s, h, k).permute(0, 2, 1)
        agg = torch.einsum("skh,skhf->shf", alpha.float(), wn.float()).to(wn.dtype)
        return self._out(agg)

    def full(self, x, src, dst, num_nodes: int):
        """Full batch over COO edges src -> dst (-1 padded), one plain
        segment softmax and SpMM per head."""
        wx, a_d, a_n = self._project(x)
        valid = (src >= 0) & (dst >= 0)
        s_safe = torch.where(valid, src, 0).long()
        d_safe = torch.where(valid, dst, 0).long()
        e = F.leaky_relu(a_d[d_safe] + a_n[s_safe], self.negative_slope)   # (E, H)
        d_soft = torch.where(valid, dst, -1)
        agg = torch.stack([
            segment_spmm(wx[:, head], src, dst, num_nodes, reduce="sum",
                         edge_weight=coo_edge_softmax(
                             torch.where(valid, e[:, head], -torch.inf), d_soft,
                             num_nodes))
            for head in range(self.heads)], dim=1)
        return self._out(agg)

    def full_graph(self, x, fbg):
        """Full batch through ``fbg``, x in its graph order: the fused
        attention kernels over all heads, forward and backward."""
        wx, a_d, a_n = self._project(x)
        agg = fbg.attention_spmm_mh(wx, a_d.float(), a_n.float(),
                                    negative_slope=self.negative_slope).to(wx.dtype)
        return self._out(agg)
