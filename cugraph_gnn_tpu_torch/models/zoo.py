"""Model zoo over sampled multihop batches and full graphs (torch.nn).

Counterpart of ``cugraph_gnn_tpu/models/zoo.py``: ``MultihopModel`` (the
sampled forward, ``full`` and ``full_graph``), ``GraphSAGE``, ``GCN`` and
``GAT``.
Dropout, degree inputs and the other models come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.models.conv import GATConv, GCNConv, SAGEConv
from cugraph_gnn_tpu_torch.sampler.output import MultihopBatch


class MultihopModel(nn.Module):
    """Runs ``convs`` input-side first over a MultihopBatch.  Activations
    shrink level by level; levels[l] is a prefix of levels[l+1], so the
    target rows are a slice."""

    def __init__(self, convs):
        super().__init__()
        self.convs = nn.ModuleList(convs)

    def forward(self, x_input, batch: MultihopBatch):
        h = x_input
        num_hops = batch.num_hops
        if num_hops != len(self.convs):
            raise ValueError(f"batch has {num_hops} hops, model has "
                             f"{len(self.convs)} layers")
        for li in range(num_hops - 1, -1, -1):
            conv = self.convs[num_hops - 1 - li]
            h = conv(batch.dst_activations(h, li),
                     batch.gather_neighbors(h, li), batch.hops[li].mask)
            if li != 0:
                h = torch.relu(h)
        return h

    def full(self, x, src, dst, num_nodes: int):
        """Full batch over COO edges src -> dst."""
        h = x
        for i, conv in enumerate(self.convs):
            h = conv.full(h, src, dst, num_nodes)
            if i != len(self.convs) - 1:
                h = torch.relu(h)
        return h

    def full_graph(self, x, fbg):
        """Full batch through ``fbg`` (an ``ops.full_batch.FullBatchGraph``);
        x in its graph order."""
        h = x
        for i, conv in enumerate(self.convs):
            h = conv.full_graph(h, fbg)
            if i != len(self.convs) - 1:
                h = torch.relu(h)
        return h


def _dims(in_features, hidden_features, out_features, num_layers):
    return [in_features] + [hidden_features] * (num_layers - 1) + [out_features]


class GraphSAGE(MultihopModel):
    """``num_layers`` SAGEConvs: in -> hidden -> ... -> out.  Layer i is
    ``convs[i]`` (flax's ``conv_<i>``).  Built on ``device`` (default: the
    card)."""

    def __init__(self, in_features: int, hidden_features: int = 256,
                 out_features: int = 64, num_layers: int = 2,
                 aggr: str = "mean", dtype: Optional[torch.dtype] = None,
                 device=None):
        dev = resolve_device(device)
        dims = _dims(in_features, hidden_features, out_features, num_layers)
        super().__init__([
            SAGEConv(dims[i], dims[i + 1], aggr=aggr, dtype=dtype, device=dev)
            for i in range(num_layers)])


class GCN(MultihopModel):
    """``num_layers`` GCNConvs: in -> hidden -> ... -> out.  Layer i is
    ``convs[i]`` (flax's ``conv_<i>``).  Built on ``device`` (default: the
    card)."""

    def __init__(self, in_features: int, hidden_features: int = 256,
                 out_features: int = 64, num_layers: int = 2,
                 dtype: Optional[torch.dtype] = None, device=None):
        dev = resolve_device(device)
        dims = _dims(in_features, hidden_features, out_features, num_layers)
        super().__init__([
            GCNConv(dims[i], dims[i + 1], dtype=dtype, device=dev)
            for i in range(num_layers)])


class GAT(MultihopModel):
    """``num_layers`` GATConvs: the hidden layers have ``heads`` heads of
    hidden_features // heads features each, concatenated; the last has one
    head of ``out_features``.  The convs compute in the promotion of the
    input's and the parameters' dtypes (flax ``Dense(dtype=None)``, as the
    JAX package's GAT builds them).  Layer i is ``convs[i]`` (flax's
    ``conv_<i>``).  Built on ``device`` (default: the card)."""

    def __init__(self, in_features: int, hidden_features: int = 256,
                 out_features: int = 64, num_layers: int = 2, heads: int = 4,
                 device=None):
        dev = resolve_device(device)
        convs, width = [], in_features
        for i in range(num_layers):
            last = i == num_layers - 1
            f = out_features if last else hidden_features // heads
            h = 1 if last else heads
            convs.append(GATConv(width, f, heads=h, concat=not last, device=dev))
            width = h * f
        super().__init__(convs)
