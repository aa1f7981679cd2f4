"""Model zoo over sampled multihop batches and full graphs (torch.nn).

Counterpart of ``cugraph_gnn_tpu/models/zoo.py``: ``MultihopModel`` (the
sampled forward, ``full`` and ``full_graph``, with dropout between layers
and, in the sampled forward, degree inputs for ``GCNConv``), ``GraphSAGE``,
``GCN``, ``GIN`` and ``GAT``; and ``RGCN`` over per-relation blocks
(``forward``), a ``HeteroMultihopBatch`` (``batch_call``) or whole graphs.

Dropout is flax's: at ``train=True`` each entry is kept with probability
1 - p and scaled by 1 / (1 - p), the keep mask drawn from the ``generator``
the caller passes (as flax's ``apply`` takes a dropout key); at
``train=False`` nothing is drawn.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.models.conv import GATConv, GCNConv, GINConv, RGCNConv, SAGEConv
from cugraph_gnn_tpu_torch.sampler.output import MultihopBatch, shard_gather, shard_prefix


class MultihopModel(nn.Module):
    """Runs ``convs`` input-side first over a MultihopBatch.  Activations
    shrink level by level; levels[l] is a prefix of levels[l+1], so the
    target rows are a slice.  ``dropout``: the drop probability after each
    hidden layer's ReLU."""

    def __init__(self, convs, dropout: float = 0.0):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.dropout = float(dropout)

    def _hidden(self, h, train: bool, generator):
        h = torch.relu(h)
        if self.dropout <= 0 or not train:
            return h
        if generator is None:
            raise ValueError("dropout at train=True draws its mask from a generator: "
                             "pass generator=")
        keep_prob = 1.0 - self.dropout
        keep = torch.rand(h.shape, generator=generator, device=h.device) < keep_prob
        return torch.where(keep, h / keep_prob, 0)

    def forward(self, x_input, batch: MultihopBatch, *, train: bool = False,
                deg_input=None, generator: Optional[torch.Generator] = None):
        """deg_input: optional (S_L,) raw global in-degrees aligned with the
        rows of ``x_input``; ``GCNConv`` layers then compute the exact
        symmetric normalization instead of the mean approximation."""
        h = x_input
        d = None if deg_input is None else deg_input.reshape(-1, 1).float()
        num_hops = batch.num_hops
        if num_hops != len(self.convs):
            raise ValueError(f"batch has {num_hops} hops, model has "
                             f"{len(self.convs)} layers")
        for li in range(num_hops - 1, -1, -1):
            conv = self.convs[num_hops - 1 - li]
            x_dst = batch.dst_activations(h, li)
            x_neigh = batch.gather_neighbors(h, li)
            mask = batch.hops[li].mask
            if d is not None and isinstance(conv, GCNConv):
                d_dst = batch.dst_activations(d, li)
                h = conv(x_dst, x_neigh, mask, d_dst[:, 0],
                         batch.gather_neighbors(d, li)[..., 0])
                d = d_dst
            else:
                if d is not None:
                    d = batch.dst_activations(d, li)
                h = conv(x_dst, x_neigh, mask)
            if li != 0:
                h = self._hidden(h, train, generator)
        return h

    def full(self, x, src, dst, num_nodes: int, *, train: bool = False,
             generator: Optional[torch.Generator] = None):
        """Full batch over COO edges src -> dst."""
        h = x
        for i, conv in enumerate(self.convs):
            h = conv.full(h, src, dst, num_nodes)
            if i != len(self.convs) - 1:
                h = self._hidden(h, train, generator)
        return h

    def full_graph(self, x, fbg, *, train: bool = False,
                   generator: Optional[torch.Generator] = None):
        """Full batch through ``fbg`` (an ``ops.full_batch.FullBatchGraph``);
        x in its graph order."""
        h = x
        for i, conv in enumerate(self.convs):
            h = conv.full_graph(h, fbg)
            if i != len(self.convs) - 1:
                h = self._hidden(h, train, generator)
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
                 dropout: float = 0.0, device=None):
        dev = resolve_device(device)
        dims = _dims(in_features, hidden_features, out_features, num_layers)
        super().__init__([
            SAGEConv(dims[i], dims[i + 1], aggr=aggr, dtype=dtype, device=dev)
            for i in range(num_layers)], dropout)


class GCN(MultihopModel):
    """``num_layers`` GCNConvs: in -> hidden -> ... -> out.  Layer i is
    ``convs[i]`` (flax's ``conv_<i>``).  Built on ``device`` (default: the
    card)."""

    def __init__(self, in_features: int, hidden_features: int = 256,
                 out_features: int = 64, num_layers: int = 2,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.0,
                 device=None):
        dev = resolve_device(device)
        dims = _dims(in_features, hidden_features, out_features, num_layers)
        super().__init__([
            GCNConv(dims[i], dims[i + 1], dtype=dtype, device=dev)
            for i in range(num_layers)], dropout)


class GIN(MultihopModel):
    """``num_layers`` GINConvs: in -> hidden -> ... -> out, each MLP's
    hidden width ``hidden_features``.  Layer i is ``convs[i]`` (flax's
    ``conv_<i>``).  Built on ``device`` (default: the card)."""

    def __init__(self, in_features: int, hidden_features: int = 256,
                 out_features: int = 64, num_layers: int = 2,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.0,
                 device=None):
        dev = resolve_device(device)
        dims = _dims(in_features, hidden_features, out_features, num_layers)
        super().__init__([
            GINConv(dims[i], dims[i + 1], hidden_features=hidden_features,
                    dtype=dtype, device=dev)
            for i in range(num_layers)], dropout)


class GAT(MultihopModel):
    """``num_layers`` GATConvs: the hidden layers have ``heads`` heads of
    hidden_features // heads features each, concatenated; the last has one
    head of ``out_features``.  The convs compute in the promotion of the
    input's and the parameters' dtypes (flax ``Dense(dtype=None)``, as the
    JAX package's GAT builds them).  Layer i is ``convs[i]`` (flax's
    ``conv_<i>``).  Built on ``device`` (default: the card)."""

    def __init__(self, in_features: int, hidden_features: int = 256,
                 out_features: int = 64, num_layers: int = 2, heads: int = 4,
                 dropout: float = 0.0, device=None):
        dev = resolve_device(device)
        convs, width = [], in_features
        for i in range(num_layers):
            last = i == num_layers - 1
            f = out_features if last else hidden_features // heads
            h = 1 if last else heads
            convs.append(GATConv(width, f, heads=h, concat=not last, device=dev))
            width = h * f
        super().__init__(convs, dropout)


class RGCN(nn.Module):
    """``num_layers`` RGCNConvs over ``num_relations`` relations: in -> hidden
    -> ... -> out, ReLU between.  Layer i is ``convs[i]`` (flax's
    ``conv_<i>``).  The convs compute in the promotion of the input's and the
    parameters' dtypes, as the JAX model's do.  Built on ``device`` (default:
    the card)."""

    def __init__(self, in_features: int, num_relations: int = 2, hidden_features: int = 64,
                 out_features: int = 16, num_layers: int = 2, device=None):
        super().__init__()
        dev = resolve_device(device)
        dims = _dims(in_features, hidden_features, out_features, num_layers)
        self.convs = nn.ModuleList([
            RGCNConv(dims[i], dims[i + 1], num_relations, device=dev)
            for i in range(num_layers)])

    def _layers(self, h, layer):
        for i, conv in enumerate(self.convs):
            h = layer(conv, i, h)
            if i != len(self.convs) - 1:
                h = torch.relu(h)
        return h

    def forward(self, x_input, rel_batches, num_shards: int = 1):
        """rel_batches: per layer (input side first, as the convs), per
        relation (neigh_local, mask) or None; the target count comes from the
        blocks' shapes.  ``num_shards``: blocks per level (a flattened
        disjoint batch)."""
        def layer(conv, i, h):
            blocks = rel_batches[i]
            s_l = next(b[0].shape[0] for b in blocks if b is not None)
            return conv(shard_prefix(h, s_l, num_shards),
                        [None if b is None else (shard_gather(h, b[0], num_shards), b[1])
                         for b in blocks])
        return self._layers(x_input, layer)

    def batch_call(self, x_input, batch, etype_names):
        """Forward over a ``HeteroMultihopBatch``: neighbor activations by
        ``batch.gather_neighbors`` (contiguous slices in the static layout),
        relations in ``etype_names`` order, through ``RGCNConv.typed_call``
        (typed layout entries carry their segment plan)."""
        def layer(conv, i, h):
            hop_index = batch.num_hops - 1 - i
            hop = batch.hops[hop_index]
            entries = {e[0]: e for e in (batch.layouts[hop_index] if batch.layouts else ())}
            blocks = [None if name not in hop else
                      (batch.gather_neighbors(h, hop_index, name), hop[name].mask)
                      + tuple(entries.get(name, ())[3:])
                      for name in etype_names]
            return conv.typed_call(batch.dst_activations(h, hop_index), blocks)
        return self._layers(x_input, layer)

    def full(self, x, src, dst, edge_type, num_nodes: int):
        """Full batch over COO edges src -> dst with a relation per edge."""
        return self._layers(x, lambda conv, i, h: conv.full(h, src, dst, edge_type,
                                                            num_nodes))

    def full_graph(self, x, rfb, *, train: bool = False):
        """Full batch through a ``RelationalFullBatch``; x in its graph order.
        ``train`` changes nothing (R-GCN has no dropout), as in the JAX
        package's ``RGCN.full_graph``."""
        return self._layers(x, lambda conv, i, h: conv.full_graph(h, rfb))
