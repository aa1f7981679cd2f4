"""NodeLoader / NeighborLoader: seed-batched sampling loaders.

Counterpart of ``cugraph_gnn_tpu/loader/node_loader.py``: the input nodes
are shuffled per epoch (numpy's ``default_rng(epoch + 12345)``, as in JAX),
cut into fixed-size batches (the last one padded with -1 seeds, or dropped
with ``drop_last``), sampled by a sampler built from the graph store
(uniform, weighted with ``weight_attr``, temporal with ``time_attr`` and
per-seed ``input_time``, optionally ``disjoint``), and joined with their
features and labels from the feature store.  The draws come from a
``torch.Generator`` seeded with ``seed``, which every batch advances.

Hetero graphs (several node or edge types) sample through a
``HeteroNeighborSampler``.  Typed input nodes ``(node_type, ids)`` take
type-local ids, shifted into the global id space by the type's offset; the
labels are read at the de-offset ids of the type's ``y``.  The features are
a dict by node type: each type's rows at the slots of its nodes, zero rows
elsewhere.  With ``dedup=False`` and typed input (untimed, not disjoint),
each edge type expands only its destination type's level positions (typed
target segments).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from cugraph_gnn_tpu_torch.data.feature_store import FeatureStore
from cugraph_gnn_tpu_torch.data.graph_store import GraphStore, _host, edge_type_str
from cugraph_gnn_tpu_torch.sampler.disjoint import DisjointNeighborSampler
from cugraph_gnn_tpu_torch.sampler.hetero import HeteroNeighborSampler
from cugraph_gnn_tpu_torch.sampler.heuristics import (
    resolve_feature_dim,
    resolve_max_unique_per_hop,
)
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import NeighborSampler
from cugraph_gnn_tpu_torch.sampler.output import MultihopBatch


@dataclasses.dataclass
class NodeBatch:
    """One sampled training batch."""

    sample: MultihopBatch           # DisjointBatch with disjoint=True; HeteroMultihopBatch hetero
    x: Optional[object]             # (S_L, F) features of sample.input_nodes ((B, cap, F)
                                    # disjoint); hetero: a dict by node type
    y: Optional[torch.Tensor]       # (B,) labels of the seeds
    seeds: torch.Tensor             # (B,) int32 global seed ids, -1 padded
    input_id: torch.Tensor          # (B,) int64 positions in input_nodes, -1 padded
    batch_size: int

    @property
    def num_valid(self):
        return self.sample.seed_count


class NodeLoader:
    """Shuffling and fixed-size seed batches over ``sampler``; the batches
    live on the graph store's device."""

    def __init__(self, data: Tuple[FeatureStore, GraphStore], sampler, input_nodes=None,
                 batch_size: int = 512, shuffle: bool = False, drop_last: bool = False,
                 x_attr: str = "x", y_attr: str = "y", input_time=None, seed: int = 0):
        self.feature_store, self.graph_store = data
        self.sampler = sampler
        if input_nodes is None:
            input_nodes = np.arange(self.graph_store.num_nodes())
        self.input_type = None
        if isinstance(input_nodes, tuple):       # PyG's (node_type, type-local ids)
            self.input_type, input_nodes = input_nodes
            input_nodes = _host(input_nodes) + self.graph_store.node_offset(self.input_type)
        self.input_nodes = _host(input_nodes).astype(np.int64)
        if isinstance(input_time, torch.Tensor):
            input_time = input_time.cpu().numpy()
        self.input_time = None if input_time is None else np.asarray(input_time)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.x_attr = x_attr
        self.y_attr = y_attr
        self.device = self.graph_store.device
        self._epoch = 0
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    def __len__(self):
        n = len(self.input_nodes)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.input_nodes))
        if self.shuffle:
            np.random.default_rng(self._epoch + 12345).shuffle(order)
        return order

    def __iter__(self) -> Iterator[NodeBatch]:
        order = self._epoch_order()
        self._epoch += 1
        b = self.batch_size
        for i in range(len(self)):
            sel = order[i * b:(i + 1) * b]
            input_id = np.full((b,), -1, np.int64)
            input_id[:len(sel)] = sel
            seeds = np.full((b,), -1, np.int32)
            seeds[:len(sel)] = self.input_nodes[sel]
            seeds_t = torch.as_tensor(seeds, device=self.device)
            kw = {}
            if self.input_time is not None:     # pads at time 0, as in JAX
                t = np.zeros((b,), self.input_time.dtype)
                t[:len(sel)] = self.input_time[sel]
                kw["node_times"] = torch.as_tensor(t, device=self.device)
            sample = self.sampler.sample(seeds_t, generator=self._generator, **kw)
            yield NodeBatch(sample=sample,
                            x=gather_node_features(self.feature_store, self.graph_store,
                                                   self.x_attr, sample.input_nodes),
                            y=self._gather_y(seeds_t), seeds=seeds_t,
                            input_id=torch.as_tensor(input_id, device=self.device),
                            batch_size=b)

    def _gather_y(self, seeds):
        key = ("", self.y_attr) if self.input_type is None else (self.input_type, self.y_attr)
        if key not in self.feature_store:
            return None
        if self.input_type is not None:
            # the type's labels are indexed by type-local ids; pads stay -1
            off = self.graph_store.node_offset(self.input_type)
            seeds = torch.where(seeds >= 0, seeds - off, -1)
        return self.feature_store.get_tensor(*key, ids=seeds)


def _rows(feature_store, group, x_attr, ids):
    """One gather of ``ids`` (any shape) from a stored table; rows in ids'
    shape."""
    rows = feature_store.get_tensor(group, x_attr, ids=ids.reshape(-1))
    return rows.reshape(*ids.shape, *rows.shape[1:])


def gather_node_features(feature_store, graph_store, x_attr, input_nodes):
    """The features of a sampled node set (zero rows for -1 slots; (B, cap)
    disjoint ids give (B, cap, F)), or None when no group has ``x_attr``.
    Homogeneous: one gather.  Hetero: a dict by node type, one gather per
    type holding ``x_attr``: its rows at its nodes' slots (de-offset ids),
    zero rows at the other slots."""
    if graph_store.is_homogeneous:
        if ("", x_attr) not in feature_store:
            return None
        return _rows(feature_store, "", x_attr, input_nodes)
    out = {}
    for nt in graph_store.node_types:
        if (nt, x_attr) not in feature_store:
            continue
        local = input_nodes - graph_store.node_offset(nt)
        ok = (local >= 0) & (local < graph_store.num_nodes(nt))
        out[nt] = _rows(feature_store, nt, x_attr, torch.where(ok, local, -1))
    return out or None


class NeighborLoader(NodeLoader):
    """NodeLoader whose sampler is built from the graph store: ``num_neighbors``
    per hop, deduplicated levels by default (``dedup=False``: the static
    layout), ``max_unique_per_hop`` capping them (``"auto"``: sized from the
    store device's memory, with dedup).  weight_attr: an edge attribute of
    the feature store -> weighted sampling.  time_attr: an edge attribute ->
    temporal sampling, which needs ``input_time`` (a time per input node).
    disjoint: a subgraph per seed; batches then carry a ``DisjointBatch``
    and (B, cap, F) features.  Hetero stores: ``num_neighbors`` a list or a
    dict by edge type; typed ``input_nodes=(node_type, ids)`` with
    ``dedup=False`` (untimed, not disjoint) samples typed target segments."""

    def __init__(self, data: Tuple[FeatureStore, GraphStore], num_neighbors: Sequence[int],
                 input_nodes=None, batch_size: int = 512, shuffle: bool = False,
                 drop_last: bool = False, weight_attr: Optional[str] = None,
                 time_attr: Optional[str] = None, input_time=None, seed: int = 0,
                 dedup: bool = True, max_unique_per_hop: Optional[Sequence[int]] = None,
                 disjoint: bool = False, **kwargs):
        feature_store, graph_store = data
        if time_attr is not None and input_time is None:
            raise ValueError(
                "time_attr requires input_time (per-seed times); without "
                "it temporal sampling has no seed times and would "
                "silently run uniform")
        if max_unique_per_hop == "auto":
            fd = resolve_feature_dim(feature_store, graph_store, kwargs.get("x_attr", "x"))
            max_unique_per_hop = resolve_max_unique_per_hop(
                "auto", batch_size, num_neighbors, fd, device=graph_store.device)
            dedup = True   # caps need the deduplicated layout
        seed_type = None
        if (not dedup and time_attr is None and not disjoint
                and isinstance(input_nodes, tuple)):
            seed_type = input_nodes[0]
        sampler = build_neighbor_sampler(
            feature_store, graph_store, num_neighbors, weight_attr=weight_attr,
            time_attr=time_attr, dedup=dedup, max_unique_per_hop=max_unique_per_hop,
            disjoint=disjoint, seed_type=seed_type)
        super().__init__(data, sampler, input_nodes=input_nodes, batch_size=batch_size,
                         shuffle=shuffle, drop_last=drop_last, input_time=input_time,
                         seed=seed, **kwargs)


def build_neighbor_sampler(feature_store, graph_store, num_neighbors, weight_attr=None,
                           time_attr=None, dedup: bool = True, max_unique_per_hop=None,
                           disjoint: bool = False, seed_type=None):
    """The sampler over a graph store's sampling CSRs, on the store's
    device: a ``NeighborSampler`` (homogeneous) or a ``HeteroNeighborSampler``
    (hetero: ``weight_attr`` / ``time_attr`` per edge type that has them,
    levels deduplicated when ``disjoint`` or capped, typed segments by
    ``seed_type`` otherwise); uniform, weighted (``weight_attr``) and/or
    temporal (``time_attr``), the edge attributes read from the feature store
    and put in CSR order; wrapped in a ``DisjointNeighborSampler`` (with
    dedup) when ``disjoint``."""
    if isinstance(max_unique_per_hop, str):
        raise ValueError(f"max_unique_per_hop={max_unique_per_hop!r}: resolve 'auto' "
                         "with sampler.heuristics.resolve_max_unique_per_hop")
    graph = graph_store.finalize()
    if not graph.is_homogeneous:
        effective_dedup = True if (disjoint or max_unique_per_hop is not None) else dedup
        sampler = HeteroNeighborSampler(
            graph, num_neighbors,
            weights_by_etype=collect_edge_attrs_by_etype(feature_store, graph_store, graph,
                                                         weight_attr),
            times_by_etype=collect_edge_attrs_by_etype(feature_store, graph_store, graph,
                                                       time_attr),
            max_unique_per_hop=max_unique_per_hop, dedup=effective_dedup,
            seed_type=None if effective_dedup else seed_type)
        return DisjointNeighborSampler(sampler) if disjoint else sampler
    indptr, indices = graph.homogeneous_csr()
    et = graph.etypes[0]
    weights = times = maxdeg = None
    if weight_attr is not None:
        weights = _edge_attr_to_csr_order(graph_store, graph, et,
                                          feature_store.get_tensor("", weight_attr))
        maxdeg = graph.max_degree_by_etype[et]
    if time_attr is not None:
        times = _edge_attr_to_csr_order(graph_store, graph, et,
                                        feature_store.get_tensor("", time_attr))
        maxdeg = graph.max_degree_by_etype[et]
    sampler = NeighborSampler(indptr, indices, num_neighbors, weights=weights,
                              edge_times=times, max_degree=maxdeg,
                              dedup=True if disjoint else dedup,
                              max_unique_per_hop=max_unique_per_hop, device=graph.device)
    return DisjointNeighborSampler(sampler) if disjoint else sampler


def _edge_attr_to_csr_order(graph_store: GraphStore, graph, et, attr):
    """An edge attribute in COO input order, reordered so that sampled edge
    ids (CSR positions) index it (the graph keeps each edge type's sort
    permutation)."""
    return graph.edge_attr_to_csr_order(et, attr)


def collect_edge_attrs_by_etype(feature_store, graph_store, graph, attr):
    """An edge attribute for every edge type that has it (feature-store key
    (``edge_type_str(et)``, attr)), in CSR order, or None for ``attr`` None;
    raises when no edge type has it."""
    if attr is None:
        return None
    out = {}
    for et in graph.etypes:
        ekey = edge_type_str(et)
        if (ekey, attr) in feature_store:
            out[et] = _edge_attr_to_csr_order(graph_store, graph, et,
                                              feature_store.get_tensor(ekey, attr))
    if not out:
        raise KeyError(f"no edge type has attribute {attr!r} in the feature store "
                       "(keys are (edge_type_str, attr))")
    return out
