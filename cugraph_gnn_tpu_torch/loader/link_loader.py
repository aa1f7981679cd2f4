"""LinkLoader / LinkNeighborLoader: edge-seeded loaders for link prediction.

Counterpart of ``cugraph_gnn_tpu/loader/link_loader.py`` for homogeneous
graphs.  A batch of B positive edges and N negatives is one fixed seed
layout, sampled as one node batch:

    seeds = [pos_src (B) | pos_dst (B) | neg_src (N) | neg_dst (N)]

each block padded with -1 at its end (the last batch's positives; negatives
the rejection left unresolved).  Seeds are not deduplicated: a node in
several edges is several seeds, and the sampler's ``append_unique`` maps a
neighbor equal to a repeated seed to its first copy.  ``edge_label_index``
points at the layout's positions.

The positive edges are shuffled per epoch with numpy's ``default_rng(epoch
+ 999)``, as in JAX.  The negatives and the sampler's uniforms come from one
``torch.Generator`` seeded with ``seed``, which every batch advances (JAX
folds the epoch and batch into its key instead).

Temporal link sampling: ``edge_label_time`` gives each positive edge a time,
and every seed slot samples only edges no newer than its own: a positive's
endpoints carry its edge's time, binary negatives cycle the batch's valid
times, triplet negatives repeat their positive's, and pads take the batch's
largest.  As in JAX, the negatives themselves are drawn without a time
constraint.

Hetero link prediction: ``edge_label_index=(edge_type, (2, E))`` with
type-local source and destination ids (PyG's convention).  Negatives are
drawn inside the edge type's endpoint types (``num_src`` / ``num_dst`` of
its source and destination node types), and the whole seed layout is shifted
into the global id space by the two node offsets (-1 pads stay -1).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from cugraph_gnn_tpu_torch.data.feature_store import FeatureStore
from cugraph_gnn_tpu_torch.data.graph_store import GraphStore, _host
from cugraph_gnn_tpu_torch.loader.node_loader import (
    build_neighbor_sampler,
    gather_node_features,
)
from cugraph_gnn_tpu_torch.sampler.negative import (
    NegativeSampling,
    make_edge_key_sorted,
    sample_negative_edges,
)
from cugraph_gnn_tpu_torch.sampler.output import MultihopBatch


def draw_negatives(ps, n_neg: int, num_src: int, num_dst: int, neg: NegativeSampling,
                   edge_key_sorted=None, *, draws=None, generator=None, device=None):
    """binary: independent (src, dst) corruption pairs.  triplet: each
    positive source ``ps`` (B,) gets ``amount`` corrupted destinations; a
    negative whose source is padding, or whose pair stayed a true edge, has
    destination -1 (its source stays).  ``draws``: the candidates of
    ``sample_negative_edges``, else drawn from ``generator``."""
    if neg.mode == "triplet":
        amount = max(int(neg.amount), 1)
        ps = torch.as_tensor(ps, device=device).to(torch.int32)
        ns = ps.repeat_interleave(amount)[:n_neg]
        ns_out, nd = sample_negative_edges(num_src, num_dst, n_neg, neg, edge_key_sorted,
                                           src=ns, draws=draws, generator=generator,
                                           device=device)
        return ns, torch.where((ns >= 0) & (ns_out >= 0), nd, -1)
    return sample_negative_edges(num_src, num_dst, n_neg, neg, edge_key_sorted,
                                 draws=draws, generator=generator, device=device)


def seed_layout_times(edge_label_time, sel, batch_size: int, neg, n_neg: int) -> np.ndarray:
    """The seed layout's times for the positives ``sel``: each endpoint its
    edge's time, binary negatives the batch's valid times cycled, triplet
    negatives their positive's, pads the batch's largest."""
    bt = edge_label_time[sel]
    t = np.full((batch_size,), bt.max() if len(bt) else 0, bt.dtype)
    t[:len(sel)] = bt
    if neg is not None and neg.mode == "triplet":
        neg_t = np.repeat(t, max(int(neg.amount), 1))[:n_neg]
    elif len(bt):
        neg_t = np.resize(bt, n_neg)
    else:
        neg_t = np.zeros((n_neg,), t.dtype)
    return np.concatenate([t, t, neg_t, neg_t])


@dataclasses.dataclass
class LinkBatch:
    """One link-prediction batch."""

    sample: MultihopBatch           # over the seed layout (a DisjointBatch with disjoint=True)
    x: Optional[object]             # (S_L, F) features of sample.input_nodes; hetero: a dict
    edge_label_index: torch.Tensor  # (2, B+N) int32 positions in seeds
    edge_label: torch.Tensor        # (B+N,) float32: 1 (or the label) positive, 0 negative
    seeds: torch.Tensor             # (2B+2N,) int32 global ids
    input_id: torch.Tensor          # (B,) int64 positions of the positive edges, -1 padded


def _offset(ids, off: int):
    return torch.where(ids >= 0, ids + off, -1).to(torch.int32) if off else ids


class LinkLoader:
    """Edge-seeded loader over ``sampler``; batches live on the graph
    store's device."""

    def __init__(self, data: Tuple[FeatureStore, GraphStore], sampler, edge_label_index,
                 edge_label=None, neg_sampling: Optional[NegativeSampling] = None,
                 batch_size: int = 512, shuffle: bool = False, drop_last: bool = False,
                 x_attr: str = "x", reject_true_edges: bool = False, seed: int = 0,
                 edge_label_time=None):
        self.feature_store, self.graph_store = data
        self.edge_type = None
        if (isinstance(edge_label_index, tuple) and len(edge_label_index) == 2
                and isinstance(edge_label_index[0], (tuple, str))):
            self.edge_type, edge_label_index = edge_label_index
        self.sampler = sampler
        if isinstance(edge_label_time, torch.Tensor):
            edge_label_time = edge_label_time.cpu().numpy()
        self.edge_label_time = (None if edge_label_time is None
                                else np.asarray(edge_label_time))
        eli = _host(edge_label_index)
        self.pos_src = eli[0].astype(np.int64)     # type-local ids for an edge type
        self.pos_dst = eli[1].astype(np.int64)
        if isinstance(edge_label, torch.Tensor):
            edge_label = edge_label.cpu().numpy()
        self.edge_label = None if edge_label is None else np.asarray(edge_label)
        self.neg = neg_sampling
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.x_attr = x_attr
        self.device = self.graph_store.device
        self._epoch = 0
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.edge_type is not None:
            src_t, _, dst_t = self.edge_type
            self.src_offset = self.graph_store.node_offset(src_t)
            self.dst_offset = self.graph_store.node_offset(dst_t)
            self.num_src = self.graph_store.num_nodes(src_t)
            self.num_dst = self.graph_store.num_nodes(dst_t)
        else:
            self.src_offset = self.dst_offset = 0
            self.num_src = self.num_dst = self.graph_store.num_nodes()
        self._edge_key_sorted = None
        if reject_true_edges:
            self._edge_key_sorted = make_edge_key_sorted(self.pos_src, self.pos_dst,
                                                         self.num_dst, device=self.device)

    def __len__(self):
        n = len(self.pos_src)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def _num_neg(self) -> int:
        if self.neg is None:
            return 0
        return int(self.batch_size * self.neg.amount)

    def _negatives(self, ps, n_neg):
        return draw_negatives(ps, n_neg, self.num_src, self.num_dst, self.neg,
                              self._edge_key_sorted, generator=self._generator,
                              device=self.device)

    def _seed_times(self, sel, n_neg: int) -> np.ndarray:
        return seed_layout_times(self.edge_label_time, sel, self.batch_size, self.neg, n_neg)

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.pos_src))
        if self.shuffle:
            np.random.default_rng(self._epoch + 999).shuffle(order)
        return order

    def __iter__(self) -> Iterator[LinkBatch]:
        order = self._epoch_order()
        self._epoch += 1
        b, n_neg, dev = self.batch_size, self._num_neg, self.device
        pos_idx = torch.arange(b, dtype=torch.int32, device=dev)
        neg_idx = torch.arange(n_neg, dtype=torch.int32, device=dev) + 2 * b
        eli = torch.cat([torch.stack([pos_idx, pos_idx + b]),
                         torch.stack([neg_idx, neg_idx + n_neg])], dim=1)
        for i in range(len(self)):
            sel = order[i * b:(i + 1) * b]
            ps = np.full((b,), -1, np.int32)
            pd = np.full((b,), -1, np.int32)
            ps[:len(sel)] = self.pos_src[sel]
            pd[:len(sel)] = self.pos_dst[sel]
            input_id = np.full((b,), -1, np.int64)
            input_id[:len(sel)] = sel
            ps_t = torch.as_tensor(ps, device=dev)
            if n_neg:
                ns, nd = self._negatives(ps_t, n_neg)
            else:
                ns = nd = torch.zeros((0,), dtype=torch.int32, device=dev)
            # type-local -> global ids (-1 pads stay -1)
            seeds = torch.cat([_offset(ps_t, self.src_offset),
                               _offset(torch.as_tensor(pd, device=dev), self.dst_offset),
                               _offset(ns, self.src_offset), _offset(nd, self.dst_offset)])
            kw = {}
            if self.edge_label_time is not None:
                kw["node_times"] = torch.as_tensor(self._seed_times(sel, n_neg), device=dev)
            sample = self.sampler.sample(seeds, generator=self._generator, **kw)
            lab = (ps >= 0).astype(np.float32)
            if self.edge_label is not None:
                user = np.zeros((b,), np.float32)
                user[:len(sel)] = self.edge_label[sel]
                lab = user * lab
            label = torch.cat([torch.as_tensor(lab, device=dev),
                               torch.zeros((n_neg,), dtype=torch.float32, device=dev)])
            yield LinkBatch(sample=sample,
                            x=gather_node_features(self.feature_store, self.graph_store,
                                                   self.x_attr, sample.input_nodes),
                            edge_label_index=eli, edge_label=label, seeds=seeds,
                            input_id=torch.as_tensor(input_id, device=dev))


class LinkNeighborLoader(LinkLoader):
    """LinkLoader whose sampler is built from the graph store
    (``build_neighbor_sampler``): ``num_neighbors`` per hop, deduplicated
    levels, weighted with ``weight_attr``, temporal with ``time_attr`` (which
    needs ``edge_label_time``, and the other way round), per-seed subgraphs
    with ``disjoint``.  ``neg_sampling``: a ``NegativeSampling``, its mode as
    a string, or its fields as a dict."""

    def __init__(self, data: Tuple[FeatureStore, GraphStore], num_neighbors,
                 edge_label_index, edge_label=None, neg_sampling=None,
                 batch_size: int = 512, weight_attr=None, time_attr=None,
                 disjoint: bool = False, **kwargs):
        feature_store, graph_store = data
        if time_attr is not None and kwargs.get("edge_label_time") is None:
            raise ValueError(
                "time_attr requires edge_label_time (per-seed-edge "
                "times); without it temporal sampling has no seed "
                "times and would silently run uniform")
        if time_attr is None and kwargs.get("edge_label_time") is not None:
            raise ValueError(
                "edge_label_time requires time_attr (per-edge graph "
                "times); without it the seed times are ignored and "
                "sampling would silently run uniform")
        sampler = build_neighbor_sampler(feature_store, graph_store, num_neighbors,
                                         weight_attr=weight_attr, time_attr=time_attr,
                                         disjoint=disjoint)
        if isinstance(neg_sampling, str):
            neg_sampling = NegativeSampling(mode=neg_sampling)
        elif isinstance(neg_sampling, dict):
            neg_sampling = NegativeSampling(**neg_sampling)
        super().__init__(data, sampler, edge_label_index, edge_label=edge_label,
                         neg_sampling=neg_sampling, batch_size=batch_size, **kwargs)
