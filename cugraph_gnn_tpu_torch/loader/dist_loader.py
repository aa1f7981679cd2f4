"""DistNeighborLoader / DistLinkNeighborLoader: the loaders over a mesh.

Counterpart of ``cugraph_gnn_tpu/loader/dist_loader.py`` for homogeneous
graphs: the reference's multi-GPU deployment (``examples/gcn_dist_mnmg.py``:
sharded feature store, distributed sampler, DDP model) behind the
``NeighborLoader`` surface.  Every rank runs the loader together, one
process a device: the graph is row-sharded (``sampler/dist_sampler.py``:
from the store's global CSR, or, when the graph store holds rank-local
slices (``put_local_edge_index``), routed from them), the features and labels
are row-sharded ``DistArray``s (the feature store's own when it lives on
this mesh), and each batch is

- the global batch (``batch_size`` rounded up to a multiple of the world),
  shuffled as in JAX (numpy's ``default_rng(epoch + 12345)``, every rank the
  same order), of which rank r takes the r-th contiguous block of seeds;
- this rank's ``DistNeighborSampler`` batch of them (``num_shards = 1``;
  ``level_counts`` global);
- the features of its deepest level through the distributed gather, the
  owner reading its rows with ``read_rows`` (row 1's kernel for float32 and
  bfloat16 tables on the card), and its seeds' labels (-1 for pads).

The sampler's draws come from a ``torch.Generator`` seeded with ``seed +
1_000_003 * rank``; JAX folds epoch, batch, hop and rank into its key.  The
link loader keeps JAX's seed layout ``[pos_src | pos_dst | neg_src |
neg_dst]``, padded to a multiple of the world: every rank builds the whole
layout (the negatives from a ``torch.Generator(seed)`` that every batch
advances, the same stream on every rank) and samples its block.

Heterogeneous stores and the hierarchical mesh of several hosts wait for
the next slice (``sampler/hetero_dist.py``, ``store/hierarchical.py``:
ROADMAP Queue 1 item 6, second half).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from cugraph_gnn_tpu_torch.data.feature_store import FeatureStore
from cugraph_gnn_tpu_torch.data.graph_store import GraphStore, _host
from cugraph_gnn_tpu_torch.loader.link_loader import (
    LinkBatch,
    _offset,
    draw_negatives,
    seed_layout_times,
)
from cugraph_gnn_tpu_torch.loader.node_loader import NodeBatch, _edge_attr_to_csr_order
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import read_rows
from cugraph_gnn_tpu_torch.parallel.mesh import Mesh, create_store_mesh
from cugraph_gnn_tpu_torch.sampler.dist_sampler import DistGraph, DistNeighborSampler
from cugraph_gnn_tpu_torch.sampler.heuristics import (
    resolve_feature_dim,
    resolve_max_unique_per_hop,
)
from cugraph_gnn_tpu_torch.sampler.negative import NegativeSampling, make_edge_key_sorted
from cugraph_gnn_tpu_torch.store.dist_array import (
    DistArray,
    _dist_gather_shard,
    dist_gather_recv_cap,
)
from cugraph_gnn_tpu_torch.store.partition import PartitionBook

_NEXT_SLICE = "ROADMAP Queue 1 item 6, second half"


def auto_mesh(device=None) -> Mesh:
    """The mesh of the dist loaders: the flat store mesh of the default
    process group (``create_store_mesh``: the card unless ``device`` names
    another, NCCL for the card, gloo for the CPU).  Raises without a process
    group, and for ranks on several hosts (``LOCAL_WORLD_SIZE`` below the
    world size), whose hierarchical (node, device) mesh is not ported yet."""
    mesh = create_store_mesh(device)
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None and int(local) < mesh.world:
        raise NotImplementedError(
            f"{mesh.world} ranks over several hosts need the hierarchical mesh "
            f"(store/hierarchical.py, create_hierarchical_mesh: {_NEXT_SLICE})")
    return mesh


def _refuse_hetero(graph_store: GraphStore) -> None:
    if len(graph_store.edge_types) != 1 or len(graph_store.node_types) > 1:
        raise NotImplementedError(f"distributed hetero sampling (sampler/hetero_dist.py) "
                                  f"is not ported yet ({_NEXT_SLICE})")


class DistNeighborLoader:
    """NeighborLoader over a mesh (see the module docstring): every rank
    iterates it together and gets its own ``NodeBatch`` (its seeds, sample,
    features, labels and input ids; ``batch_size`` the local batch).

    num_neighbors: fanouts per hop.  mesh: default :func:`auto_mesh`.
    weight_attr / time_attr: edge attributes of the feature store (weighted
    / temporal sampling; ``time_attr`` needs ``input_time``); in the
    rank-local mode this rank's slice, aligned with its edges.  dedup:
    per-rank deduplicated levels (default off, as in JAX);
    max_unique_per_hop: caps, or ``"auto"`` (sized from the mesh device's
    memory, with dedup).  The gathers take the ``"auto"`` receive capacity
    (``store/dist_array.py::dist_gather_recv_cap``).
    """

    def __init__(self, data: Tuple[FeatureStore, GraphStore], num_neighbors: Sequence[int],
                 mesh: Optional[Mesh] = None, input_nodes=None, batch_size: int = 512,
                 shuffle: bool = False, drop_last: bool = False,
                 weight_attr: Optional[str] = None, time_attr: Optional[str] = None,
                 input_time=None, x_attr: str = "x", y_attr: str = "y", seed: int = 0,
                 dedup: bool = False, max_unique_per_hop=None):
        feature_store, graph_store = data
        mesh = mesh if mesh is not None else auto_mesh()
        _refuse_hetero(graph_store)
        self.mesh = mesh
        world = mesh.world
        if max_unique_per_hop == "auto":
            max_unique_per_hop = resolve_max_unique_per_hop(
                "auto", -(-int(batch_size) // world), num_neighbors,
                resolve_feature_dim(feature_store, graph_store, x_attr), device=mesh.device)
            dedup = True
        et = graph_store.edge_types[0]
        if graph_store.has_local_edges:
            src, dst = graph_store.get_edge_index(et)

            def local_attr(attr):
                if attr is None:
                    return None
                v = _host(feature_store.get_tensor("", attr))
                if len(v) != len(src):
                    raise ValueError(f"edge attribute {attr!r} has {len(v)} entries; this "
                                     f"rank's slice of the edges has {len(src)}")
                return v

            self.graph = DistGraph.from_local_coo(
                src, dst, graph_store.num_nodes(), mesh, weights=local_attr(weight_attr),
                times=local_attr(time_attr))
        else:
            graph = graph_store.finalize()
            indptr, indices = graph.homogeneous_csr()

            def csr_attr(attr):
                if attr is None:
                    return None
                return _edge_attr_to_csr_order(graph_store, graph, et,
                                               feature_store.get_tensor("", attr))

            self.graph = DistGraph.from_global_csr(indptr, indices, mesh,
                                                   weights=csr_attr(weight_attr),
                                                   times=csr_attr(time_attr))
        self.sampler = DistNeighborSampler(self.graph, num_neighbors, dedup=dedup,
                                           max_unique_per_hop=max_unique_per_hop)
        self.features = _dist_of(feature_store, x_attr, mesh)
        self.labels = _dist_of(feature_store, y_attr, mesh)
        if input_nodes is None:
            input_nodes = np.arange(graph_store.num_nodes())
        if isinstance(input_nodes, tuple):       # (node_type, type-local ids)
            input_nodes = _host(input_nodes[1]) + graph_store.node_offset(input_nodes[0])
        self.input_nodes = _host(input_nodes).astype(np.int64)
        self.input_time = None if input_time is None else _host(input_time)
        self._temporal = time_attr is not None
        self.batch_size = -(-int(batch_size) // world) * world
        self.local_batch = self.batch_size // world
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._epoch = 0
        self._generator = torch.Generator(device=mesh.device).manual_seed(
            seed + 1_000_003 * mesh.rank)

    def __len__(self):
        n = len(self.input_nodes)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _mine(self, a):
        """This rank's block of a global per-seed array."""
        r, lb = self.mesh.rank, len(a) // self.mesh.world
        return a[r * lb:(r + 1) * lb]

    def gather(self, arr: Optional[DistArray], ids: torch.Tensor, fill=0, read=None):
        """rows of the sharded ``arr`` at this rank's ``ids`` (None without
        an array), every rank together."""
        if arr is None:
            return None
        cap = dist_gather_recv_cap(ids.shape[0], self.mesh.world)
        return _dist_gather_shard(arr.data, ids, book=arr.book, mesh=self.mesh, fill=fill,
                                  read=read, recv_cap=cap)

    def sample_and_gather(self, seeds: torch.Tensor, node_times=None):
        """This rank's (sample, features) for its ``seeds``: the sampler's
        batch, then its deepest level's rows through ``read_rows``."""
        kw = {} if node_times is None else {"node_times": node_times}
        sample = self.sampler.sample(seeds, generator=self._generator, **kw)
        return sample, self.gather(self.features, sample.input_nodes, 0, read_rows)

    def __iter__(self) -> Iterator[NodeBatch]:
        if self._temporal and self.input_time is None:
            raise ValueError("time_attr requires input_time (per-seed times); without it "
                             "temporal sampling has no seed times and would silently run "
                             "uniform")
        order = np.arange(len(self.input_nodes))
        if self.shuffle:
            np.random.default_rng(self._epoch + 12345).shuffle(order)
        self._epoch += 1
        b, dev = self.batch_size, self.mesh.device
        for i in range(len(self)):
            sel = order[i * b:(i + 1) * b]
            input_id = np.full((b,), -1, np.int64)
            input_id[:len(sel)] = sel
            seeds = np.full((b,), -1, np.int32)
            seeds[:len(sel)] = self.input_nodes[sel]
            seeds_t = torch.as_tensor(self._mine(seeds), device=dev)
            times = None
            if self.input_time is not None:     # pads at time 0, as in JAX
                t = np.zeros((b,), self.input_time.dtype)
                t[:len(sel)] = self.input_time[sel]
                times = torch.as_tensor(self._mine(t), device=dev)
            sample, x = self.sample_and_gather(seeds_t, times)
            y = self.gather(self.labels, seeds_t, -1)
            yield NodeBatch(sample=sample, x=x, y=None if y is None else y[:, 0], seeds=seeds_t,
                            input_id=torch.as_tensor(self._mine(input_id), device=dev),
                            batch_size=self.local_batch)


def _dist_of(feature_store: FeatureStore, attr: str, mesh: Mesh) -> Optional[DistArray]:
    """The node tensor ``attr`` as a DistArray on ``mesh`` (rows, 1-D tensors
    as one column), which the loader only reads: the store's own when it is
    sharded on this mesh; else this rank's rows of the whole tensor, in place
    where they fill a shard on the mesh's device (the card's table at world
    1 is not copied), copied otherwise."""
    if ("", attr) not in feature_store:
        return None
    if feature_store.mesh == mesh:
        kind, val = feature_store._store[("", attr)]
        if kind in ("1d", "2d"):
            return val
    full = feature_store.get_tensor("", attr)
    full = full[:, None] if full.dim() == 1 else full
    book = PartitionBook.even(full.shape[0], mesh.world)
    rows = full[int(book.offsets[mesh.rank]):int(book.offsets[mesh.rank + 1])]
    if rows.shape[0] == book.shard_size and rows.device == mesh.device:
        return DistArray(rows.contiguous(), book, mesh)
    return DistArray.from_array(full, mesh, book=book)


class DistLinkNeighborLoader:
    """LinkNeighborLoader over a mesh: B positive edges and N negatives a
    batch in JAX's seed layout ``[pos_src | pos_dst | neg_src | neg_dst]``,
    padded to a multiple of the world, each rank sampling (and gathering
    features for) its block of it.  Each rank's ``LinkBatch`` holds its
    sample and features, and the whole layout's ``seeds``,
    ``edge_label_index`` (positions in it) and ``edge_label``: at world 1
    it is the batch of ``train_link.link_step``.

    edge_label_index: (2, E) positives, or (edge_type, (2, E)) with
    type-local ids.  neg_sampling: a ``NegativeSampling``, its mode, or its
    fields as a dict.  time_attr needs ``edge_label_time`` (and the other
    way round): every seed slot takes its edge's time, as in
    ``LinkNeighborLoader``.  Other arguments as ``DistNeighborLoader``.
    """

    def __init__(self, data: Tuple[FeatureStore, GraphStore], num_neighbors: Sequence[int],
                 mesh: Optional[Mesh] = None, *, edge_label_index=None, edge_label=None,
                 neg_sampling=None, batch_size: int = 512, shuffle: bool = False,
                 drop_last: bool = False, weight_attr: Optional[str] = None,
                 time_attr: Optional[str] = None, x_attr: str = "x", seed: int = 0,
                 dedup: bool = False, max_unique_per_hop=None,
                 reject_true_edges: bool = False, edge_label_time=None):
        if edge_label_index is None:
            raise ValueError("edge_label_index is required")
        if time_attr is not None and edge_label_time is None:
            raise ValueError("time_attr requires edge_label_time (per-seed-edge times); "
                             "without it temporal sampling has no seed times and would "
                             "silently run uniform")
        if time_attr is None and edge_label_time is not None:
            raise ValueError("edge_label_time requires time_attr (per-edge graph times); "
                             "without it the seed times are ignored and sampling would "
                             "silently run uniform")
        _, graph_store = data
        mesh = mesh if mesh is not None else auto_mesh()
        self.mesh = mesh
        self.edge_type = None
        if (isinstance(edge_label_index, tuple) and len(edge_label_index) == 2
                and isinstance(edge_label_index[0], (tuple, str))):
            self.edge_type, edge_label_index = edge_label_index
        eli = _host(edge_label_index)
        self.pos_src = eli[0].astype(np.int64)
        self.pos_dst = eli[1].astype(np.int64)
        self.edge_label = None if edge_label is None else _host(edge_label)
        self.edge_label_time = None if edge_label_time is None else _host(edge_label_time)
        if isinstance(neg_sampling, str):
            neg_sampling = NegativeSampling(mode=neg_sampling)
        elif isinstance(neg_sampling, dict):
            neg_sampling = NegativeSampling(**neg_sampling)
        self.neg = neg_sampling
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._epoch = 0
        self.device = mesh.device
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.edge_type is not None:
            src_t, _, dst_t = self.edge_type
            self.src_offset = graph_store.node_offset(src_t)
            self.dst_offset = graph_store.node_offset(dst_t)
            self.num_src = graph_store.num_nodes(src_t)
            self.num_dst = graph_store.num_nodes(dst_t)
        else:
            self.src_offset = self.dst_offset = 0
            self.num_src = self.num_dst = graph_store.num_nodes()
        self._edge_key_sorted = None
        if reject_true_edges:
            self._edge_key_sorted = make_edge_key_sorted(self.pos_src, self.pos_dst,
                                                         self.num_dst, device=self.device)
        self.num_neg = 0 if self.neg is None else int(self.batch_size * self.neg.amount)
        total = 2 * (self.batch_size + self.num_neg)
        self.seed_count = -(-total // mesh.world) * mesh.world
        # the sampling and the gathers are the node loader's
        self._nl = DistNeighborLoader(
            data, num_neighbors, mesh, input_nodes=np.zeros(0, np.int64),
            batch_size=self.seed_count, weight_attr=weight_attr, time_attr=time_attr,
            x_attr=x_attr, y_attr="__link_loaders_have_no_labels__", seed=seed, dedup=dedup,
            max_unique_per_hop=max_unique_per_hop)

    @property
    def sampler(self) -> DistNeighborSampler:
        """The node loader's sampler, which samples this rank's block."""
        return self._nl.sampler

    @sampler.setter
    def sampler(self, sampler) -> None:
        self._nl.sampler = sampler

    def __len__(self):
        n = len(self.pos_src)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _negatives(self, ps: torch.Tensor, n_neg: int):
        return draw_negatives(ps, n_neg, self.num_src, self.num_dst, self.neg,
                              self._edge_key_sorted, generator=self._generator,
                              device=self.device)

    def __iter__(self) -> Iterator[LinkBatch]:
        order = np.arange(len(self.pos_src))
        if self.shuffle:
            np.random.default_rng(self._epoch + 999).shuffle(order)
        self._epoch += 1
        b, n_neg, dev = self.batch_size, self.num_neg, self.device
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
            seeds = torch.full((self.seed_count,), -1, dtype=torch.int32, device=dev)
            seeds[:2 * (b + n_neg)] = torch.cat([
                _offset(ps_t, self.src_offset),
                _offset(torch.as_tensor(pd, device=dev), self.dst_offset),
                _offset(ns, self.src_offset), _offset(nd, self.dst_offset)])
            times = None
            if self.edge_label_time is not None:
                t = seed_layout_times(self.edge_label_time, sel, b, self.neg, n_neg)
                full = np.zeros((self.seed_count,), t.dtype)
                full[:len(t)] = t
                times = torch.as_tensor(self._nl._mine(full), device=dev)
            sample, x = self._nl.sample_and_gather(self._nl._mine(seeds), times)
            lab = (ps >= 0).astype(np.float32)
            if self.edge_label is not None:
                user = np.zeros((b,), np.float32)
                user[:len(sel)] = self.edge_label[sel]
                lab = user * lab
            label = torch.cat([torch.as_tensor(lab, device=dev),
                               torch.zeros((n_neg,), dtype=torch.float32, device=dev)])
            yield LinkBatch(sample=sample, x=x, edge_label_index=eli, edge_label=label,
                            seeds=seeds, input_id=torch.as_tensor(input_id, device=dev))
