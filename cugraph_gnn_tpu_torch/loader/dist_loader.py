"""DistNeighborLoader / DistLinkNeighborLoader: the loaders over a mesh.

Counterpart of ``cugraph_gnn_tpu/loader/dist_loader.py``: the reference's
multi-GPU deployment (``examples/gcn_dist_mnmg.py``: sharded feature store,
distributed sampler, DDP model) behind the ``NeighborLoader`` surface.
Every rank runs the loader together, one process a device: the graph is
row-sharded (``sampler/dist_sampler.py``: from the store's global CSR, or,
when the graph store holds rank-local slices (``put_local_edge_index``),
routed from them), the features and labels are row-sharded ``DistArray``s
(the feature store's own when it lives on this mesh), and each batch is

- the global batch (``batch_size`` rounded up to a multiple of the world),
  shuffled as in JAX (numpy's ``default_rng(epoch + 12345)``, every rank the
  same order), of which rank r takes the r-th contiguous block of seeds;
- this rank's ``DistNeighborSampler`` batch of them (``num_shards = 1``;
  ``level_counts`` global);
- the features of its deepest level through the distributed gather, the
  owner reading its rows with ``read_rows`` (row 1's kernel for float32 and
  bfloat16 tables on the card), and its seeds' labels (-1 for pads).

Heterogeneous stores (several node or edge types) sample through
``sampler/hetero_dist.py`` (every edge type on one even book over the global
ids): typed ``input_nodes=(node_type, ids)`` take type-local ids, the
features are a dict by node type (each type's ``DistArray`` gathered at its
offset range, zero rows elsewhere), and the labels are read under the seed
type (de-offset) or under "".  The rank-local mode takes each edge type's
slice, and its edge attributes, from the stores.

On a hierarchical (node, device) mesh (``auto_mesh`` on several hosts) the
homogeneous batch's feature and label gathers take the dedup-before-exchange
gather (``store/hierarchical.py``); seed routing, and every gather of a
hetero batch, stay one flat exchange over the whole group, as in JAX.

The sampler's draws come from a ``torch.Generator`` seeded with ``seed +
1_000_003 * rank``; JAX folds epoch, batch, hop and rank into its key.  The
link loader keeps JAX's seed layout ``[pos_src | pos_dst | neg_src |
neg_dst]``, padded to a multiple of the world: every rank builds the whole
layout (the negatives from a ``torch.Generator(seed)`` that every batch
advances, the same stream on every rank) and samples its block.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from cugraph_gnn_tpu_torch.data.feature_store import FeatureStore
from cugraph_gnn_tpu_torch.data.graph_store import GraphStore, _host, edge_type_str
from cugraph_gnn_tpu_torch.loader.link_loader import (
    LinkBatch,
    _offset,
    draw_negatives,
    seed_layout_times,
)
from cugraph_gnn_tpu_torch.loader.node_loader import (
    NodeBatch,
    _edge_attr_to_csr_order,
    collect_edge_attrs_by_etype,
)
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import read_rows
from cugraph_gnn_tpu_torch.parallel.mesh import (
    HierarchicalMesh,
    create_hierarchical_mesh,
    create_store_mesh,
)
from cugraph_gnn_tpu_torch.sampler.dist_sampler import DistGraph, DistNeighborSampler
from cugraph_gnn_tpu_torch.sampler.hetero_dist import HeteroDistGraph, HeteroDistNeighborSampler
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
from cugraph_gnn_tpu_torch.store.hierarchical import _hier_gather_shard
from cugraph_gnn_tpu_torch.store.partition import PartitionBook
from cugraph_gnn_tpu_torch.utils.distributed import num_hosts


def auto_mesh(device=None, num_nodes: Optional[int] = None):
    """The mesh of the dist loaders, by topology: ranks on several hosts
    (``num_nodes`` > 1, default the world over ``LOCAL_WORLD_SIZE``) get the
    hierarchical (node, device) mesh, whose ``axis`` is ("node", "device");
    one host gets the flat store mesh.  ``device``: the card unless named
    (NCCL for the card, gloo for the CPU).  Every rank calls it together;
    raises without a process group."""
    n = num_hosts() if num_nodes is None else int(num_nodes)
    if n > 1:
        return create_hierarchical_mesh(n, device)
    return create_store_mesh(device)


class DistNeighborLoader:
    """NeighborLoader over a mesh (see the module docstring): every rank
    iterates it together and gets its own ``NodeBatch`` (its seeds, sample,
    features, labels and input ids; ``batch_size`` the local batch).

    num_neighbors: fanouts per hop (hetero: a list, or a dict by edge type).
    mesh: default :func:`auto_mesh`.  weight_attr / time_attr: edge
    attributes of the feature store (weighted / temporal sampling;
    ``time_attr`` needs ``input_time``; hetero: under each edge type's
    ``edge_type_str``); in the rank-local mode this rank's slice, aligned
    with its edges.  dedup: per-rank deduplicated levels (default off, as in
    JAX; always on for hetero stores); max_unique_per_hop: caps, or
    ``"auto"`` (sized from the mesh device's memory, with dedup).  The
    gathers take the ``"auto"`` receive capacity
    (``store/dist_array.py::dist_gather_recv_cap``).
    """

    def __init__(self, data: Tuple[FeatureStore, GraphStore], num_neighbors,
                 mesh=None, input_nodes=None, batch_size: int = 512,
                 shuffle: bool = False, drop_last: bool = False,
                 weight_attr: Optional[str] = None, time_attr: Optional[str] = None,
                 input_time=None, x_attr: str = "x", y_attr: str = "y", seed: int = 0,
                 dedup: bool = False, max_unique_per_hop=None):
        feature_store, graph_store = data
        mesh = mesh if mesh is not None else auto_mesh()
        self.mesh = mesh
        world = mesh.world
        if max_unique_per_hop == "auto":
            max_unique_per_hop = resolve_max_unique_per_hop(
                "auto", -(-int(batch_size) // world), num_neighbors,
                resolve_feature_dim(feature_store, graph_store, x_attr), device=mesh.device)
            dedup = True
        self.hetero = not graph_store.is_homogeneous
        self.input_type = None
        if isinstance(input_nodes, tuple):       # (node_type, type-local ids)
            self.input_type, input_nodes = input_nodes
            input_nodes = _host(input_nodes) + graph_store.node_offset(self.input_type)
        if self.hetero:
            self.graph = _hetero_graph(feature_store, graph_store, mesh, weight_attr,
                                       time_attr)
            self.sampler = HeteroDistNeighborSampler(self.graph, num_neighbors,
                                                     max_unique_per_hop=max_unique_per_hop)
            self.features = {nt: fa for nt in graph_store.node_types
                             if (fa := _dist_of(feature_store, x_attr, mesh, nt)) is not None}
            self.node_ranges = {nt: (graph_store.node_offset(nt), graph_store.num_nodes(nt))
                                for nt in graph_store.node_types}
            # labels under the seed type (type-local rows) or under ""
            if self.input_type is not None and (self.input_type, y_attr) in feature_store:
                self.labels = _dist_of(feature_store, y_attr, mesh, self.input_type)
                self.label_offset = graph_store.node_offset(self.input_type)
            else:
                self.labels = _dist_of(feature_store, y_attr, mesh)
                self.label_offset = 0
        else:
            self.graph = _homogeneous_graph(feature_store, graph_store, mesh, weight_attr,
                                            time_attr)
            self.sampler = DistNeighborSampler(self.graph, num_neighbors, dedup=dedup,
                                               max_unique_per_hop=max_unique_per_hop)
            self.features = _dist_of(feature_store, x_attr, mesh)
            self.labels = _dist_of(feature_store, y_attr, mesh)
            self.label_offset = 0
        if input_nodes is None:
            input_nodes = np.arange(graph_store.num_nodes())
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
        an array), every rank together: on a hierarchical mesh the homogeneous
        batch's gathers take the two-level gather, the others one flat
        exchange."""
        if arr is None:
            return None
        if isinstance(self.mesh, HierarchicalMesh) and not self.hetero:
            return _hier_gather_shard(arr.data, ids, book=arr.book, mesh=self.mesh, fill=fill,
                                      read=read)[0]
        cap = dist_gather_recv_cap(ids.shape[0], self.mesh.world)
        return _dist_gather_shard(arr.data, ids, book=arr.book, mesh=self.mesh, fill=fill,
                                  read=read, recv_cap=cap)

    def gather_features(self, input_nodes: torch.Tensor):
        """The features of a sampled level: one gather (homogeneous), or a
        dict by node type, each type's rows at its offset range (zero rows
        at the other slots; None without features)."""
        if not self.hetero:
            return self.gather(self.features, input_nodes, 0, read_rows)
        out = {}
        for nt, arr in self.features.items():
            off, n = self.node_ranges[nt]
            local = input_nodes - off
            ok = (input_nodes >= 0) & (local >= 0) & (local < n)
            out[nt] = self.gather(arr, torch.where(ok, local, -1), 0, read_rows)
        return out or None

    def gather_labels(self, seeds: torch.Tensor):
        """The labels of this rank's seeds (-1 for pads; under the seed type
        at de-offset ids for typed hetero seeds)."""
        if self.labels is None:
            return None
        ids = torch.where(seeds >= 0, seeds - self.label_offset, -1) if self.label_offset \
            else seeds
        return self.gather(self.labels, ids, -1)[:, 0]

    def sample_and_gather(self, seeds: torch.Tensor, node_times=None):
        """This rank's (sample, features) for its ``seeds``: the sampler's
        batch, then its deepest level's rows through ``read_rows``."""
        kw = {} if node_times is None else {"node_times": node_times}
        sample = self.sampler.sample(seeds, generator=self._generator, **kw)
        return sample, self.gather_features(sample.input_nodes)

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
            yield NodeBatch(sample=sample, x=x, y=self.gather_labels(seeds_t), seeds=seeds_t,
                            input_id=torch.as_tensor(self._mine(input_id), device=dev),
                            batch_size=self.local_batch)


def _local_attr(feature_store, group: str, attr: Optional[str], n_edges: int, what):
    """A rank-local edge attribute (this rank's slice, aligned with its
    edges), or None."""
    if attr is None or (group, attr) not in feature_store:
        return None
    v = _host(feature_store.get_tensor(group, attr))
    if len(v) != n_edges:
        raise ValueError(f"edge attribute {attr!r} of {what} has {len(v)} entries; this "
                         f"rank's slice of the edges has {n_edges}")
    return v


def _homogeneous_graph(feature_store, graph_store, mesh, weight_attr, time_attr) -> DistGraph:
    """This rank's shard of a homogeneous store's graph: routed from the
    rank-local slices, or cut from the global CSR."""
    et = graph_store.edge_types[0]
    if graph_store.has_local_edges:
        src, dst = graph_store.get_edge_index(et)
        attrs = {}
        for key, attr in (("weights", weight_attr), ("times", time_attr)):
            if attr is not None and ("", attr) not in feature_store:
                raise KeyError(f"no edge attribute {attr!r} in the feature store")
            attrs[key] = _local_attr(feature_store, "", attr, len(src), "the edges")
        return DistGraph.from_local_coo(src, dst, graph_store.num_nodes(), mesh, **attrs)
    graph = graph_store.finalize()
    indptr, indices = graph.homogeneous_csr()

    def csr_attr(attr):
        if attr is None:
            return None
        return _edge_attr_to_csr_order(graph_store, graph, et,
                                       feature_store.get_tensor("", attr))

    return DistGraph.from_global_csr(indptr, indices, mesh, weights=csr_attr(weight_attr),
                                     times=csr_attr(time_attr))


def _hetero_graph(feature_store, graph_store, mesh, weight_attr, time_attr) -> HeteroDistGraph:
    """This rank's shards of a hetero store's edge types: each type's
    rank-local slice (in global ids) routed to its owners, or cut from the
    store's CSRs."""
    if graph_store.has_local_edges:
        edges, attrs = {}, {"weights_by_etype": {}, "times_by_etype": {}}
        for et in graph_store.edge_types:
            st, _, dt = et
            src, dst = graph_store.get_edge_index(et)
            edges[et] = (_host(src).astype(np.int64) + graph_store.node_offset(st),
                         _host(dst).astype(np.int64) + graph_store.node_offset(dt))
            for key, attr in (("weights_by_etype", weight_attr), ("times_by_etype", time_attr)):
                v = _local_attr(feature_store, edge_type_str(et), attr, len(src), et)
                if v is not None:
                    attrs[key][et] = v
        for key, attr in (("weights_by_etype", weight_attr), ("times_by_etype", time_attr)):
            if attr is not None and not attrs[key]:
                raise KeyError(f"no edge type has attribute {attr!r} in the feature store "
                               "(keys are (edge_type_str, attr))")
        return HeteroDistGraph.from_local_coo(edges, graph_store.num_nodes(), mesh, **attrs)
    graph = graph_store.finalize()
    return HeteroDistGraph.from_sampling_graph(
        graph, mesh,
        weights_by_etype=collect_edge_attrs_by_etype(feature_store, graph_store, graph,
                                                     weight_attr),
        times_by_etype=collect_edge_attrs_by_etype(feature_store, graph_store, graph,
                                                   time_attr))


def _dist_of(feature_store: FeatureStore, attr: str, mesh, group: str = "") -> Optional[DistArray]:
    """The node tensor (``group``, ``attr``) as a DistArray on ``mesh`` (rows,
    1-D tensors as one column), which the loader only reads: the store's own
    when it is sharded on this mesh; else this rank's rows of the whole
    tensor, in place where they fill a shard on the mesh's device (the
    card's table at world 1 is not copied), copied otherwise."""
    if (group, attr) not in feature_store:
        return None
    if feature_store.mesh == mesh:
        kind, val = feature_store._store[(group, attr)]
        if kind in ("1d", "2d"):
            return val
    full = feature_store.get_tensor(group, attr)
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

    def __init__(self, data: Tuple[FeatureStore, GraphStore], num_neighbors,
                 mesh=None, *, edge_label_index=None, edge_label=None,
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
        self.hetero = self._nl.hetero

    @property
    def sampler(self):
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
