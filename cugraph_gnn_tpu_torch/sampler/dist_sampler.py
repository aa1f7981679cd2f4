"""Distributed neighbor sampling over a row-sharded graph.

Counterpart of ``cugraph_gnn_tpu/sampler/dist_sampler.py``.  The reversed
CSR is partitioned by row (destination node) over the ranks of a mesh: each
rank holds only its rows [offsets[r], offsets[r+1]) of a ``PartitionBook``
(edge-balanced by default), with a rebased ``indptr``, its slice of the
global column ids and the global edge-id offset of every shard.  A hop
routes each target (and its seed time, when sampling is temporal) to the
rank that owns it (``store/dist_array.py``'s ragged all-to-all), samples
there (uniform: row 2's kernel through ``ops/sample.py::uniform_sample``;
weighted: ``weighted_sample``; temporal: ``masked_uniform_sample``), adds
the shard's edge base and sends the fixed-fanout blocks back in the
targets' order.  No rank reads another's rows.

Every rank samples its own seeds and keeps its own levels and blocks: a
rank's ``MultihopBatch`` has ``num_shards = 1``, as JAX's shard-blockwise
batch is one block a shard; only ``level_counts`` (and ``seed_count``) are
global, summed over the ranks by one all-reduce.  ``dedup=True``
deduplicates each level on its rank (``ops/unique.py::append_unique``, the
reference's per-rank ``deduplicate_sources``), optionally capped by
``max_unique_per_hop``.

Draws are injectable so that tests can replay the JAX package's: ``u[h]``,
hop h's uniforms over the targets this rank *receives* (sender by sender,
each sender's in its order by owner), and ``hash_keys[h]``, this rank's key
words of a weighted or time-masked hop.  The JAX package draws over its
whole receive buffer, which also holds -1 pad ids (bucketed to the last
rank); the port sends no pads, so on the last rank its rows are JAX's with
the pad rows taken out, in order.  The TPU line padding of a shard's edges
(JAX's ``_LINE``, for the line-window gather) is not kept: the port reads
neighbor ids directly.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch.data.graph_store import _host
from cugraph_gnn_tpu_torch.ops.edge_ids import MAX_LOCAL_EDGES, combine_local, split_bases_np
from cugraph_gnn_tpu_torch.ops.unique import append_unique
from cugraph_gnn_tpu_torch.parallel.mesh import Mesh, create_store_mesh
from cugraph_gnn_tpu_torch.sampler.heuristics import clamp_level_caps
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import (
    level_capacities,
    one_hop,
    propagate_times,
    static_layout,
)
from cugraph_gnn_tpu_torch.sampler.output import HopBlock, MultihopBatch
from cugraph_gnn_tpu_torch.store.dist_array import (
    _bucket_by_owner,
    _count,
    _ragged_a2a,
    all_reduce_np,
    alltoallv,
)
from cugraph_gnn_tpu_torch.store.edge_exchange import route_local_edges
from cugraph_gnn_tpu_torch.store.partition import PartitionBook


class DistGraph(NamedTuple):
    """This rank's shard of a row-sharded CSR.

    indptr:     (count + 1,) int32, this rank's rows, rebased to 0
    indices:    (E_r,) int32 global source ids of this rank's edges
    edge_base:  (W,) int64 host array: every shard's first global edge id
    book:       the row partition (``offsets``, ``counts``)
    mesh:       the ranks and this rank's device
    weights / times: optional (E_r,) per-edge attributes (weighted /
                temporal sampling), in this shard's CSR order
    max_degree: the largest in-degree of the whole graph (the key-based
                samplers' loop bound, as in JAX)
    edge_id_bits: 32 (int32 global edge ids) or 64 (ids come back as int32
                (hi, lo) planes, ``ops/edge_ids.py``)
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    edge_base: np.ndarray
    book: PartitionBook
    mesh: Mesh
    weights: Optional[torch.Tensor] = None
    times: Optional[torch.Tensor] = None
    max_degree: Optional[int] = None
    edge_id_bits: int = 32

    @property
    def rows_per_shard(self) -> int:
        return self.book.shard_size

    @property
    def row_start(self) -> int:
        """The global id of this rank's first row."""
        return int(self.book.offsets[self.mesh.rank])

    @staticmethod
    def from_global_csr(indptr, indices, mesh: Optional[Mesh] = None, *, weights=None,
                        times=None, book: Optional[PartitionBook] = None,
                        edge_id_bits: Optional[int] = None) -> "DistGraph":
        """This rank's shard of a whole CSR (numpy arrays, or tensors on any
        device: a tensor already on the mesh's device is sliced in place).
        ``weights`` / ``times``: optional per-edge attributes in the CSR's
        edge order.  ``book``: default edge-balanced.  ``mesh``: default
        the card's (``create_store_mesh()``)."""
        mesh = mesh if mesh is not None else create_store_mesh()
        ip = _host(indptr).astype(np.int64)
        book = book or PartitionBook.edge_balanced(ip, mesh.world)
        _check_book(book, len(ip) - 1, mesh)
        lo, hi = int(book.offsets[mesh.rank]), int(book.offsets[mesh.rank + 1])
        e_lo, e_hi = int(ip[lo]), int(ip[hi])
        dev = mesh.device
        local_ip = torch.as_tensor((ip[lo:hi + 1] - e_lo).astype(np.int32), device=dev)
        return _assemble(local_ip, _slice(indices, e_lo, e_hi, dev, torch.int32),
                         ip[book.offsets[:-1]], int(ip[-1]),
                         int(np.diff(ip).max(initial=0)), book, mesh,
                         weights=None if weights is None else _slice(weights, e_lo, e_hi, dev),
                         times=None if times is None else _slice(times, e_lo, e_hi, dev),
                         edge_id_bits=edge_id_bits)

    @staticmethod
    def from_shard_files(edge_files, num_nodes: int, mesh: Optional[Mesh] = None, *,
                         weights_files=None, times_files=None,
                         book: Optional[PartitionBook] = None,
                         edge_id_bits: Optional[int] = None) -> "DistGraph":
        """This rank's shard from COO edge files, without the whole graph in
        memory.  edge_files: ``.npy`` paths, each an (E_k, 2) array of [src,
        dst] rows; their concatenation in order is the logical COO, and the
        shard equals ``from_global_csr`` of that COO's CSR (rows = dst, each
        row's edges in COO order) for the same book.  weights_files /
        times_files: per-edge ``.npy`` arrays aligned with edge_files.  The
        files are memory-mapped and streamed twice: the in-degree histogram
        (the book, the edge bases, the degree bound), then this rank's
        edges into place.  Every rank reads the files itself: no
        collective."""
        mesh = mesh if mesh is not None else create_store_mesh()
        files = [edge_files] if isinstance(edge_files, (str, bytes)) else list(edge_files)
        n = int(num_nodes)
        deg = np.zeros(n, np.int64)
        for f in files:
            dst = np.asarray(np.load(f, mmap_mode="r")[:, 1], np.int64)
            if dst.size and (dst.min() < 0 or dst.max() >= n):
                raise ValueError(f"{f}: destination ids outside [0, {n})")
            deg += np.bincount(dst, minlength=n)
        ip = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        book = book or PartitionBook.edge_balanced(ip, mesh.world)
        _check_book(book, n, mesh)
        lo, hi = int(book.offsets[mesh.rank]), int(book.offsets[mesh.rank + 1])
        local_ip = ip[lo:hi + 1] - ip[lo]
        indices = np.zeros(int(local_ip[-1]), np.int32)
        attrs = {}
        for name, afiles in (("w", weights_files), ("t", times_files)):
            if afiles is not None:
                attrs[name] = (list(afiles), np.zeros(len(indices),
                                                      np.load(afiles[0], mmap_mode="r").dtype))
        cursor = local_ip[:-1].copy()
        for k, f in enumerate(files):
            e = np.load(f, mmap_mode="r")
            dst = np.asarray(e[:, 1], np.int64)
            sel = np.flatnonzero((dst >= lo) & (dst < hi))
            if not len(sel):
                continue
            rows = dst[sel] - lo
            order = np.argsort(rows, kind="stable")   # each row's edges in file order
            rows_s = rows[order]
            run_start = np.r_[0, np.flatnonzero(np.diff(rows_s)) + 1]
            run_len = np.diff(np.r_[run_start, len(rows_s)])
            slot = cursor[rows_s] + np.arange(len(rows_s)) - np.repeat(run_start, run_len)
            indices[slot] = np.asarray(e[:, 0], np.int64)[sel][order]
            for afiles, out in attrs.values():
                out[slot] = np.asarray(np.load(afiles[k], mmap_mode="r"))[sel][order]
            cursor[rows_s[run_start]] += run_len
        dev = mesh.device
        return _assemble(torch.as_tensor(local_ip.astype(np.int32), device=dev),
                         torch.as_tensor(indices, device=dev), ip[book.offsets[:-1]],
                         int(ip[-1]), int(deg.max(initial=0)), book, mesh,
                         weights=_on(attrs.get("w", (None, None))[1], dev),
                         times=_on(attrs.get("t", (None, None))[1], dev),
                         edge_id_bits=edge_id_bits)

    @staticmethod
    def from_local_coo(src, dst, num_nodes: int, mesh: Optional[Mesh] = None, *,
                       weights=None, times=None, book: Optional[PartitionBook] = None,
                       chunk: int = 1 << 18,
                       edge_id_bits: Optional[int] = None) -> "DistGraph":
        """This rank's shard from every rank's own slice of the COO (src,
        dst host arrays; ``weights`` / ``times`` aligned with them): the
        slices go to their rows' owners (``store/edge_exchange.py``), so no
        rank holds the whole COO.  The logical COO is the slices in rank
        order, and the shard equals ``from_global_csr`` of its CSR for the
        same book.  Every rank calls it together."""
        mesh = mesh if mesh is not None else create_store_mesh()
        vals = {}
        if weights is not None:
            vals["w"] = _host(weights)
        if times is not None:
            vals["t"] = _host(times)
        book, shard = route_local_edges(_host(src), _host(dst), int(num_nodes), mesh,
                                        vals=vals or None, book=book, chunk=chunk)
        _check_book(book, int(num_nodes), mesh)
        lo, count = int(book.offsets[mesh.rank]), int(book.counts[mesh.rank])
        # a stable counting sort keeps each row's edges in global COO order
        ip, ix, perm = _native.build_csr(shard["dst"] - lo, shard["src"], count)
        mine = np.zeros(mesh.world, np.int64)
        mine[mesh.rank] = len(ix)
        counts_e = all_reduce_np(mine, mesh, "sum")
        max_deg = int(all_reduce_np([np.diff(ip).max(initial=0)], mesh, "max")[0])
        dev = mesh.device
        return _assemble(torch.as_tensor(ip.astype(np.int32), device=dev),
                         torch.as_tensor(ix, device=dev),
                         np.concatenate([[0], np.cumsum(counts_e)[:-1]]).astype(np.int64),
                         int(counts_e.sum()), max_deg, book, mesh,
                         weights=_on(shard["w"][perm] if "w" in shard else None, dev),
                         times=_on(shard["t"][perm] if "t" in shard else None, dev),
                         edge_id_bits=edge_id_bits)


def _check_book(book: PartitionBook, n: int, mesh: Mesh) -> None:
    if book.total != n or book.world_size != mesh.world:
        raise ValueError(f"the book covers {book.total} rows over {book.world_size} ranks; "
                         f"the graph has {n} rows over {mesh.world}")


def _slice(a, lo: int, hi: int, device, dtype=None) -> torch.Tensor:
    """a[lo:hi] of a numpy array or a tensor, on ``device`` (a view where
    the tensor is there already)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(np.asarray(a)[lo:hi]))
        lo, hi = 0, a.shape[0]
    return a[lo:hi].to(device=device, dtype=dtype)


def _on(a, device):
    return None if a is None else torch.as_tensor(a, device=device)


def _assemble(indptr, indices, bases, total_edges: int, max_deg: int, book, mesh, *,
              weights, times, edge_id_bits) -> DistGraph:
    """The constructors' shared tail: the edge-id width, checked."""
    if edge_id_bits is None:
        edge_id_bits = 32 if total_edges < 2**31 - 1 else 64
    if edge_id_bits == 32:
        if total_edges >= 2**31 - 1:
            raise ValueError(f"{total_edges} edges do not fit 32-bit edge ids")
    elif edge_id_bits == 64:
        per_shard = np.diff(np.append(bases, total_edges))
        if int(per_shard.max(initial=0)) >= MAX_LOCAL_EDGES:
            raise ValueError(f"a shard holds {int(per_shard.max())} edges >= 2**30; "
                             f"use more ranks (world {mesh.world})")
    else:
        raise ValueError(f"edge_id_bits must be 32 or 64, got {edge_id_bits}")
    for name, attr in (("weights", weights), ("times", times)):
        if attr is not None and attr.shape != indices.shape:
            raise ValueError(f"{name} need one entry per edge: got {tuple(attr.shape)} for "
                             f"{indices.shape[0]} edges")
    return DistGraph(indptr=indptr, indices=indices, edge_base=np.asarray(bases, np.int64),
                     book=book, mesh=mesh, weights=weights, times=times,
                     max_degree=int(max_deg), edge_id_bits=int(edge_id_bits))


def route_to_owners(graph: DistGraph, targets: torch.Tensor, seed_time=None):
    """A hop's first exchange: this rank's ``targets`` (-1 = padding, not
    sent) to the ranks that own them, with their seed times where given.
    Returns (the targets this rank received as local row offsets, -1 where
    it holds no such row; their times or None; the routing (perm, send
    sizes, receive sizes) that :func:`route_back` reverses)."""
    mesh, book = graph.mesh, graph.book
    sorted_ids, perm, counts = _bucket_by_owner(targets, book)
    req, send_sizes, recv_sizes = _ragged_a2a(sorted_ids, counts, mesh)
    req_time = None
    if seed_time is not None:
        req_time = alltoallv(seed_time[perm[:sum(send_sizes)]], send_sizes, recv_sizes, mesh)
    local = req - graph.row_start
    ok = (local >= 0) & (local < int(book.counts[mesh.rank]))
    return torch.where(ok, local, -1).to(torch.int32), req_time, (perm, send_sizes, recv_sizes)


def sample_owned(graph: DistGraph, local: torch.Tensor, fanout: int, *, req_time=None, u=None,
                 hash_key=None, generator=None) -> torch.Tensor:
    """The owner's one-hop sample of its received rows ``local`` (-1 = none):
    (n, fanout, 2) int32 [neighbors, global edge ids], or (n, fanout, 3)
    with the high plane of 64-bit edge ids, -1 padded (the high plane 0)."""
    if u is not None and tuple(u.shape) != (local.shape[0], fanout):
        raise ValueError(f"u must have shape {(local.shape[0], fanout)} (the rows this rank "
                         f"receives), got {tuple(u.shape)}")
    out = one_hop(graph.indptr, graph.indices, local, fanout, weights=graph.weights,
                  edge_times=graph.times, seed_time=req_time, max_degree=graph.max_degree,
                  u=u, hash_key=hash_key, generator=generator, device=graph.mesh.device)
    e = out.edge_ids
    rank = graph.mesh.rank
    if graph.edge_id_bits == 64:
        hi, lo = split_bases_np(graph.edge_base[rank:rank + 1])[0]
        ehi, elo = combine_local(e, int(hi), int(lo))
        return torch.stack([out.neighbors, elo, ehi], dim=-1)
    base = int(graph.edge_base[rank])
    return torch.stack([out.neighbors, torch.where(e >= 0, e + base, -1)], dim=-1)


def route_back(graph: DistGraph, blocks: torch.Tensor, routing,
               num_targets: int) -> torch.Tensor:
    """A hop's second exchange: the owners' (n, k, c) blocks back to the
    ranks that asked, in their targets' order; (num_targets, k, c), -1 (the
    high plane 0) for targets not sent."""
    perm, send_sizes, recv_sizes = routing
    back = alltoallv(blocks, recv_sizes, send_sizes, graph.mesh)
    out = blocks.new_full((num_targets,) + tuple(blocks.shape[1:]), -1)
    if blocks.shape[-1] == 3:
        out[..., 2] = 0
    out[perm[:sum(send_sizes)]] = back
    return out


class DistNeighborSampler:
    """Multi-hop sampling over a ``DistGraph``: each rank samples its own
    seeds (uniform, weighted with the graph's weights, temporal with its
    times and seed times), in the static layout (``dedup=False``, the
    default as in JAX) or deduplicated per rank (``dedup=True``, capped by
    ``max_unique_per_hop``).  Every rank calls ``sample`` together."""

    def __init__(self, graph: DistGraph, fanouts: Sequence[int], dedup: bool = False,
                 max_unique_per_hop: Optional[Sequence[int]] = None):
        if max_unique_per_hop is not None and not dedup:
            raise ValueError("capacity budgets need dedup=True")
        self.graph = graph
        self.fanouts = tuple(int(f) for f in fanouts)
        self.dedup = bool(dedup)
        self.max_unique_per_hop = (None if max_unique_per_hop is None
                                   else [int(c) for c in max_unique_per_hop])

    @property
    def device(self) -> torch.device:
        return self.graph.mesh.device

    def level_caps(self, local_batch: int) -> List[int]:
        """The size of every level of a rank's batch of ``local_batch``
        seeds."""
        caps = level_capacities(local_batch, self.fanouts)
        if self.max_unique_per_hop is not None:
            clamp_level_caps(caps, [f + 1 for f in self.fanouts], self.max_unique_per_hop)
        return caps

    def sample(self, seeds, node_times=None, *, u=None, hash_keys=None,
               generator=None) -> MultihopBatch:
        """This rank's batch for its ``seeds`` (B,) int32 (-1 padded).
        node_times: optional (B,) seed times (temporal sampling when the
        graph has times).  u[h]: optional hop-h uniforms, one row for each
        target this rank receives; hash_keys[h]: optional (k0, k1) of this
        rank's hop h; else drawn from ``generator``."""
        g = self.graph
        for draws in (u, hash_keys):
            if draws is not None and len(draws) != len(self.fanouts):
                raise ValueError(f"per-hop draws need one entry per hop: got {len(draws)} "
                                 f"for {len(self.fanouts)} fanouts")
        dev = self.device
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=dev)
        seed_time = None
        if g.times is not None and node_times is not None:
            seed_time = torch.as_tensor(node_times, device=dev)
        caps = self.level_caps(seeds.shape[0])
        levels, hops = [seeds], []
        for h, fanout in enumerate(self.fanouts):
            targets = levels[-1]
            t = targets.shape[0]
            local, req_time, routing = route_to_owners(g, targets, seed_time)
            blocks = sample_owned(g, local, fanout, req_time=req_time,
                                  u=None if u is None else torch.as_tensor(u[h], device=dev),
                                  hash_key=None if hash_keys is None else hash_keys[h],
                                  generator=generator)
            back = route_back(g, blocks, routing, t)
            nbrs = back[..., 0].contiguous()
            if self.dedup:
                uq = append_unique(targets, nbrs.reshape(-1), max_unique=caps[h + 1])
                neigh_local, nxt = uq.neighbor_map.view(t, fanout), uq.unique_nodes
            else:
                neigh_local, nxt = (a[0] for a in static_layout(targets[None], nbrs[None]))
            hops.append(HopBlock(neigh_local=neigh_local, neigh_global=nbrs,
                                 edge_ids=back[..., 1].contiguous(),
                                 edge_hi=back[..., 2].contiguous() if back.shape[-1] == 3
                                 else None))
            levels.append(nxt)
            if seed_time is not None:
                seed_time = propagate_times(seed_time[None], neigh_local[None],
                                            nxt.shape[0])[0]
        counts = torch.stack([(lv >= 0).sum(dtype=torch.int32) for lv in levels])
        dist.all_reduce(counts, group=g.mesh.group)
        _count(collectives=1)
        level_counts = list(counts.unbind())
        return MultihopBatch(levels=levels, level_counts=level_counts, hops=hops,
                             seed_count=level_counts[0], static_layout=not self.dedup,
                             num_shards=1)
