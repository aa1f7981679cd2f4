"""Heterogeneous distributed sampling over row-sharded per-edge-type CSRs.

Counterpart of ``cugraph_gnn_tpu/sampler/hetero_dist.py`` (the reference's
heterogeneous multi-GPU sampling).  Every edge type's reversed CSR is indexed
by the global node id, so all edge types share one even row book over the
global ids: each edge type is a ``DistGraph`` of its own over the same mesh
and book (``HeteroDistGraph``).

A hop (``HeteroDistNeighborSampler``) routes the level's targets (and their
seed times) to their owners once (``dist_sampler.route_to_owners``), samples
every edge type there (``sample_owned``: row 2's kernel for a uniform edge
type, the key-based samplers for a weighted or timed one), sends the edge
types' blocks back together in one exchange (``route_back`` of the blocks
laid side by side), adds each type's edge-id base (folded into the (hi, lo)
planes with a carry for 64-bit ids) and deduplicates the union of the
neighbors on this rank (``append_unique``: dedup is always on, as in JAX).
JAX routes the targets once per edge type; they are the same targets to the
same owners under one book, so the port routes them once per hop, which
gives the same rows with a third of the exchanges for three edge types.

Every rank samples its own seeds: its ``HeteroMultihopBatch`` has
``num_shards = 1`` and global ``level_counts`` (one all-reduce), as the
homogeneous ``DistNeighborSampler``'s.  Draws are injectable per hop and edge
type in the owner's frame (the targets this rank receives, sender by
sender): ``u[h][name]`` and ``hash_keys[h][name]``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from cugraph_gnn_tpu_torch.data.graph_store import _host
from cugraph_gnn_tpu_torch.ops.edge_ids import EDGE_LO_BITS, EDGE_LO_MOD
from cugraph_gnn_tpu_torch.ops.unique import append_unique
from cugraph_gnn_tpu_torch.parallel.mesh import Mesh, create_store_mesh
from cugraph_gnn_tpu_torch.sampler.dist_sampler import (
    DistGraph,
    route_back,
    route_to_owners,
    sample_owned,
)
from cugraph_gnn_tpu_torch.sampler.hetero import HeteroMultihopBatch, etype_str
from cugraph_gnn_tpu_torch.sampler.heuristics import clamp_level_caps
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import propagate_times
from cugraph_gnn_tpu_torch.sampler.output import HopBlock
from cugraph_gnn_tpu_torch.store.dist_array import _count, all_reduce_np
from cugraph_gnn_tpu_torch.store.partition import PartitionBook


def _edge_id_bits(total_edges: int, edge_id_bits: Optional[int]) -> int:
    """The combined edge ids' width: 32 when they fit int32 (default), else
    64; a forced 32 that does not fit raises."""
    if edge_id_bits is None:
        edge_id_bits = 32 if total_edges < 2**31 - 1 else 64
    if edge_id_bits == 32 and total_edges >= 2**31 - 1:
        raise ValueError(f"{total_edges} combined hetero edges do not fit 32-bit edge ids")
    return int(edge_id_bits)


def _by_name(d: Optional[Dict]) -> Dict[str, object]:
    return {etype_str(k): v for k, v in (d or {}).items()}


class HeteroDistGraph:
    """Per-edge-type row-sharded CSRs sharing one even book over the global
    node ids.

    graphs: edge-type name -> this rank's ``DistGraph`` of that type
    edge_base_by_etype: name -> the type's first global edge id
    edge_id_bits: 32, or 64 (sampled edge ids come back as int32 (hi, lo)
      planes, ``HopBlock.edge_hi``, with the type's base folded in)
    """

    def __init__(self, graphs: Dict[str, DistGraph], edge_base_by_etype: Dict[str, int],
                 mesh: Mesh, edge_id_bits: int = 32):
        self.graphs = graphs
        self.edge_base_by_etype = edge_base_by_etype
        self.mesh = mesh
        self.edge_id_bits = edge_id_bits
        self.book = next(iter(graphs.values())).book

    @staticmethod
    def from_sampling_graph(graph, mesh: Optional[Mesh] = None,
                            weights_by_etype: Optional[Dict] = None,
                            times_by_etype: Optional[Dict] = None,
                            edge_id_bits: Optional[int] = None) -> "HeteroDistGraph":
        """This rank's shards of a ``data.graph_store.SamplingGraph`` (a
        finalized store's CSRs).  weights / times: {edge type: per-edge
        array in CSR order}.  ``edge_id_bits``: forced width (default: 32
        when every type's base + count fits int32, else 64)."""
        mesh = mesh if mesh is not None else create_store_mesh()
        wbe, tbe = _by_name(weights_by_etype), _by_name(times_by_etype)
        book = PartitionBook.even(graph.num_nodes_total, mesh.world)
        total = max((int(base) + int(_host(ip)[-1])
                     for ip, _, base in graph.csr_by_etype.values()), default=0)
        bits = _edge_id_bits(total, edge_id_bits)
        graphs, ebase = {}, {}
        for et in graph.etypes:
            name = etype_str(et)
            indptr, indices, base = graph.csr_by_etype[et]
            n = int(_host(indptr)[-1])
            graphs[name] = DistGraph.from_global_csr(
                indptr, indices[:n], mesh, weights=_trim(wbe.get(name), n),
                times=_trim(tbe.get(name), n), book=book, edge_id_bits=bits)
            ebase[name] = int(base)
        return HeteroDistGraph(graphs, ebase, mesh, bits)

    @staticmethod
    def from_local_coo(edges_by_etype: Dict, num_nodes_total: int,
                       mesh: Optional[Mesh] = None,
                       weights_by_etype: Optional[Dict] = None,
                       times_by_etype: Optional[Dict] = None,
                       edge_id_bits: Optional[int] = None,
                       chunk: int = 1 << 18) -> "HeteroDistGraph":
        """This rank's shards from every rank's own slice of each edge type's
        COO, ``{edge type: (src, dst)}`` in global (offset) node ids: each
        type's slices go to their rows' owners (``DistGraph.from_local_coo``)
        under the one even book, so no rank holds a whole COO.  The edge-id
        bases follow the sorted type names over the per-type totals summed
        over the ranks (one all-reduce).  Every rank calls it together."""
        mesh = mesh if mesh is not None else create_store_mesh()
        wbe, tbe = _by_name(weights_by_etype), _by_name(times_by_etype)
        edges = {etype_str(k): (_host(s), _host(d)) for k, (s, d) in edges_by_etype.items()}
        names = sorted(edges)
        book = PartitionBook.even(int(num_nodes_total), mesh.world)
        counts = all_reduce_np([len(edges[n][0]) for n in names], mesh, "sum")
        bits = _edge_id_bits(int(counts.sum()), edge_id_bits)
        bases = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        graphs, ebase = {}, {}
        for name, base in zip(names, bases):
            src, dst = edges[name]
            graphs[name] = DistGraph.from_local_coo(
                src, dst, int(num_nodes_total), mesh, weights=wbe.get(name),
                times=tbe.get(name), book=book, chunk=chunk, edge_id_bits=bits)
            ebase[name] = int(base)
        return HeteroDistGraph(graphs, ebase, mesh, bits)


def _trim(attr, n: int):
    return None if attr is None else attr[:n]


def _add_base(block: torch.Tensor, base: int, bits: int):
    """(edge ids, high plane or None) of a routed block's edge columns with
    the type's ``base`` added; -1 (both planes) where no edge was drawn."""
    lo = block[..., 1]
    valid = lo >= 0
    if bits == 32:
        return torch.where(valid, lo + base, -1), None
    bh, bl = divmod(int(base), EDGE_LO_MOD)
    lo = lo + bl                      # < 2**31: both terms are below 2**30
    carry = (lo >= EDGE_LO_MOD).to(lo.dtype)
    lo = lo - (carry << EDGE_LO_BITS)
    hi = block[..., 2] + bh + carry
    return torch.where(valid, lo, -1), torch.where(valid, hi, -1)


class HeteroDistNeighborSampler:
    """Multi-hop heterogeneous sampling over a ``HeteroDistGraph``: every
    rank calls ``sample`` together on its own seeds.

    fanouts: one list for every edge type, or {edge type: list} (PyG's
    fanout dict: a type left out, given None, or given 0 at a hop is not
    sampled there).  Temporal: seed times ride the targets' exchange, and
    each edge type with times applies them.  max_unique_per_hop: caps on
    the deduplicated levels.
    """

    def __init__(self, graph: HeteroDistGraph, fanouts: Union[Sequence[int], Dict],
                 max_unique_per_hop: Optional[Sequence[int]] = None):
        self.graph = graph
        self.enames = sorted(graph.graphs)
        if isinstance(fanouts, dict):
            norm = {etype_str(k): None if v is None else [int(x) for x in v]
                    for k, v in fanouts.items()}
            self.fanouts = {e: norm.get(e) for e in self.enames}
        else:
            self.fanouts = {e: [int(x) for x in fanouts] for e in self.enames}
        lens = {len(v) for v in self.fanouts.values() if v is not None}
        if len(lens) != 1:
            raise ValueError("every edge type needs the same number of hops")
        self.num_hops = lens.pop()
        self.max_unique_per_hop = (None if max_unique_per_hop is None
                                   else [int(c) for c in max_unique_per_hop])

    @property
    def device(self) -> torch.device:
        return self.graph.mesh.device

    def fanout(self, name: str, h: int) -> int:
        """Edge type ``name``'s fanout at hop h (0: not sampled)."""
        f = self.fanouts[name]
        return 0 if f is None else f[h]

    def level_caps(self, local_batch: int) -> List[int]:
        """The size of every level of a rank's batch of ``local_batch``
        seeds: a target grows by 1 + the sum of the types' fanouts."""
        growth = [1 + sum(self.fanout(e, h) for e in self.enames)
                  for h in range(self.num_hops)]
        caps = [local_batch]
        for g in growth:
            caps.append(caps[-1] * g)
        if self.max_unique_per_hop is not None:
            clamp_level_caps(caps, growth, self.max_unique_per_hop)
        return caps

    def sample(self, seeds, node_times=None, *, u=None, hash_keys=None,
               generator=None) -> HeteroMultihopBatch:
        """This rank's batch for its ``seeds`` (B,) int32 (global ids, -1
        padded).  node_times: optional (B,) seed times.  u[h][name]:
        optional uniforms of hop h's type ``name``, one row per target this
        rank receives; hash_keys[h][name]: optional (k0, k1) of a weighted or
        timed type; else drawn from ``generator``."""
        g = self.graph
        dev = self.device
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=dev)
        timed = any(dg.times is not None for dg in g.graphs.values())
        seed_time = (torch.as_tensor(node_times, device=dev)
                     if timed and node_times is not None else None)
        caps = self.level_caps(seeds.shape[0])
        first = g.graphs[self.enames[0]]
        levels, hops = [seeds], []
        for h in range(self.num_hops):
            targets = levels[-1]
            t = targets.shape[0]
            names = [e for e in self.enames if self.fanout(e, h) > 0]
            blocks = {}
            if names:
                local, req_time, routing = route_to_owners(first, targets, seed_time)
                owned = [sample_owned(g.graphs[e], local, self.fanout(e, h), req_time=req_time,
                                      u=None if u is None else u[h].get(e),
                                      hash_key=None if hash_keys is None
                                      else hash_keys[h].get(e),
                                      generator=generator) for e in names]
                back = route_back(first, torch.cat(owned, dim=1), routing, t)
                start = 0
                for e in names:
                    k = self.fanout(e, h)
                    blk = back[:, start:start + k]
                    start += k
                    eids, ehi = _add_base(blk, g.edge_base_by_etype[e], g.edge_id_bits)
                    blocks[e] = (blk[..., 0].contiguous(), eids.contiguous(),
                                 None if ehi is None else ehi.contiguous())
            flat = (torch.cat([b[0].reshape(-1) for b in blocks.values()]) if blocks
                    else targets.new_zeros((0,)))
            uq = append_unique(targets, flat, max_unique=caps[h + 1])
            hop, off = {}, 0
            for e, (nbrs, eids, ehi) in blocks.items():
                n = nbrs.numel()
                hop[e] = HopBlock(uq.neighbor_map[off:off + n].view(nbrs.shape), nbrs, eids,
                                  ehi)
                off += n
            hops.append(hop)
            levels.append(uq.unique_nodes)
            if seed_time is not None:
                loc = (torch.cat([b.neigh_local for b in hop.values()], dim=1) if hop
                       else targets.new_full((t, 1), -1))
                seed_time = propagate_times(seed_time[None], loc[None],
                                            uq.unique_nodes.shape[0])[0]
        counts = torch.stack([(lv >= 0).sum(dtype=torch.int32) for lv in levels])
        dist.all_reduce(counts, group=g.mesh.group)
        _count(collectives=1)
        level_counts = list(counts.unbind())
        return HeteroMultihopBatch(levels=levels, level_counts=level_counts, hops=hops,
                                   seed_count=level_counts[0], num_shards=1)
