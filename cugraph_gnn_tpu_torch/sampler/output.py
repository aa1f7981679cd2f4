"""Sampler output structures: fixed-shape tensors padded with -1.

Counterpart of ``cugraph_gnn_tpu/sampler/output.py``.  Layout ("multihop
ELL"):

- ``levels[0]`` are the seeds; ``levels[l+1]`` holds the targets of hop l
  (``levels[l]``, as a prefix) and then the nodes sampled from them.
- ``hops[l]`` connects the targets in ``levels[l]`` to their sampled
  neighbors, as local indices into ``levels[l+1]``, in a (S_l, k_l) block.

A 2-layer GNN then runs input-side first:
``h_1 = conv(x[levels[2]], hops[1])``, ``h_0 = conv(h_1, hops[0])``.
Slots that are -1 carry garbage rows downstream; consumers mask with
``HopBlock.mask``.  :func:`to_coo` and :func:`to_csc` give PyG-style views
with per-hop counts.  Edge ids are int32; graphs beyond 2**31 edges carry
a high plane ``edge_hi`` beside them (``ops/edge_ids.py``: id = edge_hi *
2**30 + edge_ids), which the views carry along and ``edge_ids64`` combines
on the host.  It is None on 32-bit graphs, where ``edge_ids`` is the id.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch.ops.edge_ids import to_int64_np


def _int64_ids(hi, lo) -> np.ndarray:
    lo = lo.cpu().numpy()
    if hi is None:
        return lo.astype(np.int64)
    return to_int64_np(hi.cpu().numpy(), lo)


class HopBlock(NamedTuple):
    """Fixed-fanout bipartite block between level l (targets) and level
    l+1 (sources)."""

    neigh_local: torch.Tensor   # (S_l, k_l) int32 index into levels[l+1], -1 pad
    neigh_global: torch.Tensor  # (S_l, k_l) int32 global node ids, -1 pad
    edge_ids: torch.Tensor      # (S_l, k_l) int32 global edge ids, -1 pad
    # high int32 plane of 64-bit edge ids (None on 32-bit graphs)
    edge_hi: Optional[torch.Tensor] = None

    @property
    def mask(self):
        return self.neigh_local >= 0

    def edge_ids64(self) -> np.ndarray:
        """Host int64 global edge ids (either width), -1 pad."""
        return _int64_ids(self.edge_hi, self.edge_ids)


@dataclass
class MultihopBatch:
    """A sampled mini-batch with L hops.

    levels: list of (S_l,) int32 global node ids, -1 padded.
    level_counts: list of () int32 valid node counts per level.
    hops: list of L HopBlocks, hops[l] between levels[l] and levels[l+1].
    seed_count: () int32 number of valid seeds.
    static_layout: True when levels[l+1] = [targets | neighbors row-major]
      (the dedup=False layout), so neighbor activations are a free
      slice + reshape instead of a row gather.
    num_shards: blocks per level from a sharded sampler (1 here).

    The batched sampler returns every tensor with a leading step axis (S,
    ...); :meth:`step` takes one step's batch out of it.
    """

    levels: List[torch.Tensor]
    level_counts: List[torch.Tensor]
    hops: List[HopBlock]
    seed_count: torch.Tensor
    static_layout: bool = False
    num_shards: int = 1

    @property
    def num_hops(self) -> int:
        return len(self.hops)

    @property
    def input_nodes(self):
        """Deepest level: the nodes whose features must be gathered."""
        return self.levels[-1]

    def step(self, i: int) -> "MultihopBatch":
        """Step ``i`` of a batch with a leading step axis (the batched
        sampler's output): index every tensor with ``[i]``."""
        return MultihopBatch(
            levels=[a[i] for a in self.levels],
            level_counts=[a[i] for a in self.level_counts],
            hops=[HopBlock(*(None if a is None else a[i] for a in hop))
                  for hop in self.hops],
            seed_count=self.seed_count[i],
            static_layout=self.static_layout,
            num_shards=self.num_shards)

    def dst_activations(self, h, hop_index: int):
        """The level-l target rows of ``h``, the level-(l+1) activations."""
        s_l = self.hops[hop_index].neigh_local.shape[0]
        return shard_prefix(h, s_l, self.num_shards)

    def gather_neighbors(self, h, hop_index: int):
        """Neighbor activations (S_l, k, F) of hop l from the level-(l+1)
        activations ``h``; -1 slots carry garbage rows (mask with
        hops[l].mask).  A free slice + reshape in the static layout."""
        hop = self.hops[hop_index]
        s_l, k = hop.neigh_local.shape
        w = self.num_shards
        if self.static_layout and h.shape[0] == s_l * (k + 1):
            t_l, t_next = s_l // w, h.shape[0] // w
            body = h.reshape(w, t_next, h.shape[-1])[:, t_l:]
            return body.reshape(s_l, k, h.shape[-1])
        return shard_gather(h, hop.neigh_local, w)


def shard_prefix(h, s_l: int, num_shards: int = 1):
    """First s_l / W rows of each of W equal blocks of ``h`` (h[:s_l] when
    W == 1): per-shard levels put targets first."""
    if num_shards == 1:
        return h[:s_l]
    t_next = h.shape[0] // num_shards
    t_l = s_l // num_shards
    return h.reshape(num_shards, t_next, *h.shape[1:])[:, :t_l].reshape(
        s_l, *h.shape[1:])


def shard_gather(h, neigh_local, num_shards: int = 1):
    """h[neigh_local] with shard-relative indices: row i of neigh_local
    belongs to shard i // (S_l / W) and indexes that shard's block of ``h``.
    -1 indices read row 0 of the shard (callers mask)."""
    safe = neigh_local.clamp(min=0).long()
    if num_shards == 1:
        return h[safe]
    s_l = neigh_local.shape[0]
    t_next = h.shape[0] // num_shards
    t_l = s_l // num_shards
    off = (torch.arange(s_l, device=h.device) // t_l) * t_next
    return h[safe + off[:, None]]


class COOSample(NamedTuple):
    """PyG-style flattened sample: renumbered edges over the unique node
    list (the deepest level)."""

    node: torch.Tensor               # (N,) global node ids, -1 pad
    row: torch.Tensor                # (E,) local dst index, -1 pad
    col: torch.Tensor                # (E,) local src index, -1 pad
    edge: torch.Tensor               # (E,) global edge ids, -1 pad
    num_sampled_nodes: torch.Tensor  # (L+1,) nodes discovered per level
    num_sampled_edges: torch.Tensor  # (L,) valid edges per hop
    edge_hi: Optional[torch.Tensor] = None

    def edge_ids64(self) -> np.ndarray:
        """Host int64 global edge ids (either width), -1 pad."""
        return _int64_ids(self.edge_hi, self.edge)


class CSCSample(NamedTuple):
    """PyG-style CSC sample: per hop, the valid entries compacted to the
    front column by column; fixed-fanout rows compress to a ``colptr`` of
    the per-target counts."""

    node: torch.Tensor               # (N,) global node ids, -1 pad
    colptr: List[torch.Tensor]       # per hop: (S_l + 1,)
    row: List[torch.Tensor]          # per hop: (S_l * k_l,) local src ids
    edge: List[torch.Tensor]         # per hop: (S_l * k_l,) global edge ids
    num_sampled_nodes: torch.Tensor
    num_sampled_edges: torch.Tensor
    edge_hi: Optional[List[torch.Tensor]] = None

    def edge_ids64(self) -> List[np.ndarray]:
        """Per hop, host int64 global edge ids (either width), -1 pad."""
        his = self.edge_hi or [None] * len(self.edge)
        return [_int64_ids(h, e) for h, e in zip(his, self.edge)]


def _level_growth(batch: MultihopBatch) -> torch.Tensor:
    """Valid nodes per level that the level before did not hold."""
    counts = [batch.level_counts[0]] + [
        batch.level_counts[i + 1] - batch.level_counts[i]
        for i in range(batch.num_hops)]
    return torch.stack(counts)


def to_csc(batch: MultihopBatch) -> CSCSample:
    """CSC view of a one-step multihop batch (dst-major).  Valid entries are
    moved to the front by a stable sort, so ``row[colptr[i]:colptr[i+1]]``
    are column i's sources in slot order; slots past ``colptr[-1]`` are
    -1."""
    colptrs, rows, edges, his, n_edges = [], [], [], [], []
    for hop in batch.hops:
        m = hop.mask
        cnt = m.sum(dim=1, dtype=torch.int32)
        colptrs.append(torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0, dtype=torch.int32)]))
        flat_m = m.reshape(-1)
        order = torch.argsort((~flat_m).to(torch.int8), stable=True)
        rows.append(torch.where(flat_m, hop.neigh_local.reshape(-1), -1)[order])
        edges.append(torch.where(flat_m, hop.edge_ids.reshape(-1), -1)[order])
        if hop.edge_hi is not None:
            his.append(torch.where(flat_m, hop.edge_hi.reshape(-1), 0)[order])
        n_edges.append(m.sum(dtype=torch.int32))
    return CSCSample(node=batch.levels[-1], colptr=colptrs, row=rows, edge=edges,
                     num_sampled_nodes=_level_growth(batch),
                     num_sampled_edges=torch.stack(n_edges), edge_hi=his or None)


def to_coo(batch: MultihopBatch) -> COOSample:
    """A one-step multihop batch as PyG-style COO with per-hop counts: hop
    by hop, every slot row-major, -1 where masked."""
    rows, cols, edges, his, n_edges = [], [], [], [], []
    for hop in batch.hops:
        s, k = hop.neigh_local.shape
        m = hop.mask
        dst = torch.arange(s, dtype=torch.int32, device=m.device)[:, None].expand(s, k)
        rows.append(torch.where(m, dst, -1).reshape(-1))
        cols.append(torch.where(m, hop.neigh_local, -1).reshape(-1))
        edges.append(torch.where(m, hop.edge_ids, -1).reshape(-1))
        if hop.edge_hi is not None:
            his.append(torch.where(m, hop.edge_hi, 0).reshape(-1))
        n_edges.append(m.sum(dtype=torch.int32))
    return COOSample(node=batch.levels[-1], row=torch.cat(rows), col=torch.cat(cols),
                     edge=torch.cat(edges), num_sampled_nodes=_level_growth(batch),
                     num_sampled_edges=torch.stack(n_edges),
                     edge_hi=torch.cat(his) if his else None)
