"""Heterogeneous multi-hop neighbor sampling (a fanout per edge type).

Counterpart of ``cugraph_gnn_tpu/sampler/hetero.py``.  Nodes live in one
global id space (per-type offsets, ``data/graph_store.py``); each edge type
has its own reversed CSR and fanout schedule.  A hop samples every edge type
from the current level and either deduplicates the union (``dedup=True``:
``ops/unique.py::append_unique``, one node level shared by all types) or
lays it out statically, [targets | type 1's neighbors row-major | type 2's
| ...], so renumbering is position arithmetic.  Each hop's result is one
``HopBlock`` per edge type (what ``RGCNConv`` consumes).

``hetero_multihop_batched`` samples S steps as one flattened frontier per hop
per edge type (one launch of the uniform kernel each).  With typed target
segments (``seed_type``, ``dst_types``, ``src_types``) each edge type expands
only the level positions of its destination type, and the layout entries
carry a segment plan, ((segment_length, covered), ...), by which
``RGCNConv.typed_call`` puts each relation's aggregate back at its rows.

Draws can be injected so that tests replay the JAX ones, keyed by hop and
edge type: ``u[h][name]``, the uniforms of hop h's edge type ``name``
(``jax.random.uniform(fold_in(fold_in(key, h), ei), (targets, fanout))``,
``ei`` the type's index in ``etype_names``), and ``hash_keys[h][name]``, the
key words of its weighted or time-masked hop (the last two words of
``key_data(fold_in(hop_key, 0))``, or ``..., 1)`` for the masked one).
Without them the draws come from ``generator``.  JAX's ``pad_to_lines`` (TPU
line padding) is not ported: the port's kernel reads ``indices`` directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.unique import append_unique, append_unique_rows
from cugraph_gnn_tpu_torch.sampler.heuristics import clamp_level_caps
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import one_hop, propagate_times
from cugraph_gnn_tpu_torch.sampler.output import HopBlock, shard_gather, shard_prefix


def etype_str(et) -> str:
    return "__".join(et) if isinstance(et, tuple) else str(et)


@dataclass
class HeteroMultihopBatch:
    """A sampled hetero mini-batch.

    levels / level_counts / seed_count: as ``MultihopBatch``'s.
    hops: per hop, edge-type name -> HopBlock.
    num_shards: blocks per level (> 1 for a flattened disjoint batch).
    layouts: per hop, the static layout's entries (name, start, fanout) or,
      with typed segments, (name, start, fanout, plan); () for deduplicated
      levels.  Neighbor activations are then a contiguous slice.

    The batched sampler returns every tensor with a leading step axis;
    :meth:`step` takes one step's batch out of it.
    """

    levels: List[torch.Tensor]
    level_counts: List[torch.Tensor]
    hops: List[Dict[str, HopBlock]]
    seed_count: torch.Tensor
    num_shards: int = 1
    layouts: tuple = ()

    @property
    def num_hops(self) -> int:
        return len(self.hops)

    @property
    def static_layout(self) -> bool:
        return bool(self.layouts)

    @property
    def input_nodes(self):
        return self.levels[-1]

    def step(self, i: int) -> "HeteroMultihopBatch":
        """Step ``i`` of a batch with a leading step axis."""
        return HeteroMultihopBatch(
            levels=[a[i] for a in self.levels],
            level_counts=[a[i] for a in self.level_counts],
            hops=[{k: HopBlock(*(None if a is None else a[i] for a in b))
                   for k, b in hop.items()} for hop in self.hops],
            seed_count=self.seed_count[i], num_shards=self.num_shards,
            layouts=self.layouts)

    def dst_activations(self, h, hop_index: int):
        """The level-l target rows of the level-(l+1) activations ``h``."""
        if self.layouts:
            # a typed block covers only its segment: the level is the width
            s_l = self.levels[hop_index].shape[-1]
        else:
            s_l = next(iter(self.hops[hop_index].values())).neigh_local.shape[0]
        return shard_prefix(h, s_l, self.num_shards)

    def gather_neighbors(self, h, hop_index: int, etype: str):
        """Neighbor activations (S_e, k, F) of edge type ``etype``'s block of
        hop l (mask with the block's mask): a contiguous slice in the static
        layout, else a row gather."""
        blk = self.hops[hop_index][etype]
        if self.layouts and self.num_shards == 1:
            for entry in self.layouts[hop_index]:
                if entry[0] == etype:
                    start, fanout = entry[1], entry[2]
                    t = blk.neigh_local.shape[0]
                    if h.shape[0] >= start + t * fanout:
                        return h[start:start + t * fanout].reshape(t, fanout, *h.shape[1:])
        return shard_gather(h, blk.neigh_local, self.num_shards)


def _draw(draws, h: int, name: str):
    return None if draws is None else draws[h].get(name)


class HeteroNeighborSampler:
    """Per-edge-type sampler over a ``data.graph_store.SamplingGraph``.

    fanouts: one list for every edge type, or {edge_type: list} (PyG's
    fanout dict; types left out, or given None, are not sampled).
    weights_by_etype / times_by_etype: optional {edge_type: per-edge tensor
    in CSR order}: weighted / temporal sampling per edge type.
    max_unique_per_hop: per-hop caps on the deduplicated levels (dedup only).
    seed_type: the seeds' node type, for typed target segments (dedup=False).
    Runs on the graph's device.
    """

    def __init__(self, graph, fanouts: Union[Sequence[int], Dict],
                 weights_by_etype: Optional[Dict] = None,
                 times_by_etype: Optional[Dict] = None,
                 max_unique_per_hop: Optional[Sequence[int]] = None,
                 dedup: bool = True, seed_type: Optional[str] = None):
        self.graph = graph
        self.device = graph.device
        self.etypes = list(graph.etypes)
        self.etype_names = [etype_str(et) for et in self.etypes]
        self.seed_type = seed_type
        self.dst_types = self.src_types = None
        if seed_type is not None:
            if dedup:
                raise ValueError("seed_type (typed segments) requires dedup=False")
            if not all(isinstance(et, tuple) and len(et) == 3 for et in self.etypes):
                raise ValueError("typed segments need (src, rel, dst) edge-type tuples")
            self.dst_types = {etype_str(et): et[2] for et in self.etypes}
            self.src_types = {etype_str(et): et[0] for et in self.etypes}
        self.weights = {etype_str(k): torch.as_tensor(v, device=self.device)
                        for k, v in (weights_by_etype or {}).items()}
        self.times = {etype_str(k): torch.as_tensor(v, device=self.device)
                      for k, v in (times_by_etype or {}).items()}
        if isinstance(fanouts, dict):
            norm = {etype_str(k): None if v is None else [int(x) for x in v]
                    for k, v in fanouts.items()}
            self.fanouts = {n: norm.get(n) for n in self.etype_names}
            lens = {len(v) for v in self.fanouts.values() if v is not None}
            if len(lens) != 1:
                raise ValueError("every edge type needs the same number of hops")
            self.num_hops = lens.pop()
        else:
            f = [int(x) for x in fanouts]
            self.fanouts = {n: f for n in self.etype_names}
            self.num_hops = len(f)
        if not dedup and max_unique_per_hop is not None:
            raise ValueError("capacity budgets (max_unique_per_hop) need dedup=True: "
                             "dedup=False has fixed positional capacities")
        self.max_unique_per_hop = max_unique_per_hop
        self.dedup = dedup

    def level_caps(self, batch_size: int) -> List[int]:
        """The size of every level for a batch of ``batch_size`` seeds: each
        target grows by 1 + the sum of its edge types' fanouts, capped by
        ``max_unique_per_hop``."""
        growth = [1 + sum((self.fanouts[n] or [0] * self.num_hops)[h]
                          for n in self.etype_names) for h in range(self.num_hops)]
        caps = [batch_size]
        for g in growth:
            caps.append(caps[-1] * g)
        if self.max_unique_per_hop is not None:
            clamp_level_caps(caps, growth, [int(x) for x in self.max_unique_per_hop])
        return caps

    def _graph_args(self):
        g = self.graph
        return dict(
            csrs={etype_str(et): g.csr_by_etype[et][:2] for et in self.etypes},
            etype_names=self.etype_names, fanouts=self.fanouts,
            edge_bases={etype_str(et): g.csr_by_etype[et][2] for et in self.etypes},
            max_degrees={etype_str(et): g.max_degree_by_etype[et] for et in self.etypes})

    def sample_rows(self, seeds, seed_time, caps, *, u=None, hash_keys=None,
                    generator=None):
        """The hops of R independent batches, one per row of ``seeds`` (R,
        T0), each deduplicated in its own namespace, sampled as one flat
        frontier per hop per edge type (the sampler must have dedup=True).
        u[h][name]: (R * caps[h], fanout); hash_keys[h][name]: (2,), or (R,
        2) with R > 1, one key per row.  Returns (levels, hops)."""
        if not self.dedup:
            raise ValueError("sample_rows deduplicates each row: it needs dedup=True")
        return _sample_rows(seeds, seed_time, caps, weights=self.weights, times=self.times,
                            u=u, hash_keys=hash_keys, generator=generator,
                            **self._graph_args())

    def sample(self, seeds, node_times=None, *, u=None, hash_keys=None,
               generator=None) -> HeteroMultihopBatch:
        """A hetero batch for ``seeds`` (B,) int32, -1 padded; node_times
        optional (B,) seed times (temporal with ``times_by_etype``)."""
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=self.device)
        return hetero_multihop(
            seeds, caps=self.level_caps(seeds.shape[0]), weights=self.weights,
            times=self.times, node_times=node_times, dedup=self.dedup,
            seed_type=self.seed_type, dst_types=self.dst_types,
            src_types=self.src_types, u=u, hash_keys=hash_keys, generator=generator,
            device=self.device, **self._graph_args())


def _edge_ids(out_ids, base: int):
    return torch.where(out_ids >= 0, out_ids + base, -1).to(torch.int32)


def _sample_rows(seeds, seed_time, caps, *, csrs, etype_names, fanouts, edge_bases,
                 max_degrees, weights, times, u, hash_keys, generator):
    """The deduplicated hop loop of ``hetero_multihop`` for R rows of seeds
    (R, T0), each its own batch.  seed_time: None or (R, T0).  Returns
    (levels (R, cap) each, hops of per-type HopBlocks of (R, cap, k))."""
    r = seeds.shape[0]
    dev = seeds.device
    levels = [seeds]
    hops = []
    for h in range(len(caps) - 1):
        targets = levels[-1]
        t = targets.shape[1]
        flat = targets.reshape(-1)
        st = None if seed_time is None else seed_time.reshape(-1)
        per_type = {}
        for name in etype_names:
            fan = fanouts[name]
            if fan is None or fan[h] <= 0:
                continue
            k = fan[h]
            w, tm = weights.get(name), times.get(name)
            hk = _draw(hash_keys, h, name)
            if r > 1 and (w is not None or (tm is not None and st is not None)):
                if hk is None:        # each row its own stream, as JAX's split keys
                    hk = torch.randint(0, 1 << 32, (r, 2), generator=generator,
                                       device=dev, dtype=torch.int64)
                hk = torch.as_tensor(hk, device=dev).repeat_interleave(t, dim=0)
            indptr, indices = csrs[name]
            out = one_hop(indptr, indices, flat, k, weights=w, edge_times=tm, seed_time=st,
                          max_degree=max_degrees[name], u=_draw(u, h, name),
                          hash_key=hk, generator=generator, device=dev)
            per_type[name] = (out.neighbors.view(r, t, k),
                              _edge_ids(out.edge_ids, edge_bases[name]).view(r, t, k))
        flat_nb = torch.cat([nb.reshape(r, -1) for nb, _ in per_type.values()], dim=1) \
            if per_type else torch.zeros((r, 0), dtype=torch.int32, device=dev)
        if r == 1:
            uq = append_unique(targets[0], flat_nb[0], max_unique=caps[h + 1])
            nmap, nxt = uq.neighbor_map[None], uq.unique_nodes[None]
        else:
            uq = append_unique_rows(targets, flat_nb, max_unique=caps[h + 1])
            nmap, nxt = uq.neighbor_map, uq.unique_nodes
        blocks, off = {}, 0
        for name, (nb, eid) in per_type.items():
            n = nb.shape[1] * nb.shape[2]
            blocks[name] = HopBlock(nmap[:, off:off + n].reshape(nb.shape), nb, eid)
            off += n
        hops.append(blocks)
        levels.append(nxt)
        if seed_time is not None:
            seed_time = _propagate(seed_time, blocks, nxt.shape[1])
    return levels, hops


def _propagate(seed_time, blocks, width: int):
    """A sampled node inherits the earliest time of the targets that drew
    it, over every edge type: the next level's times (R, width)."""
    r, t = seed_time.shape
    loc = torch.cat([b.neigh_local for b in blocks.values()], dim=2) if blocks \
        else torch.full((r, t, 1), -1, dtype=torch.int32, device=seed_time.device)
    return propagate_times(seed_time, loc, width)


def hetero_multihop(seeds, *, csrs, etype_names, fanouts, edge_bases, max_degrees, caps,
                    weights=None, times=None, node_times=None, dedup: bool = True,
                    seed_type=None, dst_types=None, src_types=None, u=None,
                    hash_keys=None, generator=None, device=None) -> HeteroMultihopBatch:
    """Heterogeneous multi-hop sample of one batch with explicit graph
    arguments: ``csrs`` maps edge-type name -> (indptr, indices) tensors,
    ``etype_names`` fixes the iteration order, ``fanouts`` maps name ->
    per-hop list (None or 0 skips a type that hop), ``edge_bases`` the
    offsets added to each type's edge ids, ``max_degrees`` the keyed
    samplers' loop bounds, ``caps`` the level sizes.  weights / times:
    optional name -> per-edge tensors.  seeds (B,) int32, -1 = padding.
    Runs on ``device`` (default: the card).

    The static layout (``dedup=False``) is step 0 of
    :func:`hetero_multihop_batched` (the same draws); typed segments
    (``dst_types``) need it untimed.  Otherwise each hop samples every edge
    type from every target and the levels are deduplicated, with seed times
    propagated by a scatter-min.
    """
    dev = resolve_device(device)
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=dev)
    weights, times = weights or {}, times or {}
    if dst_types is not None and (dedup or times or node_times is not None):
        raise ValueError("typed target segments need dedup=False and non-temporal "
                         "sampling (the static layout)")
    st = None if node_times is None else torch.as_tensor(node_times, device=dev)[None]
    graph = dict(csrs=csrs, etype_names=etype_names, fanouts=fanouts,
                 edge_bases=edge_bases, max_degrees=max_degrees)
    if not dedup:
        return hetero_multihop_batched(
            seeds[None], caps=caps, weights=weights, times=times, seed_time=st,
            seed_type=seed_type, dst_types=dst_types, src_types=src_types, u=u,
            hash_keys=hash_keys, generator=generator, device=dev, **graph).step(0)
    levels, hops = _sample_rows(seeds[None], st, caps, weights=weights, times=times, u=u,
                                hash_keys=hash_keys, generator=generator, **graph)
    levels = [lv[0] for lv in levels]
    counts = [(lv >= 0).sum(dtype=torch.int32) for lv in levels]
    return HeteroMultihopBatch(
        levels=levels, level_counts=counts,
        hops=[{k: HopBlock(*(a[0] for a in b[:3])) for k, b in hop.items()} for hop in hops],
        seed_count=counts[0])


def hetero_multihop_batched(seeds, *, csrs, etype_names, fanouts, edge_bases,
                            max_degrees=None, caps=None, weights=None, times=None,
                            seed_time=None, seed_type=None, dst_types=None,
                            src_types=None, u=None, hash_keys=None, generator=None,
                            device=None) -> HeteroMultihopBatch:
    """S independent hetero batches sampled as one flattened frontier per
    hop per edge type: seeds (S, B) int32, -1 padded.  Every tensor of the
    result has a leading step axis; ``batch.step(s)`` is step s's static
    layout [targets | per-type blocks row-major].  ``caps`` only gives the
    hop count (the layout's sizes are positional).  Weighted hops take one
    key for the whole flattened batch, as JAX's one fold_in per (hop, edge
    type) does.  times / seed_time: per-edge times by edge type and the
    seeds' times (S, B): time-masked hops, and seed times propagated by a
    scatter-min (untyped only).

    Typed target segments (``seed_type``, ``dst_types``, ``src_types``: the
    seeds' type and each edge type's destination and source node types):
    each edge type samples only the level positions of its destination type,
    and its layout entry carries the segment plan (tuple of (segment_length,
    covered) over the level's segments, in order).  u[h][name]: (S *
    targets of that type, fanout).  Runs on ``device`` (default: the card).
    """
    dev = resolve_device(device)
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=dev)
    weights, times = weights or {}, times or {}
    num_hops = (len(caps) - 1 if caps is not None
                else len(next(f for f in fanouts.values() if f)))
    typed = dst_types is not None
    if typed and (seed_type is None or src_types is None):
        raise ValueError("typed sampling needs seed_type, dst_types and src_types")
    if typed and seed_time is not None:
        raise ValueError("typed target segments need non-temporal sampling")
    s_steps, batch = seeds.shape
    levels = [seeds]
    segments = [(0, batch, seed_type)]     # (start, length, node type) of the level
    layouts, hops = [], []
    for h in range(num_hops):
        targets = levels[-1]
        t = targets.shape[1]
        st = None if seed_time is None else seed_time.reshape(-1)
        per_type = {}
        for name in etype_names:
            fan = fanouts[name]
            if fan is None or fan[h] <= 0:
                continue
            if typed:
                segs = [(a, n) for a, n, ty in segments if ty == dst_types[name]]
                t_e = sum(n for _, n in segs)
                if t_e == 0:
                    continue
                targets_e = (targets[:, segs[0][0]:segs[0][0] + segs[0][1]] if len(segs) == 1
                             else torch.cat([targets[:, a:a + n] for a, n in segs], dim=1))
                plan = tuple((n, ty == dst_types[name]) for _, n, ty in segments)
            else:
                targets_e, t_e, plan = targets, t, None
            k = fan[h]
            indptr, indices = csrs[name]
            out = one_hop(indptr, indices, targets_e.reshape(-1), k, weights=weights.get(name),
                          edge_times=times.get(name), seed_time=st,
                          max_degree=None if max_degrees is None else max_degrees[name],
                          u=_draw(u, h, name), hash_key=_draw(hash_keys, h, name),
                          generator=generator, device=dev)
            per_type[name] = (out.neighbors.view(s_steps, t_e, k),
                              _edge_ids(out.edge_ids, edge_bases[name]).view(s_steps, t_e, k),
                              plan)
        blocks, layout, parts, new_segs = {}, [], [targets], []
        pos_start = t
        for name, (nb, eid, plan) in per_type.items():
            t_e, k = nb.shape[1], nb.shape[2]
            pos = pos_start + torch.arange(t_e * k, dtype=torch.int32,
                                           device=dev).reshape(t_e, k)
            blocks[name] = HopBlock(torch.where(nb >= 0, pos, -1), nb, eid)
            layout.append((name, pos_start, k) if plan is None
                          else (name, pos_start, k, plan))
            parts.append(nb.reshape(s_steps, t_e * k))
            if typed:
                new_segs.append((pos_start, t_e * k, src_types[name]))
            pos_start += t_e * k
        hops.append(blocks)
        layouts.append(tuple(layout))
        segments = segments + new_segs
        levels.append(torch.cat(parts, dim=1))
        if seed_time is not None:
            seed_time = _propagate(seed_time, blocks, levels[-1].shape[1])
    counts = [(lv >= 0).sum(dim=1, dtype=torch.int32) for lv in levels]
    return HeteroMultihopBatch(levels=levels, level_counts=counts, hops=hops,
                               seed_count=counts[0], layouts=tuple(layouts))
