"""Multi-hop neighbor sampling: uniform, weighted and temporal, in the
static (dedup=False) layout or the deduplicated one, and the
``NeighborSampler`` class.

Counterpart of ``cugraph_gnn_tpu/sampler/neighbor_sampler.py``.  Per hop:
one one-hop sample of the level's targets (``ops/sample.py``: the fused
uniform sampler, or ``weighted_sample`` / ``masked_uniform_sample``), then
either the next level is [targets | neighbors row-major], so renumbering is
position arithmetic, or (``dedup=True``) ``ops/unique.py::append_unique``
renumbers the neighbors into [targets | new nodes ascending], cut to the
level's capacity.  Shapes are static: level l+1 holds ``level_capacities``
(or the capped ``max_unique_per_hop``) slots, padded with -1.  With seed
times, a sampled node inherits the earliest time of the targets that drew it
(a scatter-min), and the next hop only takes edges no newer than that.

Each sampler takes optional per-hop draws, so that tests can replay the JAX
ones: ``u``, hop h's uniforms of shape (targets in hop h, fanout_h)
(``jax.random.uniform(jax.random.fold_in(key, h), ...)``), and
``hash_keys``, hop h's key words for the weighted or time-masked sampler
(the last two words of ``key_data(fold_in(fold_in(key, h), 0))``, or ``...,
1)`` for the masked one).  Without them the draws come from ``generator``.

The JAX class's TPU-only knobs are not ported: ``hub_frac``, ``indices2d``
and ``pad_to_lines`` route its neighbor reads through a line-window gather.
The port reads neighbor ids directly, so its samples are the same without
them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.sample import (
    floyd_positions_np,
    masked_uniform_sample,
    uniform_sample,
    weighted_sample,
)
from cugraph_gnn_tpu_torch.ops.unique import append_unique, append_unique_rows
from cugraph_gnn_tpu_torch.sampler.heuristics import clamp_level_caps
from cugraph_gnn_tpu_torch.sampler.output import HopBlock, MultihopBatch

_NO_TIME = 2**31 - 1   # an empty slot's time (int32 max, as in JAX)


def level_capacities(batch_size: int, fanouts: Sequence[int]) -> List[int]:
    """Node capacity per level: each target contributes itself plus up to
    ``fanout`` neighbors."""
    caps = [batch_size]
    for k in fanouts:
        caps.append(caps[-1] * (k + 1))
    return caps


def static_layout(targets, neighbors):
    """The static layout of one hop for each of S rows: targets (S, t),
    neighbors (S, t, k).  Neighbor (i, j) of a row sits at t + i*k + j of its
    next level.  Returns neigh_local (S, t, k) and the next level (S, t +
    t*k)."""
    s, t, k = neighbors.shape
    pos = t + torch.arange(t * k, dtype=torch.int32,
                           device=neighbors.device).reshape(t, k)
    return (torch.where(neighbors >= 0, pos, -1),
            torch.cat([targets, neighbors.reshape(s, t * k)], dim=1))


def propagate_times(seed_time, neigh_local, cap: int):
    """Seed times of the next level, for each of S rows: targets keep theirs
    (seed_time (S, t)), a sampled node takes the minimum over the targets
    that drew it (neigh_local (S, t, k) into a level of ``cap`` slots), empty
    slots int32 max.  Returns (S, cap) in seed_time's dtype."""
    s, t = seed_time.shape
    k = neigh_local.shape[-1]
    full = torch.full((s, cap), _NO_TIME, dtype=seed_time.dtype, device=seed_time.device)
    full[:, :t] = seed_time
    loc = neigh_local.reshape(s, t * k).long()
    ok = loc >= 0
    vals = torch.where(ok, seed_time.repeat_interleave(k, dim=1), full[:, -1:])
    return full.scatter_reduce_(1, torch.where(ok, loc, cap - 1), vals, "amin")


def multihop_uniform_batched(indptr, indices, seeds, fanouts, *, u=None,
                             generator=None, device=None) -> MultihopBatch:
    """S independent mini-batches sampled as one flattened frontier per hop.

    seeds: (S, B) int32, -1 = padding.  Returns a MultihopBatch whose every
    tensor has a leading step axis; ``batch.step(s)`` is the static-layout
    batch of step s, with positions local to that step.  Runs on ``device``
    (default: the card).
    """
    sampler = NeighborSampler(indptr, indices, fanouts, dedup=False, device=device)
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=sampler.device)
    levels, hops = sampler.sample_rows(
        seeds, None, level_capacities(seeds.shape[1], sampler.fanouts), u=u,
        generator=generator)
    counts = [(lv >= 0).sum(dim=1, dtype=torch.int32) for lv in levels]
    return MultihopBatch(levels=levels, level_counts=counts, hops=hops,
                         seed_count=counts[0], static_layout=True)


def one_hop(indptr, indices, targets, fanout: int, *, weights=None, edge_times=None,
            seed_time=None, max_degree=None, chunk: int = 256, u=None, hash_key=None,
            generator=None, device=None):
    """One hop of a graph from ``targets`` (-1 = padding): weighted
    (time-filtered when there are edge and seed times), else time-masked
    uniform, else uniform (the fused kernel on the card)."""
    timed = edge_times is not None and seed_time is not None
    kw = dict(max_degree=max_degree, chunk=chunk, hash_key=hash_key, generator=generator,
              device=device)
    if timed:
        kw.update(edge_times=edge_times, seed_time=seed_time)
    if weights is not None:
        return weighted_sample(indptr, indices, weights, targets, fanout, **kw)
    if timed:
        return masked_uniform_sample(indptr, indices, targets, fanout, **kw)
    return uniform_sample(indptr, indices, targets, fanout, u=u, generator=generator,
                          device=device)


def _check_draws(draws, fanouts):
    if draws is not None and len(draws) != len(fanouts):
        raise ValueError(f"per-hop draws need one entry per hop: got {len(draws)} "
                         f"for {len(fanouts)} fanouts")


def multihop_uniform(indptr, indices, seeds, fanouts, *, dedup: bool = True,
                     u=None, generator=None, device=None) -> MultihopBatch:
    """Uniform multi-hop sampling of one mini-batch; seeds (B,) int32, -1 =
    padding.  ``dedup=False`` gives the static layout (step 0 of
    :func:`multihop_uniform_batched` on ``seeds[None]``), ``dedup=True``
    the deduplicated levels of capacity ``level_capacities``.  Runs on
    ``device`` (default: the card)."""
    return NeighborSampler(indptr, indices, fanouts, dedup=dedup,
                           device=device).sample(seeds, u=u, generator=generator)


class NeighborSampler:
    """Uniform / weighted / temporal multi-hop sampler over a CSR graph (rows
    are the nodes whose sampled neighbors are read: for message passing, the
    graph with its edges reversed, as ``data.GraphStore`` builds it).

    fanouts: neighbors per hop, seed side first.  weights: optional per-edge
    weights (CSR order) -> weighted sampling.  edge_times: optional per-edge
    times -> temporal sampling when ``sample`` gets seed times.  max_degree,
    chunk: JAX's loop bound for the weighted and temporal samplers (a row's
    positions past ceil(max_degree / chunk) * chunk are never candidates);
    max_degree defaults to the graph's largest degree.  dedup: renumber each
    level into unique nodes (default) or keep the static layout.
    max_unique_per_hop: optional per-hop caps on the unique-node levels
    (``dedup=True`` only); new nodes past a cap are dropped and their slots
    become -1.  The graph lives on ``device`` (default: the card).
    """

    def __init__(self, indptr, indices, fanouts: Sequence[int], *,
                 weights=None, edge_times=None, max_degree: Optional[int] = None,
                 chunk: int = 256, dedup: bool = True,
                 max_unique_per_hop: Optional[Sequence[int]] = None,
                 device=None):
        if max_unique_per_hop is not None and not dedup:
            raise ValueError("capacity budgets need dedup=True")
        self.device = resolve_device(device)
        self.indptr = torch.as_tensor(indptr, dtype=torch.int32, device=self.device)
        self.indices = torch.as_tensor(indices, dtype=torch.int32, device=self.device)
        self.fanouts = tuple(int(f) for f in fanouts)
        self.weights = None if weights is None else torch.as_tensor(weights,
                                                                    device=self.device)
        self.edge_times = None if edge_times is None else torch.as_tensor(
            edge_times, device=self.device)
        for name, attr in (("weights", self.weights), ("edge_times", self.edge_times)):
            if attr is not None and attr.shape != self.indices.shape:
                raise ValueError(f"{name} needs one entry per edge: got "
                                 f"{tuple(attr.shape)} for {self.indices.shape[0]} edges")
        if max_degree is None and (weights is not None or edge_times is not None):
            max_degree = int((self.indptr[1:] - self.indptr[:-1]).max()) \
                if self.indptr.shape[0] > 1 else 0
        self.max_degree = max_degree
        self.chunk = int(chunk)
        self.dedup = dedup
        self.max_unique_per_hop = (None if max_unique_per_hop is None
                                   else [int(x) for x in max_unique_per_hop])

    def level_caps(self, batch_size: int) -> List[int]:
        """The size of every level for a batch of ``batch_size`` seeds."""
        caps = level_capacities(batch_size, self.fanouts)
        if self.max_unique_per_hop is not None:
            clamp_level_caps(caps, [f + 1 for f in self.fanouts],
                             self.max_unique_per_hop)
        return caps

    def key_based(self, timed: bool) -> bool:
        """Whether hops draw hash keys (weighted, or time-masked when the
        seeds have times) rather than uniforms."""
        return self.weights is not None or (self.edge_times is not None and timed)

    def _one_hop(self, targets, fanout: int, seed_time, *, u, hash_key, generator):
        """One hop from ``targets`` (-1 = padding), as :func:`one_hop`."""
        return one_hop(self.indptr, self.indices, targets, fanout, weights=self.weights,
                       edge_times=self.edge_times, seed_time=seed_time,
                       max_degree=self.max_degree, chunk=self.chunk, u=u,
                       hash_key=hash_key, generator=generator, device=self.device)

    def sample_rows(self, seeds, seed_time, caps, *, u=None, hash_keys=None,
                    generator=None):
        """The hops of R independent batches, one per row of ``seeds`` (R,
        T0), each deduplicated in its own namespace (or in the static
        layout), sampled together as one flat frontier per hop.  seed_time:
        None or (R, T0).  u[h]: (R * caps[h], fanout_h); hash_keys[h]: (2,),
        or (R, 2) with R > 1, one key per row.  Returns (levels (R, cap) each,
        HopBlocks of (R, cap, k) tensors)."""
        _check_draws(u, self.fanouts)
        _check_draws(hash_keys, self.fanouts)
        r = seeds.shape[0]
        levels = [seeds]
        hops: List[HopBlock] = []
        for h, fanout in enumerate(self.fanouts):
            targets = levels[-1]
            t = targets.shape[1]
            hk = None if hash_keys is None else hash_keys[h]
            if r > 1 and self.key_based(seed_time is not None):
                if hk is None:     # each row its own stream, as JAX's split keys
                    hk = torch.randint(0, 1 << 32, (r, 2), generator=generator,
                                       device=self.device, dtype=torch.int64)
                hk = torch.as_tensor(hk, device=self.device).repeat_interleave(t, dim=0)
            out = self._one_hop(targets.reshape(-1), fanout,
                                None if seed_time is None else seed_time.reshape(-1),
                                u=None if u is None else u[h], hash_key=hk,
                                generator=generator)
            neighbors = out.neighbors.view(r, t, fanout)
            if not self.dedup:
                local, nxt = static_layout(targets, neighbors)
            elif r == 1:
                uq = append_unique(targets[0], out.neighbors.reshape(-1),
                                   max_unique=caps[h + 1])
                local, nxt = uq.neighbor_map.view(1, t, fanout), uq.unique_nodes[None]
            else:
                uq = append_unique_rows(targets, neighbors.reshape(r, t * fanout),
                                        max_unique=caps[h + 1])
                local, nxt = uq.neighbor_map.view(r, t, fanout), uq.unique_nodes
            hops.append(HopBlock(neigh_local=local, neigh_global=neighbors,
                                 edge_ids=out.edge_ids.view(r, t, fanout)))
            levels.append(nxt)
            if seed_time is not None:
                seed_time = propagate_times(seed_time, local, nxt.shape[1])
        return levels, hops

    def sample(self, seeds, node_times=None, *, u=None, hash_keys=None,
               generator=None) -> MultihopBatch:
        """A multihop batch for ``seeds`` (B,) int32, -1 padded.
        node_times: optional (B,) seed times (temporal sampling when the
        sampler has ``edge_times``).  ``u``: optional per-hop uniforms, hop
        h's of shape (``level_caps(B)[h]``, fanout_h); ``hash_keys``:
        optional per-hop key words (k0, k1) of the weighted or time-masked
        hops; otherwise drawn from ``generator``."""
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=self.device)
        times = None
        if node_times is not None:
            times = torch.as_tensor(node_times, device=self.device)[None]
        levels, hops = self.sample_rows(seeds[None], times, self.level_caps(seeds.shape[0]),
                                        u=u, hash_keys=hash_keys, generator=generator)
        levels = [lv[0] for lv in levels]
        counts = [(lv >= 0).sum(dtype=torch.int32) for lv in levels]
        return MultihopBatch(levels=levels, level_counts=counts,
                             hops=[HopBlock(*(a[0] for a in hop[:3])) for hop in hops],
                             seed_count=counts[0], static_layout=not self.dedup)


def uniform_sample_np(u, indptr, indices, seeds, fanout: int):
    """Host reference of one uniform hop (NumPy): the JAX function with its
    (len(seeds), fanout) uniforms ``u`` passed in instead of drawn from a
    key (JAX draws ``jax.random.uniform(key, (len(seeds), fanout))``).
    Returns (neighbors, edge_ids), int64, -1 where a seed has fewer
    neighbors or is -1."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    seeds = np.asarray(seeds)
    valid = seeds >= 0
    safe = np.where(valid, seeds, 0)
    deg = np.where(valid, indptr[safe + 1] - indptr[safe], 0)
    pos = floyd_positions_np(u, deg, fanout)
    start = indptr[safe]
    edge_ids = np.where(pos >= 0, start[:, None] + pos, -1)
    neigh = np.where(pos >= 0, indices[np.clip(edge_ids, 0, None)], -1)
    return neigh.astype(np.int64), edge_ids.astype(np.int64)
