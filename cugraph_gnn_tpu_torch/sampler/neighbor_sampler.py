"""Multi-hop uniform neighbor sampling: the static (dedup=False) layout and
the deduplicated one, and the ``NeighborSampler`` class.

Counterpart of ``cugraph_gnn_tpu/sampler/neighbor_sampler.py``.  Per hop:
one fused sampler launch (``ops/sample.py::uniform_sample``), then either
the next level is [targets | neighbors row-major], so renumbering is
position arithmetic, or (``dedup=True``) ``ops/unique.py::append_unique``
renumbers the neighbors into [targets | new nodes ascending], cut to the
level's capacity.  Shapes are static: level l+1 holds ``level_capacities``
(or the capped ``max_unique_per_hop``) slots, padded with -1.

Each function takes an optional per-hop list ``u`` of uniform draws, hop h's
of shape (targets in hop h, fanout_h), so that tests can replay the JAX draws
(``jax.random.uniform(jax.random.fold_in(key, h), ...)``); without it the
draws come from ``generator``.

The JAX class's TPU-only knobs are not ported: ``hub_frac``, ``indices2d``
and ``pad_to_lines`` route its neighbor reads through a line-window gather,
and ``chunk`` bounds its weighted and temporal loops.  The port's kernel
reads neighbor ids directly, so its samples are the same without them.
Weighted and temporal sampling (``weights``, ``edge_times``,
``node_times``) come with ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.sample import uniform_sample
from cugraph_gnn_tpu_torch.ops.unique import append_unique
from cugraph_gnn_tpu_torch.sampler.heuristics import clamp_level_caps
from cugraph_gnn_tpu_torch.sampler.output import HopBlock, MultihopBatch


def level_capacities(batch_size: int, fanouts: Sequence[int]) -> List[int]:
    """Node capacity per level: each target contributes itself plus up to
    ``fanout`` neighbors."""
    caps = [batch_size]
    for k in fanouts:
        caps.append(caps[-1] * (k + 1))
    return caps


def multihop_uniform_batched(indptr, indices, seeds, fanouts, *, u=None,
                             generator=None, device=None) -> MultihopBatch:
    """S independent mini-batches sampled as one flattened frontier per hop.

    seeds: (S, B) int32, -1 = padding.  Returns a MultihopBatch whose every
    tensor has a leading step axis; ``batch.step(s)`` is the static-layout
    batch of step s, with positions local to that step.  Runs on ``device``
    (default: the card).
    """
    dev = resolve_device(device)
    indptr = torch.as_tensor(indptr, dtype=torch.int32, device=dev)
    indices = torch.as_tensor(indices, dtype=torch.int32, device=dev)
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=dev)
    fanouts = tuple(int(f) for f in fanouts)
    if u is not None and len(u) != len(fanouts):
        raise ValueError(f"u needs one array per hop: got {len(u)} for "
                         f"{len(fanouts)} fanouts")
    s_steps = seeds.shape[0]
    levels = [seeds]
    level_counts = [(seeds >= 0).sum(dim=1, dtype=torch.int32)]
    hops: List[HopBlock] = []
    for h, fanout in enumerate(fanouts):
        targets = levels[-1]                       # (S, B_l)
        t = targets.shape[1]
        out = uniform_sample(indptr, indices, targets.reshape(-1), fanout,
                             u=None if u is None else u[h],
                             generator=generator, device=dev)
        neighbors = out.neighbors.reshape(s_steps, t, fanout)
        # neighbor (i, j) of a step sits at t + i*fanout + j in its next level
        pos = t + torch.arange(t * fanout, dtype=torch.int32,
                               device=dev).reshape(t, fanout)
        hops.append(HopBlock(
            neigh_local=torch.where(neighbors >= 0, pos, -1),
            neigh_global=neighbors,
            edge_ids=out.edge_ids.reshape(s_steps, t, fanout)))
        next_level = torch.cat(
            [targets, neighbors.reshape(s_steps, t * fanout)], dim=1)
        levels.append(next_level)
        level_counts.append((next_level >= 0).sum(dim=1, dtype=torch.int32))
    return MultihopBatch(levels=levels, level_counts=level_counts, hops=hops,
                         seed_count=level_counts[0], static_layout=True)


def _sample_dedup(indptr, indices, seeds, fanouts, caps, *, u, generator,
                  device) -> MultihopBatch:
    """One mini-batch's deduplicated levels and hops; level h+1 holds
    ``caps[h + 1]`` slots."""
    if u is not None and len(u) != len(fanouts):
        raise ValueError(f"u needs one array per hop: got {len(u)} for "
                         f"{len(fanouts)} fanouts")
    levels = [seeds]
    level_counts = [(seeds >= 0).sum(dtype=torch.int32)]
    hops: List[HopBlock] = []
    for h, fanout in enumerate(fanouts):
        targets = levels[-1]
        out = uniform_sample(indptr, indices, targets, fanout,
                             u=None if u is None else u[h],
                             generator=generator, device=device)
        uniq = append_unique(targets, out.neighbors.reshape(-1),
                             max_unique=caps[h + 1])
        hops.append(HopBlock(
            neigh_local=uniq.neighbor_map.reshape(out.neighbors.shape),
            neigh_global=out.neighbors, edge_ids=out.edge_ids))
        levels.append(uniq.unique_nodes)
        level_counts.append((uniq.unique_nodes >= 0).sum(dtype=torch.int32))
    return MultihopBatch(levels=levels, level_counts=level_counts, hops=hops,
                         seed_count=level_counts[0], static_layout=False)


def multihop_uniform(indptr, indices, seeds, fanouts, *, dedup: bool = True,
                     u=None, generator=None, device=None) -> MultihopBatch:
    """Uniform multi-hop sampling of one mini-batch; seeds (B,) int32, -1 =
    padding.  ``dedup=False`` gives the static layout (step 0 of
    :func:`multihop_uniform_batched` on ``seeds[None]``), ``dedup=True``
    the deduplicated levels of capacity ``level_capacities``.  Runs on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=dev)
    fanouts = tuple(int(f) for f in fanouts)
    if not dedup:
        return multihop_uniform_batched(indptr, indices, seeds[None], fanouts,
                                        u=u, generator=generator,
                                        device=dev).step(0)
    indptr = torch.as_tensor(indptr, dtype=torch.int32, device=dev)
    indices = torch.as_tensor(indices, dtype=torch.int32, device=dev)
    return _sample_dedup(indptr, indices, seeds, fanouts,
                         level_capacities(seeds.shape[0], fanouts), u=u,
                         generator=generator, device=dev)


class NeighborSampler:
    """Uniform multi-hop sampler over a CSR graph (rows are the nodes whose
    sampled neighbors are read: for message passing, the graph with its
    edges reversed, as ``data.GraphStore`` builds it).

    fanouts: neighbors per hop, seed side first.  dedup: renumber each
    level into unique nodes (default) or keep the static layout.
    max_unique_per_hop: optional per-hop caps on the unique-node levels
    (``dedup=True`` only); new nodes past a cap are dropped and their slots
    become -1.  The graph lives on ``device`` (default: the card).
    """

    def __init__(self, indptr, indices, fanouts: Sequence[int], *,
                 weights=None, edge_times=None, dedup: bool = True,
                 max_unique_per_hop: Optional[Sequence[int]] = None,
                 device=None):
        if weights is not None or edge_times is not None:
            raise NotImplementedError(
                "weighted and temporal sampling are not ported yet "
                "(ROADMAP Queue 1 item 4)")
        if max_unique_per_hop is not None and not dedup:
            raise ValueError("capacity budgets need dedup=True")
        self.device = resolve_device(device)
        self.indptr = torch.as_tensor(indptr, dtype=torch.int32, device=self.device)
        self.indices = torch.as_tensor(indices, dtype=torch.int32, device=self.device)
        self.fanouts = tuple(int(f) for f in fanouts)
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

    def sample(self, seeds, node_times=None, *, u=None,
               generator=None) -> MultihopBatch:
        """A multihop batch for ``seeds`` (B,) int32, -1 padded.  ``u``:
        optional per-hop uniforms, hop h's of shape (``level_caps(B)[h]``,
        fanout_h); otherwise drawn from ``generator``."""
        if node_times is not None:
            raise NotImplementedError(
                "temporal sampling is not ported yet (ROADMAP Queue 1 item 4)")
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=self.device)
        if not self.dedup:
            return multihop_uniform_batched(
                self.indptr, self.indices, seeds[None], self.fanouts, u=u,
                generator=generator, device=self.device).step(0)
        return _sample_dedup(self.indptr, self.indices, seeds, self.fanouts,
                             self.level_caps(seeds.shape[0]), u=u,
                             generator=generator, device=self.device)
