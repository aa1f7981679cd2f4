"""Disjoint sampling: an independent subgraph per seed (PyG ``disjoint=True``).

Counterpart of ``cugraph_gnn_tpu/sampler/disjoint.py``.  Each seed's sampled
nodes are deduplicated in a namespace of its own, so a node reached from two
seeds appears once per seed; link prediction needs this, where shared
neighborhoods would leak between the per-seed subgraphs.

JAX ``vmap``s the single-seed body of the base sampler over the seeds, with
split keys.  The port samples every seed's frontier as one flat batch a hop
(row 2's kernel for the uniform hops) and deduplicates within each seed in
one pass over the keys ``seed * 2**32 + node``
(``ops/unique.py::append_unique_rows``), which gives each seed JAX's per-seed
layout: [its targets | its new nodes ascending], cut to the per-seed level
capacities ``base.level_caps(1)`` (1, 1 + k0, ...).  Per-hop draws can be
injected as in ``NeighborSampler.sample``: ``u[h]`` holds the seeds' uniforms
one after the other, ``hash_keys[h]`` one key per seed.

Over a ``HeteroNeighborSampler`` (with ``dedup=True``) each seed gets a
typed subgraph: the hops are per-edge-type dicts of (B, cap, k) blocks, one
flat frontier per hop per edge type, with per-type draws ``u[h][name]`` and
``hash_keys[h][name]``.

A model runs over a disjoint batch through :meth:`DisjointBatch.flat`: one
``MultihopBatch`` (``HeteroMultihopBatch`` for hetero hops) whose levels hold
every seed's block one after the other (``num_shards`` = the number of
seeds), so each layer reads each seed's targets and neighbors inside its own
block.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from cugraph_gnn_tpu_torch.sampler.hetero import HeteroMultihopBatch, HeteroNeighborSampler
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import NeighborSampler
from cugraph_gnn_tpu_torch.sampler.output import COOSample, HopBlock, MultihopBatch


class DisjointBatch(NamedTuple):
    """Per-seed multihop batch: a leading seed axis B on every tensor.

    levels[l]: (B, cap_l) global node ids, -1 pad; each row has the prefix
      property of a MultihopBatch.
    level_counts[l]: (B,) int32 valid nodes per seed.
    hops[l]: HopBlock of (B, cap_l, k_l) tensors (a dict of them by edge
      type, hetero); neigh_local indexes the seed's own row of levels[l+1].
    seed_valid: (B,) bool, False for -1-padded seeds.
    """

    levels: List[torch.Tensor]
    level_counts: List[torch.Tensor]
    hops: List[HopBlock]
    seed_valid: torch.Tensor

    @property
    def num_hops(self) -> int:
        return len(self.hops)

    @property
    def input_nodes(self):
        """(B, cap_L) per-seed node lists (feature-gather targets)."""
        return self.levels[-1]

    @property
    def batch(self):
        """(B * cap_L,) seed index of every flattened node, -1 on pads: the
        PyG ``batch`` vector over ``input_nodes.reshape(-1)``."""
        b, cap = self.levels[-1].shape
        seed_of = torch.arange(b, dtype=torch.int32, device=self.levels[-1].device)
        return torch.where(self.levels[-1] >= 0, seed_of[:, None], -1).reshape(-1)

    @property
    def is_hetero(self) -> bool:
        return bool(self.hops) and isinstance(self.hops[0], dict)

    def per_seed(self):
        """The batch as a MultihopBatch (HeteroMultihopBatch) of per-seed
        tensors (the JAX view that ``vmap`` maps over)."""
        cls = HeteroMultihopBatch if self.is_hetero else MultihopBatch
        return cls(levels=list(self.levels), level_counts=list(self.level_counts),
                   hops=list(self.hops), seed_count=self.seed_valid.to(torch.int32))

    def flat(self) -> MultihopBatch:
        """One MultihopBatch of B blocks a level (seed s's cap_l slots at s *
        cap_l), hops (B * cap_l, k_l) with block-relative indices and
        ``num_shards`` = B, which models run as they run one batch: the
        output's row s is seed s's, as ``vmap`` of the model over
        :meth:`per_seed` gives it.  Features: ``x.reshape(B * cap_L, F)``."""
        b = self.seed_valid.shape[0]
        counts = [c.sum(dtype=torch.int32) for c in self.level_counts]

        def flat(hop):
            return HopBlock(*(a.reshape(-1, a.shape[-1]) for a in hop[:3]))

        if self.is_hetero:
            return HeteroMultihopBatch(
                levels=[lv.reshape(-1) for lv in self.levels], level_counts=counts,
                hops=[{k: flat(v) for k, v in hop.items()} for hop in self.hops],
                seed_count=counts[0], num_shards=b)
        return MultihopBatch(
            levels=[lv.reshape(-1) for lv in self.levels], level_counts=counts,
            hops=[flat(hop) for hop in self.hops], seed_count=counts[0], num_shards=b)


class DisjointNeighborSampler:
    """Disjoint mode over a ``NeighborSampler`` or a ``HeteroNeighborSampler``
    with ``dedup=True``: uniform, weighted and temporal, as the base samples.
    ``max_unique_per_hop`` caps each seed's levels (it becomes the base's)."""

    def __init__(self, base, max_unique_per_hop: Optional[Sequence[int]] = None):
        if not isinstance(base, (NeighborSampler, HeteroNeighborSampler)):
            raise TypeError(f"disjoint sampling needs a NeighborSampler or a "
                            f"HeteroNeighborSampler, got {type(base).__name__}")
        if not base.dedup:
            raise ValueError("disjoint mode requires a dedup=True sampler "
                             "(per-seed namespaces are dedup'd node lists)")
        self.base = base
        self.max_unique_per_hop = max_unique_per_hop
        if max_unique_per_hop is not None:
            base.max_unique_per_hop = [int(x) for x in max_unique_per_hop]

    @property
    def fanouts(self):
        return self.base.fanouts

    def level_caps(self, batch_size: int = 1) -> List[int]:
        """Each seed's level sizes (``batch_size`` is ignored: every seed is
        a batch of one)."""
        return self.base.level_caps(1)

    def sample(self, seeds, node_times=None, *, u=None, hash_keys=None,
               generator=None) -> DisjointBatch:
        """Per-seed subgraphs of ``seeds`` (B,) int32, -1 padded; node_times
        (B,) optional.  u[h]: (B * cap_h, k_h) uniforms, seed after seed;
        hash_keys[h]: (B, 2) key words, one per seed (hetero: u[h][name],
        hash_keys[h][name]); otherwise drawn from ``generator``, each seed
        its own key."""
        base = self.base
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=base.device)
        times = None if node_times is None else torch.as_tensor(
            node_times, device=base.device)[:, None]
        levels, hops = base.sample_rows(seeds[:, None], times, base.level_caps(1), u=u,
                                        hash_keys=hash_keys, generator=generator)
        return DisjointBatch(levels=levels,
                             level_counts=[(lv >= 0).sum(dim=1, dtype=torch.int32)
                                           for lv in levels],
                             hops=hops, seed_valid=seeds >= 0)


def to_coo_disjoint(batch: DisjointBatch) -> COOSample:
    """PyG-style COO over the flattened disjoint node list: node[s * cap_L +
    i] = levels[-1][s, i]; row and col index that list (each seed's offset by
    s * cap_L).  ``batch.batch`` is the seed of every node."""
    bsz, cap_l = batch.levels[-1].shape
    dev = batch.levels[-1].device
    base = (torch.arange(bsz, dtype=torch.int32, device=dev) * cap_l)[:, None, None]
    rows, cols, edges, n_edges = [], [], [], []
    for hop in batch.hops:
        _, s, k = hop.neigh_local.shape
        dst_local = torch.arange(s, dtype=torch.int32, device=dev)[None, :, None]
        m = hop.neigh_local >= 0
        rows.append(torch.where(m, dst_local + base, -1).reshape(-1))
        cols.append(torch.where(m, hop.neigh_local + base, -1).reshape(-1))
        edges.append(torch.where(m, hop.edge_ids, -1).reshape(-1))
        n_edges.append(m.sum(dtype=torch.int32))
    counts = [batch.level_counts[0].sum()] + [
        (batch.level_counts[i + 1] - batch.level_counts[i]).sum()
        for i in range(batch.num_hops)]
    return COOSample(node=batch.levels[-1].reshape(-1), row=torch.cat(rows),
                     col=torch.cat(cols), edge=torch.cat(edges),
                     num_sampled_nodes=torch.stack(counts).to(torch.int32),
                     num_sampled_edges=torch.stack(n_edges))
