"""Multi-hop uniform neighbor sampling in the static (dedup=False) layout.

Counterpart of ``cugraph_gnn_tpu/sampler/neighbor_sampler.py``.  Per hop: one
fused sampler launch (``ops/sample.py::uniform_sample``), then the next level
is [targets | neighbors row-major], so renumbering is position arithmetic.
Deduplicated levels (``append_unique``) and the ``NeighborSampler`` class come
with the loaders in a later slice.

Each function takes an optional per-hop list ``u`` of uniform draws, hop h's
of shape (targets in hop h, fanout_h), so that tests can replay the JAX draws
(``jax.random.uniform(jax.random.fold_in(key, h), ...)``); without it the
draws come from ``generator``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.sample import uniform_sample
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


def multihop_uniform(indptr, indices, seeds, fanouts, *, dedup: bool = True,
                     u=None, generator=None, device=None) -> MultihopBatch:
    """Uniform multi-hop sampling of one mini-batch; seeds (B,) int32.

    Only ``dedup=False`` (the static layout) is ported; it equals step 0 of
    :func:`multihop_uniform_batched` on ``seeds[None]``.
    """
    if dedup:
        raise NotImplementedError(
            "dedup=True needs append_unique, which is ported with the "
            "sampling-variants slice (ROADMAP Queue 1 item 4)")
    dev = resolve_device(device)
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=dev)
    return multihop_uniform_batched(indptr, indices, seeds[None], fanouts,
                                    u=u, generator=generator,
                                    device=dev).step(0)
