"""Level capacities of the samplers, and their sizing from device memory.

Counterpart of ``cugraph_gnn_tpu/sampler/heuristics.py`` (the port keeps its
own copy, as it imports nothing of the JAX package).  The reference sizes its
sampling call groups from GPU memory (``local_seeds_per_call``); with static
shapes the same lever is the per-hop unique-node capacity
(``max_unique_per_hop``), which ``NeighborLoader(max_unique_per_hop="auto")``
derives here from the memory of the device the batches live on.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

from cugraph_gnn_tpu_torch._device import resolve_device


def device_memory_bytes(device=None) -> int:
    """The memory the caps are sized against: a CUDA device's own total
    memory (``torch.cuda.get_device_properties``), or for the CPU the host's
    physical memory (``os.sysconf``).  ``device`` defaults to the card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    if dev.type == "cpu":
        return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    raise ValueError(f"no memory size for device {dev}")


def auto_max_unique_per_hop(batch_size: int, fanouts: Sequence[int], feat_dim: int, *,
                            feat_bytes: int = 4, memory_bytes: Optional[int] = None,
                            memory_fraction: float = 0.25, copies: int = 6,
                            device=None) -> List[int]:
    """Per-hop unique-node caps sized to a memory budget.

    Every level's feature rows (and their gradients, optimizer copies and
    temporaries: the ``copies`` multiplier) are counted live at once; each
    level's cap is the rows that fit in an equal share of ``memory_fraction *
    memory_bytes`` (default: :func:`device_memory_bytes` of ``device``),
    never below the batch and never above the worst case ``caps[l] * (fanout
    + 1)``.  Returns one cap per hop, for ``max_unique_per_hop=``.
    """
    fanouts = [int(f) for f in fanouts]
    if any(f <= 0 for f in fanouts):
        raise ValueError("auto caps need positive fanouts")
    if memory_bytes is None:
        memory_bytes = device_memory_bytes(device)
    budget = memory_bytes * memory_fraction
    row_bytes = max(1, int(feat_dim) * int(feat_bytes) * int(copies))
    per_level_rows = max(int(budget / len(fanouts) / row_bytes), batch_size)
    caps = []
    prev = int(batch_size)
    for f in fanouts:
        prev = min(prev * (f + 1), per_level_rows)
        caps.append(prev)
    return caps


def resolve_max_unique_per_hop(max_unique_per_hop, batch_size, fanouts,
                               feat_dim: Optional[int], feat_bytes: int = 4, *,
                               memory_bytes: Optional[int] = None, device=None):
    """The loader's ``max_unique_per_hop``: None or explicit caps pass
    through, ``"auto"`` is computed by :func:`auto_max_unique_per_hop` (a
    feature width of 128 when the store has none)."""
    if max_unique_per_hop != "auto":
        return max_unique_per_hop
    if isinstance(fanouts, dict):
        # hetero fanouts: a target expands by the sum over its edge types
        hop_len = {len(v) for v in fanouts.values()}
        if len(hop_len) != 1:
            raise ValueError("every edge type needs the same number of hops")
        fanouts = [sum(v[h] for v in fanouts.values()) for h in range(hop_len.pop())]
    return auto_max_unique_per_hop(batch_size, fanouts, feat_dim if feat_dim else 128,
                                   feat_bytes=feat_bytes, memory_bytes=memory_bytes,
                                   device=device)


def clamp_level_caps(caps: List[int], growth: Sequence[int],
                     max_unique_per_hop: Sequence[int]) -> List[int]:
    """Apply per-hop unique-node caps to the level capacities ``caps`` (in
    place) and keep the prefix invariant of every sampler: level l's targets
    are a prefix of level l+1, so each level holds at least the previous
    one.  ``growth[h]`` is hop h's worst-case expansion (fanout + 1).
    Raises when a cap is smaller than the level before it."""
    for h, cap in enumerate(max_unique_per_hop):
        caps[h + 1] = min(caps[h + 1], int(cap))
    for h in range(len(growth)):
        caps[h + 1] = min(caps[h + 1], caps[h] * int(growth[h]))
        if caps[h + 1] < caps[h]:
            raise ValueError(
                f"max_unique_per_hop[{h}]={caps[h + 1]} is smaller than "
                f"level {h}'s capacity {caps[h]}; each level must hold "
                "at least the previous level (targets are a prefix of "
                "the next level)")
    return caps


def resolve_feature_dim(feature_store, graph_store, x_attr: str):
    """The feature width the auto caps count: that of the first node group
    (homogeneous "" or a node type) holding ``x_attr``; None when none
    does."""
    for grp in [""] + list(graph_store.node_types):
        if (grp, x_attr) in feature_store:
            size = feature_store.get_tensor_size(grp, x_attr)
            return size[-1] if len(size) > 1 else 1
    return None
