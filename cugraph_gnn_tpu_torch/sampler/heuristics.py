"""Level capacities of the samplers.

Counterpart of ``cugraph_gnn_tpu/sampler/heuristics.py`` for
:func:`clamp_level_caps` only (the port keeps its own copy, as it imports
nothing of the JAX package).  The ``"auto"`` sizing of ``max_unique_per_hop``
from device memory is not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence


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
