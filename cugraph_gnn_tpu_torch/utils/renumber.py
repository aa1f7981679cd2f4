"""Knowledge-graph renumbering: raw (arbitrary, e.g. hashed) node ids ->
contiguous per-type ids ready for ``data.GraphStore``.

Counterpart of ``cugraph_gnn_tpu/utils/renumber.py`` (numpy only; the port
keeps its own copy), the reference's distributed renumber job: per node
type, the raw ids seen across shards are unioned into a sorted global map,
and every edge list's endpoint columns are translated through the maps
(a sorted array and ``searchsorted`` in place of a join).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

EdgeType = Tuple[str, str, str]


class RenumberedKG(NamedTuple):
    """maps[node_type]: sorted (n_type,) raw ids — new id = position.
    edges[edge_type]: (src_new, dst_new) int64 arrays.
    num_nodes[node_type]: map length."""

    maps: Dict[str, np.ndarray]
    edges: Dict[EdgeType, Tuple[np.ndarray, np.ndarray]]
    num_nodes: Dict[str, int]


def build_renumber_map(shards: Sequence[np.ndarray]) -> np.ndarray:
    """Union of raw ids across shards, sorted; new id = index."""
    if not shards:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate([np.asarray(s).ravel() for s in shards]))


def apply_renumber_map(rmap: np.ndarray, raw_ids, *, strict: bool = True):
    """raw id -> new id (position in the sorted map); unknown ids raise
    (strict) or map to -1."""
    raw = np.asarray(raw_ids)
    pos = np.searchsorted(rmap, raw)
    pos_c = np.minimum(pos, max(len(rmap) - 1, 0))
    hit = ((pos < len(rmap)) & (rmap[pos_c] == raw) if len(rmap)
           else np.zeros(raw.shape, bool))
    if strict:
        if not hit.all():
            missing = raw[~hit]
            raise KeyError(
                f"{missing.size} raw ids not in the renumber map "
                f"(first: {missing.ravel()[:5].tolist()})")
        return pos.astype(np.int64)
    return np.where(hit, pos, -1).astype(np.int64)


def renumber_kg(
    nodes_by_type: Dict[str, Sequence[np.ndarray]],
    edges_by_etype: Dict[EdgeType, Sequence[Tuple[np.ndarray, np.ndarray]]],
    *,
    include_edge_endpoints: bool = True,
) -> RenumberedKG:
    """Build per-type maps from node-id shards (plus, by default, any
    ids appearing as edge endpoints — the reference requires node files
    to cover all endpoints and fails the join otherwise; including
    endpoints makes the common case robust), then renumber every edge
    shard.  Edge shards concatenate in order."""
    pools: Dict[str, List[np.ndarray]] = {
        t: [np.asarray(s) for s in shards]
        for t, shards in nodes_by_type.items()}
    if include_edge_endpoints:
        for (s_t, _, d_t), shards in edges_by_etype.items():
            for src, dst in shards:
                pools.setdefault(s_t, []).append(np.asarray(src))
                pools.setdefault(d_t, []).append(np.asarray(dst))
    maps = {t: build_renumber_map(shards) for t, shards in pools.items()}
    edges = {}
    for et, shards in edges_by_etype.items():
        s_t, _, d_t = et
        src = np.concatenate([np.asarray(s) for s, _ in shards]) \
            if shards else np.zeros(0, np.int64)
        dst = np.concatenate([np.asarray(d) for _, d in shards]) \
            if shards else np.zeros(0, np.int64)
        edges[et] = (apply_renumber_map(maps[s_t], src),
                     apply_renumber_map(maps[d_t], dst))
    return RenumberedKG(maps=maps, edges=edges,
                        num_nodes={t: len(m) for t, m in maps.items()})
