"""Dataset helpers: the karate club edge list and synthetic graphs.

Counterpart of ``cugraph_gnn_tpu/utils/datasets.py``.  Everything here is
host NumPy drawn from ``np.random.default_rng``, so for the same arguments
each function returns the JAX package's arrays bit for bit.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

# where load_karate looks when given no path: the repository's datasets/
KARATE_DEFAULT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                              "datasets", "karate.csv")


class Graph(NamedTuple):
    """Host-side COO graph container used for data prep."""

    src: np.ndarray
    dst: np.ndarray
    num_nodes: int
    edge_weight: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return len(self.src)


def load_karate(path: Optional[str] = None) -> Graph:
    """The karate-club edge list: whitespace-separated "src dst weight" rows
    (int32 ends, float32 weights when the file has a third column), from
    ``path`` or the repository's ``datasets/karate.csv``."""
    if path is None:
        if not os.path.exists(KARATE_DEFAULT):
            raise FileNotFoundError(f"no karate edge list at {KARATE_DEFAULT}; pass a path")
        path = KARATE_DEFAULT
    data = np.loadtxt(path)
    src = data[:, 0].astype(np.int32)
    dst = data[:, 1].astype(np.int32)
    w = data[:, 2].astype(np.float32) if data.shape[1] > 2 else None
    n = int(max(src.max(), dst.max())) + 1
    return Graph(src=src, dst=dst, num_nodes=n, edge_weight=w)


def symmetrize(g: Graph) -> Graph:
    """Both directions of every edge, duplicates removed (ordered by
    src * num_nodes + dst); weights follow their edges."""
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    w = None if g.edge_weight is None else np.concatenate([g.edge_weight, g.edge_weight])
    key = src.astype(np.int64) * g.num_nodes + dst
    _, idx = np.unique(key, return_index=True)
    return Graph(src=src[idx], dst=dst[idx], num_nodes=g.num_nodes,
                 edge_weight=None if w is None else w[idx])


def random_graph(num_nodes: int, num_edges: int, seed: int = 0,
                 power_law: bool = False) -> Graph:
    """A synthetic directed graph: uniform endpoints, or with
    ``power_law=True`` endpoints from a Pareto draw over a random node order
    (a skewed degree distribution, as OGB graphs have)."""
    rng = np.random.default_rng(seed)
    if power_law:
        ranks = rng.pareto(1.5, size=2 * num_edges)
        ids = np.minimum((ranks / ranks.max() * (num_nodes - 1)), num_nodes - 1)
        ids = rng.permutation(num_nodes)[ids.astype(np.int64) % num_nodes]
        src, dst = ids[:num_edges], ids[num_edges:]
    else:
        src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
        dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    return Graph(src=src.astype(np.int32), dst=dst.astype(np.int32), num_nodes=num_nodes)
