"""Carry a JAX embedding's arrays into the port.

``embedding_from_jax_arrays`` takes the table and the optimizer state of the
JAX package's ``DistEmbedding`` or ``CachedHostEmbedding`` as numpy arrays
(global row order) and builds the port's counterpart holding the same
values, so that both packages continue one training run or are held to the
same computation.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch.embedding.cached import CachedHostEmbedding
from cugraph_gnn_tpu_torch.embedding.embedding import DistEmbedding
from cugraph_gnn_tpu_torch.embedding.optimizers import SPECS
from cugraph_gnn_tpu_torch.parallel.mesh import Mesh
from cugraph_gnn_tpu_torch.store.dist_array import DistArray


def embedding_from_jax_arrays(table, state: Dict[str, np.ndarray], optimizer: str,
                              hyper: Optional[dict] = None, *, device=None,
                              mesh: Optional[Mesh] = None, capacity: Optional[int] = None,
                              cache_ratio: float = 0.2, ways: int = 8):
    """The port's embedding with the values of ``table`` (N, dim) and
    ``state`` (name -> rows; the first N rows are taken, as a JAX
    ``DistEmbedding``'s padded even layout starts with the global rows).

    With ``mesh``: a ``DistEmbedding`` row-sharded over it (every rank
    passes the whole arrays).  Without: a ``CachedHostEmbedding`` on
    ``device`` (default: the card) over a copy of the table in host memory,
    with ``capacity`` or ``cache_ratio`` and ``ways`` (flush the JAX cache
    first: its host table is stale until then)."""
    table = np.array(table, dtype=np.float32)
    n = table.shape[0]
    names = set(SPECS[optimizer].state_widths)
    if set(state) != names:
        raise ValueError(f"{optimizer} keeps the state {sorted(names)}, got {sorted(state)}")
    if mesh is not None:
        emb = DistEmbedding(DistArray.from_array(table, mesh), optimizer=optimizer,
                            hyper=hyper)
        for k, v in state.items():
            emb._state[k] = DistArray.from_array(np.asarray(v)[:n], mesh,
                                                 dtype=torch.float32).data
        return emb
    emb = CachedHostEmbedding(table, optimizer=optimizer, hyper=hyper, capacity=capacity,
                              cache_ratio=cache_ratio, ways=ways, device=device)
    for k, v in state.items():
        emb._state[k][:] = np.asarray(v)[:n]
    return emb
