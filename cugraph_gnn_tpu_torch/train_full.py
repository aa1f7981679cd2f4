"""Full-batch GraphSAGE / GCN / GAT training over a banded graph at
ogbn-products scale: data and one optimizer step.

The step of ``examples/full_batch_training.py`` in the JAX package: the whole
graph's forward through ``FullBatchGraph`` (GraphSAGE and GCN: the slab SpMM
kernels, the fallback through the CSR SpMM kernel; GAT: the fused attention
kernels), mean softmax cross-entropy over every node, backward (the slab
kernels over the transposed graph; the attention backward kernel) and Adam
(lr 5e-3, whose defaults match ``optax.adam``).  GAT is
``benchmarks/model_bench.py``'s ``gat4h``: ``HEADS`` heads of
``HIDDEN // HEADS`` features, then one head of ``CLASSES``, in float32.

The graph is the banded construction of the JAX package's slab benchmarks
(``benchmarks/dist_slab_bench.py``: ``deg`` sources per row, uniform within
+-``band`` of the row) plus ``far`` uniform sources per row, so that the
fallback kernel does real work.  It is banded by construction, so it needs no
reordering: build its ``FullBatchGraph`` with ``reorder="none"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.nn import functional as F

from cugraph_gnn_tpu_torch._device import resolve_device

NUM_NODES = 2_449_029
DEG = 12
BAND = 256
FAR = 1
FEAT_DIM = 128
HIDDEN = 256
CLASSES = 47
HEADS = 4
BLOCK_ROWS = 256
LR = 5e-3


@dataclass
class BandedGraph:
    """COO edges src -> dst on the host (for ``FullBatchGraph.from_coo``),
    node features and labels on one device."""

    src: np.ndarray         # (E,) int32
    dst: np.ndarray         # (E,) int32
    feats: torch.Tensor     # (N, F) float32
    labels: torch.Tensor    # (N,) int64

    @property
    def num_nodes(self) -> int:
        return self.labels.shape[0]

    @property
    def num_edges(self) -> int:
        return self.src.shape[0]


def make_synthetic_banded(seed: int = 0, device=None, *,
                          num_nodes: int = NUM_NODES, deg: int = DEG,
                          band: int = BAND, far: int = FAR,
                          feat_dim: int = FEAT_DIM,
                          classes: int = CLASSES) -> BandedGraph:
    """``deg`` in-band and ``far`` uniform sources for every node.

    Edges come from ``np.random.default_rng(seed)``: row r's in-band sources
    are ``clip(r + U{-band..band}, 0, N-1)`` (the JAX slab benchmarks'
    construction), its far sources ``U{0..N-1}``.  Features (standard
    normal) and labels (uniform) are drawn on ``device`` (default: the card)
    from a ``torch.Generator`` seeded with ``seed``.
    """
    dev = resolve_device(device)
    host = np.random.default_rng(seed)
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    near = np.clip(rows + host.integers(-band, band + 1, num_nodes * deg),
                   0, num_nodes - 1)
    src = np.concatenate([near, host.integers(0, num_nodes, num_nodes * far)])
    dst = np.concatenate([rows, np.repeat(np.arange(num_nodes, dtype=np.int64), far)])
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((num_nodes, feat_dim), generator=gen, device=dev)
    labels = torch.randint(0, classes, (num_nodes,), generator=gen, device=dev)
    return BandedGraph(src.astype(np.int32), dst.astype(np.int32), feats, labels)


def full_batch_step(model, optimizer, x, fbg, labels) -> torch.Tensor:
    """One step: ``model.full_graph(x, fbg)``, mean softmax cross-entropy over
    every node (logits in float32), backward, optimizer update.  x and labels
    in fbg's graph order.  Returns the loss (float32, on the device, not
    synchronised); the parameters' ``.grad`` hold this step's gradients."""
    optimizer.zero_grad(set_to_none=True)
    logits = model.full_graph(x, fbg).float()
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    optimizer.step()
    return loss.detach()
