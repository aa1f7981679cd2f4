"""Heterogeneous distributed training: the loop of ``examples/hetero_dist_training.py``.

A raw-id knowledge graph (hashed user and item ids, taobao-style) is
renumbered (``utils/renumber.py``), put into a ``GraphStore`` (clicks and
their reverse) and a ``FeatureStore`` (each type's ``x``, the items'
labels), and every rank iterates a typed ``DistNeighborLoader`` over the
items together, runs the model on its own hetero batch and takes an Adam
step (``train_dist.dist_train_step``: the global masked mean loss, the
gradients summed over the ranks).

The models are the example's :class:`TypedSAGE` (a per-type input
projection, a mean over hop 0's neighbors per edge type, a classifier) and
the port's ``RGCN`` wrapped in ``train_hetero.RGCNEncoder``
(``RGCN.batch_call`` over the summed per-type features).  Both take
rank-local batches (``num_shards = 1``) as ``model(batch.x, batch.sample)``.

    mesh = utils.distributed.init(...)
    losses = train(mesh)

or, one process a device under a launcher that sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``:
``python -m cugraph_gnn_tpu_torch.train_hetero_dist``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.parallel.mesh import Mesh
from cugraph_gnn_tpu_torch.train_dist import dist_train_step

# the example's sizes: users, items, feature width, clicks, label classes,
# fanouts, batch, hidden width, Adam's rate
N_USER, N_ITEM, FEAT, CLICKS, CLASSES = 192, 128, 32, 1200, 4
FANOUTS = (4, 4)
BATCH, HIDDEN, LR = 32, 32, 2e-3
CLICK = ("user", "clicks", "item")
REV_CLICK = ("item", "rev_clicks", "user")


class TypedSAGE(nn.Module):
    """The example's typed model: each node type's features through its own
    ``Linear`` (``inputs[type]``, flax's ``in_<type>``) into the slots of
    that type, ReLU, the seeds' rows plus, per edge type of hop 0, the mean
    over their sampled neighbors (a masked sum over the fanout), ReLU, and
    ``out``.  ``ranges``: node type -> (offset, count) in the global ids.
    Built on ``device`` (default: the card)."""

    def __init__(self, in_features: Dict[str, int], ranges: Dict[str, Tuple[int, int]],
                 hidden: int = HIDDEN, classes: int = CLASSES, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.ranges = dict(ranges)
        self.hidden = hidden
        self.inputs = nn.ModuleDict({nt: nn.Linear(f, hidden, device=dev)
                                     for nt, f in sorted(in_features.items())})
        self.out = nn.Linear(hidden, classes, device=dev)

    def forward(self, x_by_type, sample) -> torch.Tensor:
        inp = sample.levels[-1]
        h = torch.zeros((inp.shape[0], self.hidden), device=inp.device)
        for nt in sorted(x_by_type):
            off, n = self.ranges[nt]
            is_t = (inp >= off) & (inp < off + n)
            h = torch.where(is_t[:, None], self.inputs[nt](x_by_type[nt]), h)
        h = torch.relu(h)
        agg = sample.dst_activations(h, 0)
        for name in sorted(sample.hops[0]):
            hop = sample.hops[0][name]
            neigh = sample.gather_neighbors(h, 0, name)
            agg = agg + torch.where(hop.mask[..., None], neigh, 0).sum(1) / hop.mask.shape[1]
        return self.out(torch.relu(agg))


def click_stores(seed: int = 0, device=None):
    """The example's data on ``device``: hashed user and item ids and their
    clicks, renumbered, as (feature store, graph store)."""
    from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
    from cugraph_gnn_tpu_torch.utils.renumber import renumber_kg

    rng = np.random.default_rng(seed)
    raw_user = rng.choice(10**9, N_USER, replace=False)
    raw_item = rng.choice(10**9, N_ITEM, replace=False)
    clicks_raw = (raw_user[rng.integers(0, N_USER, CLICKS)],
                  raw_item[rng.integers(0, N_ITEM, CLICKS)])
    kg = renumber_kg(nodes_by_type={"user": [raw_user], "item": [raw_item]},
                     edges_by_etype={CLICK: [clicks_raw]})
    src, dst = kg.edges[CLICK]
    gs, fs = GraphStore(device=device), FeatureStore(device=device)
    gs.put_edge_index((src, dst), CLICK, num_nodes=(N_USER, N_ITEM))
    gs.put_edge_index((dst, src), REV_CLICK, num_nodes=(N_ITEM, N_USER))
    fs[("user", "x")] = rng.standard_normal((N_USER, FEAT)).astype(np.float32)
    fs[("item", "x")] = rng.standard_normal((N_ITEM, FEAT)).astype(np.float32)
    fs[("item", "y")] = (np.arange(N_ITEM) % CLASSES).astype(np.int32)
    return fs, gs


def train(mesh: Mesh, epochs: int = 8, seed: int = 0) -> List[float]:
    """The example's loop on ``mesh``: the typed loader over every item
    (batch 32, fanouts 4/4), :class:`TypedSAGE` from ``torch.manual_seed(0)``
    (the same weights on every rank), Adam 2e-3, ``epochs`` epochs.
    Returns the global losses."""
    from cugraph_gnn_tpu_torch.loader import DistNeighborLoader

    fs, gs = click_stores(seed, mesh.device)
    loader = DistNeighborLoader((fs, gs), FANOUTS, mesh, input_nodes=("item", np.arange(N_ITEM)),
                                batch_size=BATCH, seed=seed)
    ranges = {nt: (gs.node_offset(nt), gs.num_nodes(nt)) for nt in gs.node_types}
    torch.manual_seed(0)
    model = TypedSAGE({nt: FEAT for nt in gs.node_types}, ranges, device=mesh.device)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    losses = []
    for _ in range(epochs):
        for batch in loader:
            losses.append(float(dist_train_step(model, opt, batch, mesh)))
    return losses


if __name__ == "__main__":
    from cugraph_gnn_tpu_torch.utils import distributed as D

    mesh = D.init()
    try:
        out = train(mesh)
        if mesh.rank == 0:
            print(f"first loss {out[0]:.3f} -> last {out[-1]:.3f}")
    finally:
        D.finalize()
