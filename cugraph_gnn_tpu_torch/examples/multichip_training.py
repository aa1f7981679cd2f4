"""Multi-device training through ``DistNeighborLoader``: the loader is the
multi-device path (sharded stores, distributed sampling, the cross-shard
feature gather) behind the single-device loader surface.

Counterpart of ``examples/multichip_training.py`` (the reference's
``gcn_dist_mnmg.py`` loop): a uniform random graph, F-wide features and 8
classes; GraphSAGE (hidden 64) with Adam 1e-2 through
``train_dist.dist_train_step`` (the global masked mean loss, gradients
summed over the ranks).  Logs every fourth step's

    epoch e step s: loss L

and last ``done (D devices, N nodes, E edges)``.  It runs over the first
``min(--devices, world size)`` ranks of the current process group, one
process a device (JAX takes ``min(--devices, len(jax.devices()))``
devices); with no group it starts a world of one:

    python -m cugraph_gnn_tpu_torch.examples.multichip_training --devices 8
    torchrun --nproc-per-node 4 -m cugraph_gnn_tpu_torch.examples.multichip_training

Runs on the card (NCCL) unless ``--device cpu`` is passed (gloo).  ``main``
returns the logged losses.
"""

import argparse

import numpy as np
import torch

from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.examples.common import example_mesh
from cugraph_gnn_tpu_torch.loader import DistNeighborLoader
from cugraph_gnn_tpu_torch.models import GraphSAGE
from cugraph_gnn_tpu_torch.train_dist import dist_train_step
from cugraph_gnn_tpu_torch.utils.logging import get_logger, set_log_level

FANOUTS = [5, 5]
HIDDEN, CLASSES, LR = 64, 8, 1e-2


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--num-nodes", type=int, default=4096)
    p.add_argument("--num-edges", type=int, default=40960)
    p.add_argument("--feat-dim", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--device", default=None, help="cpu to run without a card")
    return p.parse_args(argv)


def make_data(args) -> dict:
    """The script's arrays from ``default_rng(0)``: uniform edges, features
    and labels."""
    rng = np.random.default_rng(0)
    n, e = args.num_nodes, args.num_edges
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, args.feat_dim)).astype(np.float32)
    y = rng.integers(0, CLASSES, n).astype(np.int32)
    return dict(src=src, dst=dst, x=x, y=y)


def make_stores(data, device):
    n = data["x"].shape[0]
    gs = GraphStore(device=device)
    gs.put_edge_index((data["src"], data["dst"]), ("N", "e", "N"), num_nodes=(n, n))
    fs = FeatureStore(device=device)
    fs[("", "x")] = data["x"]
    fs[("", "y")] = data["y"]
    return fs, gs


def train(mesh, args, log=None):
    """The script's loop on ``mesh``; returns every step's global loss."""
    fs, gs = make_stores(make_data(args), mesh.device)
    loader = DistNeighborLoader((fs, gs), FANOUTS, mesh, batch_size=args.batch_size,
                                shuffle=True)
    torch.manual_seed(1)          # the same weights on every rank
    model = GraphSAGE(args.feat_dim, HIDDEN, CLASSES, num_layers=len(FANOUTS),
                      device=mesh.device)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    losses = []
    for epoch in range(args.epochs):
        for step, batch in enumerate(loader):
            losses.append(dist_train_step(model, opt, batch, mesh))
            if step % 4 == 0 and log is not None:
                log.info("epoch %d step %d: loss %.4f", epoch, step, float(losses[-1]))
    return torch.stack(losses).tolist()


def main(argv=None):
    args = parse_args(argv)
    set_log_level("info")
    log = get_logger()
    with example_mesh(args.devices, args.device) as mesh:
        if mesh is None:
            return None
        losses = train(mesh, args, log if mesh.rank == 0 else None)
        if mesh.rank == 0:
            log.info("done (%d devices, %d nodes, %d edges)", mesh.world, args.num_nodes,
                     args.num_edges)
        return {"losses": losses, "world": mesh.world}


if __name__ == "__main__":
    main()
