"""Distributed full-batch GCN training, row-sharded over the ranks of a
process group.

Counterpart of ``examples/dist_full_batch_training.py``: a locality graph
(``--mean-degree`` sources per node within +-``--band``) with planted
4-block community labels, RCM-reordered when that widens the band
(``reorder="auto"``), split into R = 128-row slabs and row-sharded
(``ops/dist_full_batch.py::DistFullBatchGraph``: one R-row halo exchange a
neighbouring rank, the fallback edges through the rank's table); GCN (16 ->
32 -> 4) with replicated parameters and Adam through
``train_full.dist_full_batch_step``.  Prints

    mesh=W devices, band_fraction=B
    epoch k: loss L            (every 20th epoch)
    full-batch distributed accuracy: A

checks ``A > 0.8`` and prints ``OK``.  It runs over the first ``min(--devices,
world size)`` ranks of the current process group, one process a device (JAX
takes ``min(--devices, len(jax.devices()))`` devices), or starts a world of
one:

    python -m cugraph_gnn_tpu_torch.examples.dist_full_batch_training --devices 8
    torchrun --nproc-per-node 4 -m cugraph_gnn_tpu_torch.examples.dist_full_batch_training

Runs on the card (NCCL) unless ``--device cpu`` is passed (gloo).  ``--tpu``
is accepted for the JAX script's command lines and changes nothing.
``main`` returns the printed losses and the accuracy.
"""

import argparse
import time

import numpy as np
import torch

from cugraph_gnn_tpu_torch.examples.common import example_mesh
from cugraph_gnn_tpu_torch.models import GCN
from cugraph_gnn_tpu_torch.ops.dist_full_batch import DistFullBatchGraph
from cugraph_gnn_tpu_torch.train_full import dist_full_batch_step

FEAT_DIM, HIDDEN, CLASSES = 16, 32, 4
BLOCK_ROWS = 128


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--num-nodes", type=int, default=4096)
    p.add_argument("--mean-degree", type=int, default=6)
    p.add_argument("--band", type=int, default=200)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--tpu", action="store_true",
                   help="accepted for the JAX script's command lines; no effect")
    p.add_argument("--device", default=None, help="cpu to run without a card")
    return p.parse_args(argv)


def make_data(args) -> dict:
    """The script's arrays from ``default_rng(0)``: edges src -> dst, labels
    and features (N(0, 1) plus half the label)."""
    n = args.num_nodes
    rng = np.random.default_rng(0)
    deg = args.mean_degree
    src = np.clip(np.repeat(np.arange(n), deg)
                  + rng.integers(-args.band, args.band + 1, n * deg), 0, n - 1)
    dst = np.repeat(np.arange(n), deg)
    labels = (np.arange(n) * 4) // n
    x = (rng.standard_normal((n, FEAT_DIM)) + labels[:, None] * 0.5).astype(np.float32)
    return dict(src=src, dst=dst, labels=labels, x=x)


def train(mesh, args, data, log=print):
    """Build the sharded graph on ``mesh``, train, and return (the printed
    losses, the accuracy over every node, the graph)."""
    n = args.num_nodes
    g = DistFullBatchGraph.from_coo(data["src"], data["dst"], n, mesh, reorder="auto",
                                    block_rows=BLOCK_ROWS)
    log(f"mesh={mesh.world} devices, band_fraction={g.band_fraction:.2f}")
    labels = g.to_graph_order(data["labels"])
    xs = g.shard(g.to_graph_order(data["x"]))
    ys = g.shard(labels.astype(np.int64))
    valid = g.shard(np.ones(n, np.float32))
    torch.manual_seed(0)          # the same weights on every rank
    model = GCN(FEAT_DIM, HIDDEN, CLASSES, num_layers=2, device=mesh.device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    printed = []
    for epoch in range(args.epochs):
        loss = dist_full_batch_step(model, opt, xs, g, ys, valid)
        if epoch % 20 == 19:
            printed.append(float(loss))
            log(f"epoch {epoch + 1}: loss {printed[-1]:.4f}")
    with torch.no_grad():
        pred = g.unshard(model.full_graph(xs, g).argmax(-1)).numpy()
    return printed, float((pred == labels).mean()), g


def main(argv=None):
    args = parse_args(argv)
    data = make_data(args)
    with example_mesh(args.devices, args.device) as mesh:
        if mesh is None:
            return None

        def log(line):
            if mesh.rank == 0:
                print(line, flush=True)

        t0 = time.perf_counter()
        losses, acc, g = train(mesh, args, data, log)
        log(f"full-batch distributed accuracy: {acc:.3f}")
        assert acc > 0.8, acc
        log("OK")
        return {"losses": losses, "accuracy": acc, "world": mesh.world,
                "band_fraction": g.band_fraction, "wall_s": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
