"""Node classification: sampled minibatch GraphSAGE / GCN / GAT / GIN.

Counterpart of ``examples/node_classification.py``: build the stores from
the karate club (``--dataset karate``) or a synthetic power-law graph
(``--dataset synthetic``), train through a ``NeighborLoader`` with Adam, log
each epoch's loss and time, and print the training set's accuracy last:

    train accuracy: A

Usage:
    python -m cugraph_gnn_tpu_torch.examples.node_classification --dataset karate --model sage
    python -m cugraph_gnn_tpu_torch.examples.node_classification --dataset synthetic \\
        --num-nodes 100000 --num-edges 2000000 --model gat

Runs on the card unless ``--device cpu`` is passed.  ``main`` returns the
epochs' losses and the accuracy.
"""

import time

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.examples.common import accuracy, loader_step
from cugraph_gnn_tpu_torch.loader import NeighborLoader
from cugraph_gnn_tpu_torch.models import create_gnn_model
from cugraph_gnn_tpu_torch.utils.config import (
    add_graph_options,
    add_model_options,
    add_sampler_options,
    add_training_options,
    make_parser,
    parse_fanouts,
)
from cugraph_gnn_tpu_torch.utils.datasets import load_karate, random_graph, symmetrize
from cugraph_gnn_tpu_torch.utils.logging import get_logger, set_log_level

# the karate club's "Mr. Hi" faction: class 0, the rest class 1
MR_HI = {0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 16, 17, 19, 21}


def main(argv=None):
    p = make_parser(add_training_options, add_graph_options, add_model_options,
                    add_sampler_options)
    p.add_argument("--num-nodes", type=int, default=10000)
    p.add_argument("--num-edges", type=int, default=100000)
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--device", default=None, help="cpu to run without a card")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    set_log_level(args.log_level)
    log = get_logger()

    rng = np.random.default_rng(0)
    if args.dataset == "karate":
        g = symmetrize(load_karate())
        feat_dim = g.num_nodes
        x = np.eye(g.num_nodes, dtype=np.float32)
        num_classes = 2
        y = np.array([0 if i in MR_HI else 1 for i in range(g.num_nodes)], np.int32)
    else:
        g = random_graph(args.num_nodes, args.num_edges, power_law=True)
        feat_dim = args.feat_dim
        x = rng.standard_normal((g.num_nodes, feat_dim)).astype(np.float32)
        y = rng.integers(0, args.num_classes, g.num_nodes).astype(np.int32)
        num_classes = args.num_classes

    gs = GraphStore(device=dev)
    gs.put_edge_index((g.src, g.dst), ("N", "e", "N"), num_nodes=(g.num_nodes, g.num_nodes))
    fs = FeatureStore(device=dev)
    fs[("", "x")] = x
    fs[("", "y")] = y

    fanouts = parse_fanouts(args.neighbors)
    t0 = time.perf_counter()
    loader = NeighborLoader((fs, gs), num_neighbors=fanouts,
                            batch_size=min(args.batch_size, g.num_nodes), shuffle=True)
    log.info("prep time: %.2fs", time.perf_counter() - t0)

    torch.manual_seed(0)
    model = create_gnn_model(args.model, in_feat_dim=feat_dim, class_count=num_classes,
                             hidden_feat_dim=args.hidden_dim, num_layers=len(fanouts),
                             num_heads=args.heads, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    losses = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        tot = torch.zeros((), device=dev)
        for b in loader:
            tot += loader_step(model, opt, b)
        losses.append(float(tot) / len(loader))
        dt = time.perf_counter() - t0
        log.info("epoch %d: loss %.4f  (%.2fs, %.3fs/iter)",
                 epoch, losses[-1], dt, dt / len(loader))

    acc = accuracy(model, loader)
    log.info("train accuracy: %.4f", acc)
    # machine-parseable line for the example quality gates
    print(f"train accuracy: {acc:.4f}", flush=True)
    return {"losses": losses, "train_accuracy": acc, "batches": len(loader)}


if __name__ == "__main__":
    main()
