"""Gradient-boosted trees over exported GNN embeddings.

Counterpart of ``examples/xgb_downstream.py``: node embeddings plus labels
(``--data_dir`` with ``x.npy`` (N, F) and ``y.npy`` (N,), or, without it, a
small GraphSAGE encoder trained on a synthetic graph and its all-node
export), a random 80/20 split (``default_rng(42)``), and scikit-learn's
``HistGradientBoostingClassifier`` (the histogram algorithm of XGBoost's
``tree_method="hist"``).  Prints

    embeddings: (N, F), classes: C
    Training hist-GBT model...
    train: mlogloss L acc A
    test: mlogloss L acc A

Usage:
    python -m cugraph_gnn_tpu_torch.examples.xgb_downstream --num_nodes 2000 --epochs 2

The trees need scikit-learn: without it ``main`` raises ``ImportError``
before it trains anything.  The encoder runs on the card unless ``--device
cpu`` is passed; ``make_embeddings`` is that part alone.
"""

import argparse
import os
import time

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.examples.common import loader_step
from cugraph_gnn_tpu_torch.loader import NeighborLoader
from cugraph_gnn_tpu_torch.models import GraphSAGE
from cugraph_gnn_tpu_torch.utils.datasets import random_graph, symmetrize

FEAT_DIM = 16
FANOUTS = [4, 4]
BATCH = 256


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", type=str, default=None,
                   help="directory with x.npy / y.npy embedding export")
    p.add_argument("--num_boost_round", type=int, default=4)
    p.add_argument("--max_depth", type=int, default=10)
    p.add_argument("--eta", type=float, default=0.1)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--num_nodes", type=int, default=2000)
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--hidden_dim", type=int, default=32)
    p.add_argument("--device", default=None, help="cpu to run without a card")
    return p.parse_args(argv)


def make_data(args) -> dict:
    """The encoder's arrays from ``default_rng(0)``: symmetrised power-law
    edges, features with the label planted on column 0, labels."""
    rng = np.random.default_rng(0)
    n, classes = args.num_nodes, args.num_classes
    g = symmetrize(random_graph(n, n * 8, power_law=True))
    x = rng.standard_normal((n, FEAT_DIM)).astype(np.float32)
    y = rng.integers(0, classes, size=n).astype(np.int32)
    x[:, 0] += 0.8 * y
    return dict(src=g.src, dst=g.dst, x=x, y=y)


def split(num_rows: int):
    """The script's 80/20 split: (train, test) masks from ``default_rng(42)``."""
    r = np.random.default_rng(42).random(num_rows)
    return r <= 0.8, r > 0.8


def make_stores(data, device):
    """(feature store, graph store) of ``make_data``'s arrays on ``device``."""
    n = data["x"].shape[0]
    gs = GraphStore(device=device)
    gs.put_edge_index((data["src"], data["dst"]), ("N", "e", "N"), num_nodes=(n, n))
    fs = FeatureStore(device=device)
    fs[("", "x")] = data["x"]
    fs[("", "y")] = data["y"]
    return fs, gs


def make_embeddings(args, train_mask, device=None, stats=None):
    """Train the small encoder on the ``train_mask`` nodes only and export
    [raw features | logits] for every node: ((N, F + C) float32, labels).
    ``stats``, when given, receives the losses, batch counts and seconds."""
    dev = resolve_device(device)
    data = make_data(args)
    n, classes = args.num_nodes, args.num_classes
    fs, gs = make_stores(data, dev)

    torch.manual_seed(0)
    model = GraphSAGE(FEAT_DIM, args.hidden_dim, classes, num_layers=2, device=dev)
    loader = NeighborLoader((fs, gs), num_neighbors=FANOUTS, batch_size=min(BATCH, n),
                            shuffle=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    mask = torch.as_tensor(train_mask, device=dev)
    losses = []
    t0 = time.perf_counter()
    for _ in range(args.epochs):
        losses += [loader_step(model, opt, b, mask) for b in loader]
    losses = torch.stack(losses).tolist() if losses else []
    train_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    emb = np.zeros((n, classes), np.float32)
    sweep = NeighborLoader((fs, gs), num_neighbors=FANOUTS, batch_size=min(BATCH, n),
                           shuffle=False)
    with torch.no_grad():
        for batch in sweep:
            z = model(batch.x, batch.sample).cpu().numpy()
            seeds = batch.seeds.cpu().numpy()
            valid = seeds >= 0
            emb[seeds[valid]] = z[:seeds.shape[0]][valid]
    if stats is not None:
        stats.update(losses=losses, train_batches=len(loader), export_batches=len(sweep),
                     train_s=train_s, export_s=time.perf_counter() - t0)
    return np.concatenate([data["x"], emb], axis=1).astype(np.float32), data["y"]


def main(argv=None):
    args = parse_args(argv)
    dev = None if args.data_dir else resolve_device(args.device)
    # the trees are the point: no scikit-learn, no run
    from sklearn.ensemble import HistGradientBoostingClassifier
    from sklearn.metrics import accuracy_score, log_loss

    stats = {}
    if args.data_dir:
        x = np.asarray(np.load(os.path.join(args.data_dir, "x.npy")), np.float32)
        y = np.asarray(np.load(os.path.join(args.data_dir, "y.npy")), np.int64)
        train, test = split(len(y))
    else:
        train, test = split(args.num_nodes)
        x, y = make_embeddings(args, train, dev, stats)
    print(f"embeddings: {x.shape}, classes: {len(np.unique(y))}", flush=True)

    clf = HistGradientBoostingClassifier(max_iter=args.num_boost_round,
                                         max_depth=args.max_depth, learning_rate=args.eta,
                                         random_state=0)
    print("Training hist-GBT model...", flush=True)
    t0 = time.perf_counter()
    clf.fit(x[train], y[train])
    stats["fit_s"] = time.perf_counter() - t0
    labels = np.unique(y)
    for name, mask in (("train", train), ("test", test)):
        prob = clf.predict_proba(x[mask])
        stats[f"{name}_mlogloss"] = float(log_loss(y[mask], prob, labels=labels))
        stats[f"{name}_acc"] = float(accuracy_score(y[mask], prob.argmax(1)))
        print(f"{name}: mlogloss {stats[f'{name}_mlogloss']:.4f}"
              f" acc {stats[f'{name}_acc']:.4f}", flush=True)
    return stats


if __name__ == "__main__":
    main()
