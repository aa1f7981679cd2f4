"""Fraud detection: GNN embeddings + a downstream classifier.

Counterpart of ``examples/fraud_detection.py``: an Elliptic-shaped synthetic
transaction graph (power law, symmetrised) whose fraud labels are planted on
a feature direction plus a neighbourhood signal only the GNN can see; a GNN
encoder with a 2-logit head trained on the labelled nodes through a
``NeighborLoader``; an export sweep over every node (embedding and GNN
score); then a downstream classifier on [raw features | embedding] against
one on the raw features alone.  Prints each epoch's

    epoch k: loss L

then, per classifier, the confusion matrix, accuracy and ROC AUC under
"RF with GNN", "GNN Only" and "RF Only", and last

    gnn-embedding lift: acc +A auc +B

The downstream model is scikit-learn's ``RandomForestClassifier(n_estimators=60,
random_state=0)``; where scikit-learn is not installed, a logistic probe on
the same design matrix (:class:`LogisticProbe`, plain torch on the host)
takes its place, and a line before the matrices says which one ran.

Usage:
    python -m cugraph_gnn_tpu_torch.examples.fraud_detection --num-nodes 4000 --epochs 4

Runs on the card unless ``--device cpu`` is passed.  ``main`` returns the
epochs' losses, the metrics and which downstream model ran.
"""

import time

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.examples.common import loader_step
from cugraph_gnn_tpu_torch.loader import NeighborLoader
from cugraph_gnn_tpu_torch.models.builder import create_gnn_model
from cugraph_gnn_tpu_torch.train_link import link_auc
from cugraph_gnn_tpu_torch.utils.config import (
    add_model_options,
    add_sampler_options,
    add_training_options,
    make_parser,
    parse_fanouts,
)
from cugraph_gnn_tpu_torch.utils.datasets import random_graph, symmetrize

DOWNSTREAM = {"random_forest": "random forest (scikit-learn)",
              "logistic_probe": "logistic probe (scikit-learn is not installed)"}


def parse_args(argv=None):
    p = make_parser(add_training_options, add_model_options, add_sampler_options)
    p.add_argument("--num-nodes", type=int, default=4000)
    p.add_argument("--avg-degree", type=int, default=10)
    p.add_argument("--feat-dim", type=int, default=32)
    p.add_argument("--fraud-frac", type=float, default=0.15)
    p.add_argument("--device", default=None, help="cpu to run without a card")
    return p.parse_args(argv)


def make_data(args) -> dict:
    """The script's arrays from ``default_rng(7)``: symmetrised edges (src,
    dst), features x, labels y and the train / test masks."""
    rng = np.random.default_rng(7)
    n = args.num_nodes
    g = symmetrize(random_graph(n, n * args.avg_degree, power_law=True))
    # fraud rings: fraud probability rises with the share of fraud-prone
    # neighbours, so the label signal is partly relational
    prone = rng.random(n) < args.fraud_frac
    neigh_frac = np.zeros(n)
    deg = np.bincount(g.dst, minlength=n).clip(1)
    np.add.at(neigh_frac, g.dst, prone[g.src].astype(np.float64))
    neigh_frac /= deg
    raw = 0.25 * prone + 0.75 * neigh_frac + 0.05 * rng.standard_normal(n)
    y = (raw > np.quantile(raw, 1.0 - args.fraud_frac)).astype(np.int32)
    x = rng.standard_normal((n, args.feat_dim)).astype(np.float32)
    x[:, 0] += 1.5 * prone       # the feature carries prone-ness, not the label
    train_mask = rng.random(n) < 0.7
    return dict(src=g.src, dst=g.dst, x=x, y=y, train_mask=train_mask, test_mask=~train_mask)


def make_stores(data, device):
    """(feature store, graph store) of ``make_data``'s arrays on ``device``."""
    n = data["x"].shape[0]
    gs = GraphStore(device=device)
    gs.put_edge_index((data["src"], data["dst"]), ("N", "e", "N"), num_nodes=(n, n))
    fs = FeatureStore(device=device)
    fs[("", "x")] = data["x"]
    fs[("", "y")] = data["y"]
    return fs, gs


class Encoder(nn.Module):
    """The script's encoder: ``enc`` (a zoo model emitting ``hidden``
    features), ReLU, then ``lin``, the 2-logit head.  ``encode`` returns
    (z, logits), the embedding before the head and the logits; the forward
    the logits alone (``common.loader_step``'s model)."""

    def __init__(self, enc, hidden: int, device=None):
        super().__init__()
        self.enc = enc
        self.lin = nn.Linear(hidden, 2, device=resolve_device(device))

    def encode(self, x, sample):
        z = torch.relu(self.enc(x, sample))
        return z, self.lin(z)

    def forward(self, x, sample):
        return self.encode(x, sample)[1]


def make_model(args, feat_dim: int, device=None) -> Encoder:
    """``create_gnn_model(args.model)`` emitting ``hidden_dim`` features, one
    layer a fanout, in the :class:`Encoder`."""
    enc = create_gnn_model(args.model, in_feat_dim=feat_dim, class_count=args.hidden_dim,
                           hidden_feat_dim=args.hidden_dim,
                           num_layers=len(parse_fanouts(args.neighbors)),
                           num_heads=args.heads, device=device)
    return Encoder(enc, args.hidden_dim, device=device)


@torch.no_grad()
def embed(model, x, sample):
    """(z, the softmax's fraud column) of one batch."""
    z, logits = model.encode(x, sample)
    return z, torch.softmax(logits, dim=-1)[:, 1]


def export(model, fs, gs, fanouts, batch_size: int, num_nodes: int, hidden: int):
    """The sweep over every node: (embedding (N, hidden), GNN score (N,)) on
    the host, and the number of batches."""
    loader = NeighborLoader((fs, gs), num_neighbors=fanouts, batch_size=batch_size,
                            shuffle=False)
    emb = np.zeros((num_nodes, hidden), np.float32)
    score = np.zeros(num_nodes, np.float32)
    for batch in loader:
        z, s = embed(model, batch.x, batch.sample)
        seeds = batch.seeds.cpu().numpy()
        valid = seeds >= 0
        bs = seeds.shape[0]
        emb[seeds[valid]] = z[:bs].cpu().numpy()[valid]
        score[seeds[valid]] = s[:bs].cpu().numpy()[valid]
    return emb, score, len(loader)


class LogisticProbe:
    """L2-regularised logistic regression (scikit-learn's defaults: C = 1,
    an intercept, L-BFGS), on standardised columns, in float64 on the host:
    the downstream model where scikit-learn is missing."""

    def fit(self, x, y):
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
        t = torch.as_tensor(np.asarray(y), dtype=torch.float64)
        self.mean = x.mean(0)
        self.std = x.std(0).clamp(min=1e-12)
        z = (x - self.mean) / self.std
        self.w = torch.zeros(z.shape[1], dtype=torch.float64, requires_grad=True)
        self.b = torch.zeros((), dtype=torch.float64, requires_grad=True)
        opt = torch.optim.LBFGS([self.w, self.b], max_iter=200, line_search_fn="strong_wolfe")

        def closure():
            opt.zero_grad()
            loss = (F.binary_cross_entropy_with_logits(z @ self.w + self.b, t, reduction="sum")
                    + 0.5 * (self.w ** 2).sum())
            loss.backward()
            return loss

        opt.step(closure)
        return self

    @torch.no_grad()
    def predict_proba(self, x):
        z = (torch.as_tensor(np.asarray(x), dtype=torch.float64) - self.mean) / self.std
        p = torch.sigmoid(z @ self.w + self.b).numpy()
        return np.stack([1 - p, p], axis=1)


def train_forest(x_train, y_train):
    """(fitted model, kind): scikit-learn's random forest, or the
    :class:`LogisticProbe` where scikit-learn does not import."""
    try:
        from sklearn.ensemble import RandomForestClassifier
    except ImportError:
        return LogisticProbe().fit(x_train, y_train), "logistic_probe"
    return RandomForestClassifier(n_estimators=60, random_state=0).fit(x_train, y_train), \
        "random_forest"


def show_confusion_matrix(y_test, prob, name):
    """Print the confusion matrix, accuracy and rank ROC AUC; return (acc,
    auc)."""
    pred = prob.argmax(axis=1)
    cm = np.zeros((2, 2), np.int64)
    np.add.at(cm, (y_test.astype(np.int64), pred.astype(np.int64)), 1)
    acc = float((y_test == pred).mean())
    auc = link_auc(prob[:, 1], y_test == 1)
    print(f"=== {name} ===\nConfusion Matrix:\n{cm}\n"
          f"Accuracy: {acc:.4f}\nROC AUC: {auc:.4f}\n")
    return acc, auc


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    data = make_data(args)
    n = args.num_nodes
    fs, gs = make_stores(data, dev)
    fanouts = parse_fanouts(args.neighbors)
    loader = NeighborLoader((fs, gs), num_neighbors=fanouts, batch_size=min(args.batch_size, n),
                            shuffle=True,
                            input_nodes=np.nonzero(data["train_mask"])[0].astype(np.int64))
    torch.manual_seed(0)
    model = make_model(args, data["x"].shape[1], dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    losses = []
    t0 = time.perf_counter()
    for ep in range(args.epochs):
        tot = torch.zeros((), device=dev)
        for batch in loader:
            tot += loader_step(model, opt, batch)
        losses.append(float(tot) / max(len(loader), 1))
        print(f"epoch {ep}: loss {losses[-1]:.4f}", flush=True)
    train_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    emb, score, sweep = export(model, fs, gs, fanouts, min(args.batch_size, n), n,
                               args.hidden_dim)
    export_s = time.perf_counter() - t0

    x, y = data["x"], data["y"]
    train, test = data["train_mask"], data["test_mask"]
    t0 = time.perf_counter()
    design = np.concatenate([x, emb], axis=1)
    rf_gnn, kind = train_forest(design[train], y[train])
    print(f"downstream model: {DOWNSTREAM[kind]}", flush=True)
    acc_gnn, auc_gnn = show_confusion_matrix(y[test], rf_gnn.predict_proba(design[test]),
                                             "RF with GNN")
    zz = np.stack([1 - score[test], score[test]], axis=1)
    acc_only, auc_only = show_confusion_matrix(y[test], zz, "GNN Only")
    rf_only, _ = train_forest(x[train], y[train])
    acc_rf, auc_rf = show_confusion_matrix(y[test], rf_only.predict_proba(x[test]), "RF Only")
    fit_s = time.perf_counter() - t0
    print(f"gnn-embedding lift: acc {acc_gnn - acc_rf:+.4f} auc {auc_gnn - auc_rf:+.4f}",
          flush=True)
    return {"losses": losses, "downstream": kind, "train_batches": len(loader),
            "export_batches": sweep, "train_s": train_s, "export_s": export_s,
            "downstream_s": fit_s, "rf_with_gnn": (acc_gnn, auc_gnn),
            "gnn_only": (acc_only, auc_only), "rf_only": (acc_rf, auc_rf)}


if __name__ == "__main__":
    main()
