"""Full-batch training over a ``FullBatchGraph``: GCN, GraphSAGE, GAT or
R-GCN on the karate club.

Counterpart of ``examples/full_batch_training.py``: the graph reordered
(RCM, when that widens the band) and split into banded slabs (GCN, SAGE:
the slab SpMM kernel; GAT: the fused attention forward and backward
kernels; R-GCN: two relations by endpoint parity, one slab graph each on a
shared order through ``RelationalFullBatch``); node data moved into graph
order once; 16 features from ``default_rng(0)``; the model (16 -> 16 -> 2,
GAT with 4 heads) trained with Adam (5e-3, GAT 1e-2) through
``train_full.full_batch_step``.  Prints

    epoch k: loss L                                  (every 20th epoch)
    full-batch MODEL accuracy: A (band fraction B)

checks ``A > 0.9`` and prints ``OK``.  The karate edge list comes from
``utils.datasets.load_karate``.

Usage:
    python -m cugraph_gnn_tpu_torch.examples.full_batch_training [--model gat]

Runs on the card unless ``--device cpu`` is passed.  ``main`` returns the
printed losses and the accuracy.
"""

import argparse

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.models import GAT, GCN, RGCN, GraphSAGE
from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph, RelationalFullBatch
from cugraph_gnn_tpu_torch.train_full import full_batch_step
from cugraph_gnn_tpu_torch.utils.datasets import load_karate, symmetrize

FEAT_DIM, HIDDEN, CLASSES = 16, 16, 2
# the second community of the script's karate split
COMMUNITY_1 = [8, 9, 14, 15, 18, 20, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33]
MODELS = {
    "gcn": lambda dev: GCN(FEAT_DIM, HIDDEN, CLASSES, num_layers=2, device=dev),
    "sage": lambda dev: GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=2, device=dev),
    "gat": lambda dev: GAT(FEAT_DIM, HIDDEN, CLASSES, num_layers=2, heads=4, device=dev),
    "rgcn": lambda dev: RGCN(FEAT_DIM, num_relations=2, hidden_features=HIDDEN,
                             out_features=CLASSES, num_layers=2, device=dev),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=("gcn", "sage", "gat", "rgcn"), default="gcn")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--device", default=None, help="cpu to run without a card")
    return p.parse_args(argv)


def make_data(model: str) -> dict:
    """The script's arrays: the symmetrised karate edges, the labels, the
    relation of each edge (``rgcn``: endpoint parity) and the features
    (``default_rng(0)``)."""
    g = symmetrize(load_karate())
    labels = np.zeros(g.num_nodes, np.int32)
    labels[COMMUNITY_1] = 1
    etype = None
    if model == "rgcn":
        etype = ((np.asarray(g.src) + np.asarray(g.dst)) % 2).astype(np.int32)
    x = np.random.default_rng(0).standard_normal((g.num_nodes, FEAT_DIM)).astype(np.float32)
    return dict(src=g.src, dst=g.dst, num_nodes=g.num_nodes, labels=labels, etype=etype, x=x)


def make_graph(data, device):
    if data["etype"] is not None:
        return RelationalFullBatch(data["src"], data["dst"], data["etype"], 2,
                                   data["num_nodes"], device=device)
    return FullBatchGraph.from_coo(data["src"], data["dst"], data["num_nodes"],
                                   reorder="auto", device=device)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    data = make_data(args.model)
    fbg = make_graph(data, dev)
    x = fbg.to_graph_order(torch.as_tensor(data["x"], device=dev))
    y = fbg.to_graph_order(torch.as_tensor(data["labels"], device=dev)).long()
    torch.manual_seed(0)
    model = MODELS[args.model](dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3 if args.model != "gat" else 1e-2)
    printed = []
    for epoch in range(args.epochs):
        loss = full_batch_step(model, opt, x, fbg, y)
        if epoch % 20 == 19:
            printed.append(float(loss))
            print(f"epoch {epoch + 1}: loss {printed[-1]:.4f}", flush=True)
    with torch.no_grad():
        acc = float((model.full_graph(x, fbg).argmax(-1) == y).float().mean())
    print(f"full-batch {args.model} accuracy: {acc:.3f} "
          f"(band fraction {fbg.band_fraction:.2f})", flush=True)
    assert acc > 0.9
    print("OK", flush=True)
    return {"losses": printed, "accuracy": acc, "band_fraction": fbg.band_fraction}


if __name__ == "__main__":
    main()
