"""OGB node classification over the files of ``ogbn_convert``.

Counterpart of ``examples/ogbn_train.py``: load the converted features,
labels, edges and splits, put the edges both ways into a ``GraphStore`` (OGB
products and arxiv are used undirected) and the features, padded to a
multiple of 128, into a ``FeatureStore``, train GraphSAGE with Adam through
``NeighborLoader(dedup=False)`` and print, per epoch,

    epoch k: loss L valid_acc A test_acc A

Usage:
    python -m cugraph_gnn_tpu_torch.examples.ogbn_convert --synthetic N E F --out DIR
    python -m cugraph_gnn_tpu_torch.examples.ogbn_train --dir DIR --epochs 10

Runs on the card (the row gather and the fused sampler are its CUDA
kernels) unless ``--device cpu`` is passed.  ``main`` returns each epoch's
loss, accuracies and training seconds.
"""

import json
import os
import time

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.examples.common import accuracy, loader_step
from cugraph_gnn_tpu_torch.loader import NeighborLoader
from cugraph_gnn_tpu_torch.models import GraphSAGE
from cugraph_gnn_tpu_torch.utils.config import (
    add_model_options,
    add_sampler_options,
    add_training_options,
    make_parser,
    parse_fanouts,
)

PAD = 128   # feature width multiple of the store


def main(argv=None):
    p = make_parser(add_training_options, add_model_options, add_sampler_options)
    p.add_argument("--dir", required=True, help="output directory of ogbn_convert")
    p.add_argument("--device", default=None, help="cpu to run without a card")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    with open(os.path.join(args.dir, "meta.json")) as fh:
        meta = json.load(fh)
    n, f = meta["num_nodes"], meta["feat_dim"]
    feat = np.concatenate([np.fromfile(os.path.join(args.dir, fn), np.float32).reshape(-1, f)
                           for fn in meta["feat_files"]])
    if feat.shape[0] != n:
        raise ValueError(f"{feat.shape[0]} feature rows, meta.json says {n} nodes")
    labels = np.fromfile(os.path.join(args.dir, "labels.bin"), np.int32)
    src = np.fromfile(os.path.join(args.dir, "edges_src.bin"), np.int32)
    dst = np.fromfile(os.path.join(args.dir, "edges_dst.bin"), np.int32)
    splits = {
        name: np.fromfile(os.path.join(args.dir, f"{name}_idx.bin"), np.int64)
        for name in ("train", "valid", "test")
        if os.path.exists(os.path.join(args.dir, f"{name}_idx.bin"))
    }

    gs = GraphStore(device=dev)
    gs.put_edge_index((np.concatenate([src, dst]), np.concatenate([dst, src])),
                      ("", "to", ""), num_nodes=(n, n))
    fs = FeatureStore(pad_features_to=PAD, device=dev)
    fs[("", "x")] = feat
    fs[("", "y")] = labels
    del feat

    fanouts = parse_fanouts(args.neighbors)
    width = -(-f // PAD) * PAD
    torch.manual_seed(0)
    model = GraphSAGE(width, hidden_features=args.hidden_dim,
                      out_features=meta["num_classes"], num_layers=len(fanouts), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    def make_loader(idx, shuffle):
        return NeighborLoader((fs, gs), num_neighbors=fanouts, input_nodes=idx,
                              batch_size=args.batch_size, shuffle=shuffle, dedup=False)

    train_loader = make_loader(splits["train"], True)
    epochs = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        tot = torch.zeros((), device=dev)
        for b in train_loader:
            tot += loader_step(model, opt, b)
        row = {"epoch": epoch, "loss": float(tot) / max(len(train_loader), 1),
               "train_s": time.perf_counter() - t0, "batches": len(train_loader)}
        msg = f"epoch {epoch}: loss {row['loss']:.4f}"
        for name in ("valid", "test"):
            if name in splits:
                row[f"{name}_acc"] = accuracy(model, make_loader(splits[name], False))
                msg += f" {name}_acc {row[f'{name}_acc']:.4f}"
        print(msg, flush=True)
        epochs.append(row)
    return {"num_nodes": n, "feat_dim": width, "edges": 2 * len(src), "epochs": epochs}


if __name__ == "__main__":
    main()
