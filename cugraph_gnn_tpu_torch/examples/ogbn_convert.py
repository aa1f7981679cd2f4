"""Convert an OGB node-property dataset to the binary files that
``ogbn_train`` reads.

Counterpart of ``examples/ogbn_convert.py``; for the same arguments it writes
the same files, byte for byte:

    <out>/node_feat_part_{i}.bin       float32 rows, the nodes split evenly
    <out>/labels.bin                   int32
    <out>/edges_src.bin, edges_dst.bin int32
    <out>/{train,valid,test}_idx.bin   int64
    <out>/meta.json

Usage:
    python -m cugraph_gnn_tpu_torch.examples.ogbn_convert --dataset ogbn-products --out DIR
    python -m cugraph_gnn_tpu_torch.examples.ogbn_convert --synthetic N E F --out DIR

An OGB dataset needs the ``ogb`` package and its download; ``--synthetic N E
F`` draws N nodes, E edges and F-wide features from ``default_rng(0)``
instead, with 40 classes and a 60/20/20 split.  The conversion is host
work: it touches no device.
"""

import argparse
import json
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="ogbn-arxiv")
    p.add_argument("--out", required=True)
    p.add_argument("--parts", type=int, default=8)
    p.add_argument("--synthetic", nargs=3, type=int, metavar=("N", "E", "F"),
                   help="generate synthetic data instead of OGB download")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        n, e, f = args.synthetic
        rng = np.random.default_rng(0)
        feat = rng.standard_normal((n, f)).astype(np.float32)
        labels = rng.integers(0, 40, n).astype(np.int32)
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, n, e).astype(np.int32)
        num_classes = 40
        perm = rng.permutation(n)
        splits = {"train": perm[: int(0.6 * n)],
                  "valid": perm[int(0.6 * n): int(0.8 * n)],
                  "test": perm[int(0.8 * n):]}
    else:
        from ogb.nodeproppred import NodePropPredDataset
        dataset = NodePropPredDataset(name=args.dataset)
        graph, label = dataset[0]
        feat = graph["node_feat"].astype(np.float32)
        labels = np.nan_to_num(label.reshape(-1), nan=-1).astype(np.int32)
        src = graph["edge_index"][0].astype(np.int32)
        dst = graph["edge_index"][1].astype(np.int32)
        n, f = feat.shape
        e = len(src)
        num_classes = int(dataset.num_classes)
        splits = dataset.get_idx_split()

    # feature shard files (row-partitioned, an even split)
    bounds = np.linspace(0, n, args.parts + 1).astype(np.int64)
    files = []
    for i in range(args.parts):
        path = os.path.join(args.out, f"node_feat_part_{i}.bin")
        feat[bounds[i]:bounds[i + 1]].tofile(path)
        files.append(os.path.basename(path))
    labels.tofile(os.path.join(args.out, "labels.bin"))
    src.tofile(os.path.join(args.out, "edges_src.bin"))
    dst.tofile(os.path.join(args.out, "edges_dst.bin"))
    for name, idx in splits.items():
        np.asarray(idx).astype(np.int64).tofile(os.path.join(args.out, f"{name}_idx.bin"))
    with open(os.path.join(args.out, "meta.json"), "w") as fh:
        json.dump({
            "num_nodes": int(n), "num_edges": int(e), "feat_dim": int(f),
            "num_classes": num_classes, "feat_files": files,
        }, fh)
    print(f"wrote {args.parts} feature shards + edges to {args.out}")


if __name__ == "__main__":
    main()
