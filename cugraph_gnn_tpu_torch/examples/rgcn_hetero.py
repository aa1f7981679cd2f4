"""Heterogeneous R-GCN node classification (ogbn-mag shape).

Counterpart of ``examples/rgcn_hetero.py``: a synthetic mag-like graph of
papers, authors and institutions with cites, writes and affiliated edges,
F = 32 features per node type and 8 paper classes, per-edge-type fanout
sampling (4, 4) through a typed ``NeighborLoader`` over the papers (batch
``min(--batch-size, 128)``), and an R-GCN of hidden width ``--hidden-dim //
4`` over the summed per-type features, trained with Adam.  Logs, per epoch,

    epoch k: loss L

Usage:
    python -m cugraph_gnn_tpu_torch.examples.rgcn_hetero --epochs 10

Runs on the card unless ``--device cpu`` is passed.  ``main`` returns the
epochs' losses.
"""

import time

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.examples.common import RelEncoder, loader_step
from cugraph_gnn_tpu_torch.loader import NeighborLoader
from cugraph_gnn_tpu_torch.models import RGCN
from cugraph_gnn_tpu_torch.utils.config import (
    add_model_options,
    add_sampler_options,
    add_training_options,
    make_parser,
)
from cugraph_gnn_tpu_torch.utils.logging import get_logger, set_log_level

FEAT_DIM, CLASSES = 32, 8
FANOUTS = [4, 4]
MAX_BATCH = 128


def parse_args(argv=None):
    p = make_parser(add_training_options, add_model_options, add_sampler_options)
    p.add_argument("--num-papers", type=int, default=2000)
    p.add_argument("--num-authors", type=int, default=1000)
    p.add_argument("--num-insts", type=int, default=100)
    p.add_argument("--device", default=None, help="cpu to run without a card")
    return p.parse_args(argv)


def make_data(args) -> dict:
    """The script's arrays from ``default_rng(0)``: per edge type (src, dst,
    (num_src, num_dst)), per node type its features, and the paper labels."""
    rng = np.random.default_rng(0)
    n_p, n_a, n_i = args.num_papers, args.num_authors, args.num_insts
    edges = {
        ("paper", "cites", "paper"): (rng.integers(0, n_p, n_p * 5),
                                      rng.integers(0, n_p, n_p * 5), (n_p, n_p)),
        ("author", "writes", "paper"): (rng.integers(0, n_a, n_p * 3),
                                        rng.integers(0, n_p, n_p * 3), (n_a, n_p)),
        ("institution", "affiliated", "author"): (rng.integers(0, n_i, n_a),
                                                  rng.integers(0, n_a, n_a), (n_i, n_a)),
    }
    x = {nt: rng.standard_normal((n, FEAT_DIM)).astype(np.float32)
         for nt, n in (("paper", n_p), ("author", n_a), ("institution", n_i))}
    y = rng.integers(0, CLASSES, n_p).astype(np.int32)
    return dict(edges=edges, x=x, y=y)


def make_stores(data, device):
    """(feature store, graph store) of ``make_data``'s arrays on ``device``."""
    gs = GraphStore(device=device)
    for et, (src, dst, sizes) in data["edges"].items():
        gs.put_edge_index((src, dst), et, num_nodes=sizes)
    fs = FeatureStore(device=device)
    for nt, x in data["x"].items():
        fs[(nt, "x")] = x
    fs[("paper", "y")] = data["y"]
    return fs, gs


def make_model(gs, hidden_dim: int, device=None) -> RelEncoder:
    """The R-GCN (32 -> hidden_dim // 4 -> 8, one relation per edge type in
    the sampling graph's order) in a ``RelEncoder``."""
    names = ["__".join(et) for et in gs.finalize().etypes]
    rgcn = RGCN(FEAT_DIM, num_relations=len(names), hidden_features=hidden_dim // 4,
                out_features=CLASSES, num_layers=len(FANOUTS), device=device)
    return RelEncoder(rgcn, names)


def make_loader(fs, gs, num_papers: int, batch_size: int):
    return NeighborLoader((fs, gs), num_neighbors=FANOUTS,
                          input_nodes=("paper", np.arange(num_papers)),
                          batch_size=min(batch_size, MAX_BATCH), shuffle=True)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    set_log_level(args.log_level)
    log = get_logger()
    fs, gs = make_stores(make_data(args), dev)
    loader = make_loader(fs, gs, args.num_papers, args.batch_size)
    torch.manual_seed(0)
    model = make_model(gs, args.hidden_dim, dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        tot = torch.zeros((), device=dev)
        for b in loader:
            tot += loader_step(model, opt, b)
        losses.append(float(tot) / len(loader))
        log.info("epoch %d: loss %.4f", epoch, losses[-1])
    return {"losses": losses, "batches": len(loader), "train_s": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
