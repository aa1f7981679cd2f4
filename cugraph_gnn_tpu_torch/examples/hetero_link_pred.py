"""Heterogeneous link prediction (ogbn-mag author-writes-paper shape).

Counterpart of ``examples/hetero_link_pred.py``: papers and authors with
cites and writes edges (F = 16 per node type), edge seeds of the one
relation ('author', 'writes', 'paper') through a typed
``LinkNeighborLoader`` (binary negatives drawn inside the author and paper
types), an R-GCN encoder (16 -> hidden -> hidden) and a dot-product decoder
under sigmoid cross-entropy, trained with Adam.  ``--disjoint`` gives every
seed its own typed subgraph; the encoder then runs over the flattened
disjoint batch (one block a seed), where JAX ``vmap``s it over the seeds,
and each seed's embedding is its own block's row.  Prints, per epoch,

    epoch k: loss L acc A

(A: the last batch's accuracy of the score's sign.)

Usage:
    python -m cugraph_gnn_tpu_torch.examples.hetero_link_pred --epochs 5 [--disjoint]

Runs on the card unless ``--device cpu`` is passed.  ``main`` returns the
epochs' losses and accuracies.
"""

import time

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.examples.common import RelEncoder
from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader
from cugraph_gnn_tpu_torch.models import RGCN
from cugraph_gnn_tpu_torch.train_link import link_step
from cugraph_gnn_tpu_torch.utils.config import (
    add_model_options,
    add_sampler_options,
    add_training_options,
    make_parser,
    parse_fanouts,
)

FEAT_DIM = 16
WRITES = ("author", "writes", "paper")


def parse_args(argv=None):
    p = make_parser(add_training_options, add_model_options, add_sampler_options)
    p.add_argument("--num-papers", type=int, default=2000)
    p.add_argument("--num-authors", type=int, default=1000)
    p.add_argument("--num-writes", type=int, default=6000)
    p.add_argument("--disjoint", action="store_true",
                   help="independent per-seed subgraphs (PyG disjoint mode; the decoder "
                        "reads each seed's own row)")
    p.add_argument("--device", default=None, help="cpu to run without a card")
    return p.parse_args(argv)


def make_data(args) -> dict:
    """The script's arrays from ``default_rng(0)``: cites (4 per paper) and
    writes edges, paper and author features."""
    rng = np.random.default_rng(0)
    n_p, n_a, n_w = args.num_papers, args.num_authors, args.num_writes
    cites = (rng.integers(0, n_p, 4 * n_p), rng.integers(0, n_p, 4 * n_p))
    w_src = rng.integers(0, n_a, n_w)
    w_dst = rng.integers(0, n_p, n_w)
    x = {"paper": rng.standard_normal((n_p, FEAT_DIM)).astype(np.float32),
         "author": rng.standard_normal((n_a, FEAT_DIM)).astype(np.float32)}
    return dict(cites=cites, writes=(w_src, w_dst), x=x, num_papers=n_p, num_authors=n_a)


def make_stores(data, device):
    """(feature store, graph store) of ``make_data``'s arrays on ``device``."""
    n_p, n_a = data["num_papers"], data["num_authors"]
    gs = GraphStore(device=device)
    gs.put_edge_index(data["cites"], ("paper", "cites", "paper"), num_nodes=(n_p, n_p))
    gs.put_edge_index(data["writes"], WRITES, num_nodes=(n_a, n_p))
    fs = FeatureStore(device=device)
    fs[("paper", "x")] = data["x"]["paper"]
    fs[("author", "x")] = data["x"]["author"]
    return fs, gs


def make_loader(fs, gs, data, fanouts, batch_size: int, disjoint: bool):
    return LinkNeighborLoader((fs, gs), num_neighbors=fanouts,
                              edge_label_index=(WRITES, np.stack(data["writes"])),
                              neg_sampling="binary", batch_size=batch_size, shuffle=True,
                              disjoint=disjoint)


def make_model(gs, hidden_dim: int, num_layers: int, device=None) -> RelEncoder:
    """The R-GCN encoder (16 -> hidden -> hidden) in a ``RelEncoder``."""
    names = ["__".join(et) for et in gs.finalize().etypes]
    rgcn = RGCN(FEAT_DIM, num_relations=len(names), hidden_features=hidden_dim,
                out_features=hidden_dim, num_layers=num_layers, device=device)
    return RelEncoder(rgcn, names)


def train_step(model, optimizer, batch):
    """One step; (loss, accuracy) on the device."""
    return link_step(model, optimizer, batch, accuracy=True)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    data = make_data(args)
    fs, gs = make_stores(data, dev)
    fanouts = parse_fanouts(args.neighbors)
    loader = make_loader(fs, gs, data, fanouts, args.batch_size, args.disjoint)
    torch.manual_seed(0)
    model = make_model(gs, args.hidden_dim, len(fanouts), dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    losses, accs = [], []
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        tot = torch.zeros((), device=dev)
        acc = torch.zeros((), device=dev)
        for batch in loader:
            loss, acc = train_step(model, opt, batch)
            tot += loss
        losses.append(float(tot) / max(len(loader), 1))
        accs.append(float(acc))
        print(f"epoch {epoch}: loss {losses[-1]:.4f} acc {accs[-1]:.3f}", flush=True)
    return {"losses": losses, "accs": accs, "batches": len(loader),
            "train_s": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
