"""MovieLens-shaped temporal bipartite recommendation.

Counterpart of ``examples/movielens_rec.py``: users and movies in taste
clusters, ratings with int32 times on both edge orientations, positives the
ratings >= 4, temporal link prediction through a typed
``LinkNeighborLoader`` (``time_attr="t"``: a seed samples only edges no
newer than its edge's time; binary negatives), an R-GCN encoder (F = 16 ->
hidden -> hidden) over the summed per-type features and a dot-product
decoder under sigmoid cross-entropy, trained with Adam.  Prints, per epoch,

    epoch k: loss L acc A

Usage:
    python -m cugraph_gnn_tpu_torch.examples.movielens_rec --epochs 5

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
CLUSTERS = 6
RATES = ("user", "rates", "movie")
REV_RATES = ("movie", "rev_rates", "user")


def parse_args(argv=None):
    p = make_parser(add_training_options, add_model_options, add_sampler_options)
    p.add_argument("--num-users", type=int, default=600)
    p.add_argument("--num-movies", type=int, default=900)
    p.add_argument("--num-ratings", type=int, default=8000)
    p.add_argument("--device", default=None, help="cpu to run without a card")
    return p.parse_args(argv)


def make_data(args) -> dict:
    """The script's arrays from ``default_rng(0)``: ratings (src user, dst
    movie, rating, time), features, and the positives (ratings >= 4) with
    their times."""
    rng = np.random.default_rng(0)
    n_u, n_m, n_r = args.num_users, args.num_movies, args.num_ratings
    u_c = rng.integers(0, CLUSTERS, n_u)
    m_c = rng.integers(0, CLUSTERS, n_m)
    src = rng.integers(0, n_u, n_r)
    dst = rng.integers(0, n_m, n_r)
    match = u_c[src] == m_c[dst]
    rating = np.where(match, rng.integers(4, 6, n_r), rng.integers(1, 4, n_r)).astype(np.int32)
    time_ = rng.integers(0, 1000, n_r).astype(np.int32)
    x = {"user": rng.standard_normal((n_u, FEAT_DIM)).astype(np.float32),
         "movie": rng.standard_normal((n_m, FEAT_DIM)).astype(np.float32)}
    hi = rating >= 4
    return dict(src=src, dst=dst, rating=rating, time=time_, x=x,
                eli=np.stack([src[hi], dst[hi]]), elt=time_[hi],
                num_users=n_u, num_movies=n_m)


def make_stores(data, device):
    """(feature store, graph store): both orientations of the ratings, each
    type's features and each orientation's times."""
    n_u, n_m = data["num_users"], data["num_movies"]
    gs = GraphStore(device=device)
    gs.put_edge_index((data["src"], data["dst"]), RATES, num_nodes=(n_u, n_m))
    gs.put_edge_index((data["dst"], data["src"]), REV_RATES, num_nodes=(n_m, n_u))
    fs = FeatureStore(device=device)
    fs[("user", "x")] = data["x"]["user"]
    fs[("movie", "x")] = data["x"]["movie"]
    fs[("__".join(RATES), "t")] = data["time"]
    fs[("__".join(REV_RATES), "t")] = data["time"]
    return fs, gs


def make_loader(fs, gs, data, fanouts, batch_size: int):
    return LinkNeighborLoader((fs, gs), num_neighbors=fanouts,
                              edge_label_index=(RATES, data["eli"]), neg_sampling="binary",
                              batch_size=batch_size, shuffle=True, time_attr="t",
                              edge_label_time=data["elt"])


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
    loader = make_loader(fs, gs, data, fanouts, args.batch_size)
    torch.manual_seed(0)
    model = make_model(gs, args.hidden_dim, len(fanouts), dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    losses, accs = [], []
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        tot = torch.zeros((), device=dev)
        acc_tot = torch.zeros((), device=dev)
        for b in loader:
            loss, acc = train_step(model, opt, b)
            tot += loss
            acc_tot += acc
        losses.append(float(tot) / max(len(loader), 1))
        accs.append(float(acc_tot) / max(len(loader), 1))
        print(f"epoch {epoch}: loss {losses[-1]:.4f} acc {accs[-1]:.3f}", flush=True)
    return {"losses": losses, "accs": accs, "batches": len(loader),
            "train_s": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
