"""Link prediction: ``LinkNeighborLoader`` and a dot-product decoder.

Counterpart of ``examples/link_prediction.py``: the karate club's edges as
positives (``utils.datasets.load_karate``, symmetrised), one-hot node
features, binary negatives rejecting true edges, batch ``min(--batch-size,
32)``, GraphSAGE (hidden ``--hidden-dim``, 16 out) with Adam through
``train_link.link_step``; logs

    epoch k: loss L          (every 5th epoch and the last)

then the rank AUC of positives against negatives over one more pass:

    link-pred AUC: A

Usage:
    python -m cugraph_gnn_tpu_torch.examples.link_prediction --dataset karate --epochs 20

Runs on the card unless ``--device cpu`` is passed.  ``main`` returns the
epochs' losses and the AUC.
"""

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader
from cugraph_gnn_tpu_torch.models import GraphSAGE
from cugraph_gnn_tpu_torch.train_link import link_auc, link_eval_scores, link_step
from cugraph_gnn_tpu_torch.utils.config import (
    add_model_options,
    add_sampler_options,
    add_training_options,
    make_parser,
    parse_fanouts,
)
from cugraph_gnn_tpu_torch.utils.datasets import load_karate, symmetrize
from cugraph_gnn_tpu_torch.utils.logging import get_logger, set_log_level

OUT = 16
MAX_BATCH = 32


def parse_args(argv=None):
    p = make_parser(add_training_options, add_model_options, add_sampler_options)
    p.add_argument("--dataset", default="karate")
    p.add_argument("--device", default=None, help="cpu to run without a card")
    return p.parse_args(argv)


def make_data() -> dict:
    """The symmetrised karate edges and one-hot features."""
    g = symmetrize(load_karate())
    return dict(src=g.src, dst=g.dst, num_nodes=g.num_nodes,
                x=np.eye(g.num_nodes, dtype=np.float32))


def make_stores(data, device):
    """(feature store, graph store) of ``make_data``'s arrays on ``device``."""
    n = data["num_nodes"]
    gs = GraphStore(device=device)
    gs.put_edge_index((data["src"], data["dst"]), ("N", "e", "N"), num_nodes=(n, n))
    fs = FeatureStore(device=device)
    fs[("", "x")] = data["x"]
    return fs, gs


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    set_log_level(args.log_level)
    log = get_logger()
    data = make_data()
    n = data["num_nodes"]
    fs, gs = make_stores(data, dev)
    fanouts = parse_fanouts(args.neighbors)
    loader = LinkNeighborLoader((fs, gs), num_neighbors=fanouts,
                                edge_label_index=np.stack([data["src"], data["dst"]]),
                                neg_sampling="binary", batch_size=min(args.batch_size, MAX_BATCH),
                                shuffle=True, reject_true_edges=True)
    torch.manual_seed(0)
    model = GraphSAGE(n, args.hidden_dim, OUT, num_layers=len(fanouts), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    losses = []
    for epoch in range(args.epochs):
        tot = torch.zeros((), device=dev)
        for b in loader:
            tot += link_step(model, opt, b)
        losses.append(float(tot) / len(loader))
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            log.info("epoch %d: loss %.4f", epoch, losses[-1])
    scores, labels = zip(*(link_eval_scores(model, b) for b in loader))
    auc = link_auc(np.concatenate(scores), np.concatenate(labels))
    print(f"link-pred AUC: {auc:.4f}", flush=True)
    return {"losses": losses, "auc": auc, "batches": len(loader)}


if __name__ == "__main__":
    main()
