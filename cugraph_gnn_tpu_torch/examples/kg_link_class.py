"""Knowledge-graph link classification (ogbl-wikikg2 shape).

Counterpart of ``examples/kg_link_class.py``: one entity type, R relations
stored as a per-edge attribute of a homogeneous graph (relation r mostly
links entity cluster r to cluster r + 1), learned entity embeddings (the
graph has no features), and an R-GCN encoder that reads the relation of
every sampled edge (``RGCNConv.edgewise``, the FastRGCNConv pattern);
GAE-style dot-product scores over the positive seed edges and binary
negatives under sigmoid cross-entropy, trained with Adam.  The relation
attribute is put into CSR edge-id order once
(``SamplingGraph.edge_attr_to_csr_order``), so that the sampled edge ids
index it.  Prints, per epoch,

    epoch k: loss L acc A

Usage:
    python -m cugraph_gnn_tpu_torch.examples.kg_link_class --epochs 5

Runs on the card unless ``--device cpu`` is passed.  ``main`` returns the
epochs' losses and accuracies.
"""

import time

import numpy as np
import torch
from torch import nn

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader
from cugraph_gnn_tpu_torch.models.conv import RGCNConv
from cugraph_gnn_tpu_torch.train_link import link_step
from cugraph_gnn_tpu_torch.utils.config import (
    add_model_options,
    add_sampler_options,
    add_training_options,
    make_parser,
    parse_fanouts,
)

EDGE = ("n", "e", "n")


def parse_args(argv=None):
    p = make_parser(add_training_options, add_model_options, add_sampler_options)
    p.add_argument("--num-entities", type=int, default=2000)
    p.add_argument("--num-relations", type=int, default=6)
    p.add_argument("--num-edges", type=int, default=12000)
    p.add_argument("--device", default=None, help="cpu to run without a card")
    return p.parse_args(argv)


def make_data(args) -> dict:
    """The script's triples from ``default_rng(0)``: relation r links cluster
    r to cluster (r + 1) % R, 10% of the heads' tails uniform."""
    rng = np.random.default_rng(0)
    n, n_rel, n_e = args.num_entities, args.num_relations, args.num_edges
    rel = rng.integers(0, n_rel, n_e).astype(np.int32)
    csize = n // n_rel
    src = (rel * csize + rng.integers(0, csize, n_e)).astype(np.int32)
    dst = (((rel + 1) % n_rel) * csize + rng.integers(0, csize, n_e)).astype(np.int32)
    noise = rng.random(n_e) < 0.1
    dst[noise] = rng.integers(0, n, noise.sum())
    return dict(src=src, dst=dst, rel=rel, num_entities=n, num_relations=n_rel)


def make_stores(data, device):
    """(feature store, graph store): the triples as one edge type, and a
    (N, 1) zero ``x`` so that the loader has features to join (the model
    does not read them)."""
    n = data["num_entities"]
    gs = GraphStore(device=device)
    gs.put_edge_index((data["src"], data["dst"]), EDGE, num_nodes=(n, n))
    fs = FeatureStore(device=device)
    fs[("", "x")] = np.zeros((n, 1), np.float32)
    return fs, gs


def make_loader(fs, gs, data, fanouts, batch_size: int):
    return LinkNeighborLoader((fs, gs), num_neighbors=fanouts,
                              edge_label_index=np.stack([data["src"], data["dst"]]),
                              neg_sampling="binary", batch_size=batch_size, shuffle=True)


class KGEncoder(nn.Module):
    """Learned entity embeddings (``node_emb``, Xavier uniform) and one
    ``RGCNConv`` a hop (``convs[i]``, flax's ``conv_<i>``), hidden wide,
    over each sampled edge's relation; ReLU between.  Built on ``device``
    (default: the card)."""

    def __init__(self, num_entities: int, hidden: int, num_relations: int, num_layers: int,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.node_emb = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty((num_entities, hidden), device=dev)))
        self.convs = nn.ModuleList([RGCNConv(hidden, hidden, num_relations, device=dev)
                                    for _ in range(num_layers)])

    def forward(self, sample, rel_by_hop):
        """``rel_by_hop[l]``: the relation of every slot of hop l (S_l, k)."""
        inp = sample.input_nodes
        h = torch.where((inp >= 0)[:, None], self.node_emb[inp.clamp(min=0).long()], 0)
        num_hops = sample.num_hops
        for li in range(num_hops - 1, -1, -1):
            conv = self.convs[num_hops - 1 - li]
            h = conv.edgewise(sample.dst_activations(h, li), sample.gather_neighbors(h, li),
                              sample.hops[li].mask, rel_by_hop[li])
            if li != 0:
                h = torch.relu(h)
        return h


def relations_of(sample, rel_csr):
    """Each hop's relation ids: ``rel_csr`` at the sampled edge ids (-1
    slots read edge 0; the mask drops them)."""
    return [rel_csr[hop.edge_ids.clamp(min=0).long()] for hop in sample.hops]


def train_step(model, optimizer, batch, rel_csr):
    """One step; (loss, accuracy) on the device."""
    return link_step(model, optimizer, batch, accuracy=True,
                     embed=lambda b: model(b.sample, relations_of(b.sample, rel_csr)))


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    data = make_data(args)
    fs, gs = make_stores(data, dev)
    fanouts = parse_fanouts(args.neighbors)
    loader = make_loader(fs, gs, data, fanouts, args.batch_size)
    rel_csr = gs.finalize().edge_attr_to_csr_order(EDGE, data["rel"])
    torch.manual_seed(0)
    model = KGEncoder(data["num_entities"], args.hidden_dim, data["num_relations"],
                      len(fanouts), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    losses, accs = [], []
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        tot = torch.zeros((), device=dev)
        acc_tot = torch.zeros((), device=dev)
        for b in loader:
            loss, acc = train_step(model, opt, b, rel_csr)
            tot += loss
            acc_tot += acc
        losses.append(float(tot) / max(len(loader), 1))
        accs.append(float(acc_tot) / max(len(loader), 1))
        print(f"epoch {epoch}: loss {losses[-1]:.4f} acc {accs[-1]:.3f}", flush=True)
    return {"losses": losses, "accs": accs, "batches": len(loader),
            "train_s": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
