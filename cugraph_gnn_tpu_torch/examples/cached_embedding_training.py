"""Training with a device-cached, host-resident embedding table.

Counterpart of ``examples/cached_embedding_training.py`` (the reference's
``--cache_type local_device`` configuration): a learnable node-embedding
table in host memory behind ``CachedHostEmbedding`` (AdaGrad, a
set-associative LFU cache of ``--cache-ratio`` of the rows on the card),
GraphSAGE over a ``NeighborSampler`` on a synthetic power-law graph, Adam
for the model.  Each step gathers the batch's rows through the cache, adds
a zero tap whose gradient is the rows' gradient, and applies the rows'
update through the cache (dirty rows write back on eviction and at the
final ``flush``).  Prints, per epoch,

    epoch k: loss L cache hit rate H

Usage:
    python -m cugraph_gnn_tpu_torch.examples.cached_embedding_training --epochs 3

Runs on the card unless ``--device cpu`` is passed.  ``main`` returns the
epochs' losses and the hit rate.
"""

import time

import numpy as np
import torch
from torch.nn import functional as F

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch._native import build_csr
from cugraph_gnn_tpu_torch.embedding import CachedHostEmbedding
from cugraph_gnn_tpu_torch.models import GraphSAGE
from cugraph_gnn_tpu_torch.sampler import NeighborSampler
from cugraph_gnn_tpu_torch.utils.config import (
    add_model_options,
    add_sampler_options,
    add_training_options,
    make_parser,
    parse_fanouts,
)
from cugraph_gnn_tpu_torch.utils.datasets import random_graph

CLASSES = 8


def parse_args(argv=None):
    p = make_parser(add_training_options, add_model_options, add_sampler_options)
    p.add_argument("--num-nodes", type=int, default=20000)
    p.add_argument("--num-edges", type=int, default=100000)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--cache-ratio", type=float, default=0.1)
    p.add_argument("--device", default=None, help="cpu to run without a card")
    return p.parse_args(argv)


def make_data(args) -> dict:
    """The script's arrays from ``default_rng(0)``: the reversed CSR of a
    power-law graph, labels, and the initial table 0.05 * N(0, 1)."""
    rng = np.random.default_rng(0)
    n = args.num_nodes
    g = random_graph(n, args.num_edges, seed=0, power_law=True)
    indptr, indices, _ = build_csr(g.dst, g.src, n)
    labels = rng.integers(0, CLASSES, n).astype(np.int32)
    table = (0.05 * rng.standard_normal((n, args.dim))).astype(np.float32)
    return dict(indptr=indptr, indices=indices, labels=labels, table=table)


def train_step(model, optimizer, emb, sample, labels, lr: float) -> torch.Tensor:
    """One step: the rows through the cache plus a tap, forward, the masked
    cross-entropy over the valid seeds, backward, Adam on the model, the
    rows' gradients into the embedding and its sparse AdaGrad update.
    Returns the loss (on the device)."""
    ids = sample.input_nodes
    rows = emb.gather(ids)
    tap = emb.make_tap(ids.shape[0])
    optimizer.zero_grad(set_to_none=True)
    seeds = sample.levels[0]
    valid = seeds >= 0
    logits = model(rows + tap, sample).float()
    ls = F.cross_entropy(logits, labels[seeds.clamp(min=0).long()].long(), reduction="none")
    loss = torch.where(valid, ls, 0).sum() / valid.sum().clamp(min=1)
    loss.backward()
    optimizer.step()
    emb.add_gradients(ids, tap.grad)
    emb.apply_gradients(lr=lr)
    return loss.detach()


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    data = make_data(args)
    n = args.num_nodes
    emb = CachedHostEmbedding(data["table"], optimizer="adagrad",
                              cache_ratio=args.cache_ratio, ways=8, device=dev)
    fanouts = parse_fanouts(args.neighbors)
    sampler = NeighborSampler(data["indptr"], data["indices"], fanouts, device=dev)
    torch.manual_seed(0)
    model = GraphSAGE(args.dim, args.hidden_dim, CLASSES, num_layers=len(fanouts), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    labels = torch.as_tensor(data["labels"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    steps = max(n // args.batch_size, 1)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        tot = torch.zeros((), device=dev)
        for _ in range(steps):
            seeds = torch.randint(0, n, (args.batch_size,), generator=gen, device=dev,
                                  dtype=torch.int32)
            sample = sampler.sample(seeds, generator=gen)
            tot += train_step(model, opt, emb, sample, labels, args.lr)
        losses.append(float(tot) / steps)
        print(f"epoch {epoch}: loss {losses[-1]:.4f} cache hit rate {emb.hit_rate:.2f}",
              flush=True)
    emb.flush()
    return {"losses": losses, "hit_rate": emb.hit_rate, "steps_per_epoch": steps,
            "train_s": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
