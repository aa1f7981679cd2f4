"""Sampled R-GCN training at ogbn-mag scale: data, typed sampling, the feature
gather and one optimizer step.

The hetero part of ``benchmarks/model_bench.py`` (``part_b``) in the JAX
package: papers, authors and fields in one id space (papers first, as there),
three edge types into papers with power-law in-degrees, each block REPS
steps of 512 paper seeds sampled as one flattened frontier per hop per edge
type with typed target segments (``sampler/hetero.py::hetero_multihop_batched``:
one launch of the uniform sampler per hop and edge type), each step's input
rows gathered from the f32 table into bf16 (one row-gather launch), R-GCN
forward and backward through ``RGCN.batch_call``, and Adam (lr 1e-3, whose
defaults match ``optax.adam``).

Also the pieces the loaders' hetero paths share: the synthetic graph as a
``GraphStore`` / ``FeatureStore`` pair, the per-type feature dict summed into
one input, a loader step, and an R-GCN link encoder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows
from cugraph_gnn_tpu_torch.sampler.hetero import HeteroMultihopBatch, hetero_multihop_batched

# ogbn-mag's node counts, classes and part_b's schedule: fanouts per edge
# type (seed side first), mean in-degrees of papers per type (power law
# floor(c u^-0.5), c = mean / 2, capped at 2000), F = 128, hidden 256
MAG_NODES = {"paper": 736_389, "author": 1_134_649, "field": 59_965}
ETYPES = ("paper__cites__paper", "author__writes__paper", "field__rev_has_topic__paper")
FANOUTS = {"paper__cites__paper": [8, 8], "author__writes__paper": [8, 8],
           "field__rev_has_topic__paper": [4, 4]}
MEAN_DEG = {"paper__cites__paper": 7.4, "author__writes__paper": 9.6,
            "field__rev_has_topic__paper": 10.2}
DEG_CAP = 2000
FEAT_DIM = 128
HIDDEN = 256
CLASSES = 349
BATCH = 512
REPS = 10
LR = 1e-3


def _types(name: str) -> Tuple[str, str, str]:
    src, rel, dst = name.split("__")
    return src, rel, dst


def _offsets(num_nodes: Dict[str, int]) -> Dict[str, int]:
    """Each node type's first id in the one id space: papers, then authors,
    then fields."""
    off, first = 0, {}
    for nt in ("paper", "author", "field"):
        first[nt] = off
        off += num_nodes[nt]
    return first


@dataclass
class SyntheticMag:
    """Per-edge-type reversed CSRs over one id space (papers, then authors,
    then fields), node features and paper labels, all on one device."""

    csrs: Dict[str, Tuple[torch.Tensor, torch.Tensor]]   # name -> (indptr, indices) int32
    edge_bases: Dict[str, int]
    max_degrees: Dict[str, int]
    num_edges: Dict[str, int]
    num_nodes: Dict[str, int]
    feats: torch.Tensor     # (N_total, F) float32
    labels: torch.Tensor    # (papers,) int64

    def offset(self, node_type: str) -> int:
        return _offsets(self.num_nodes)[node_type]

    @property
    def total_nodes(self) -> int:
        return sum(self.num_nodes.values())

    def sampler_args(self) -> dict:
        """The graph and type arguments of ``hetero_multihop_batched`` for
        typed segments seeded at papers."""
        return dict(csrs=self.csrs, etype_names=list(ETYPES), fanouts=FANOUTS,
                    edge_bases=self.edge_bases, max_degrees=self.max_degrees,
                    seed_type="paper", dst_types={n: _types(n)[2] for n in ETYPES},
                    src_types={n: _types(n)[0] for n in ETYPES})


def make_synthetic_mag(seed: int = 1, device=None, *, num_nodes: Dict[str, int] = None,
                       feat_dim: int = FEAT_DIM, classes: int = CLASSES,
                       deg_cap: int = DEG_CAP) -> SyntheticMag:
    """The synthetic ogbn-mag graph of ``part_b``: the papers' in-degrees
    per edge type drawn on the host from ``np.random.default_rng(seed)`` in
    part_b's order and law (for seed 1 the same degrees: 5,066,148 cites,
    6,706,454 writes and 7,141,158 topic edges, 18,913,760 in all);
    sources uniform over the edge type's source type, features standard
    normal and labels uniform, drawn on ``device`` (default: the card) from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    nodes = dict(MAG_NODES if num_nodes is None else num_nodes)
    host = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    total = sum(nodes.values())
    off = _offsets(nodes)
    csrs, maxdeg, nedges, bases = {}, {}, {}, {}
    base = 0
    for name in ETYPES:
        deg = np.zeros(total, np.int64)
        deg[:nodes["paper"]] = np.minimum(
            np.floor(MEAN_DEG[name] / 2.0 * host.random(nodes["paper"]) ** -0.5), deg_cap)
        indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        e = int(indptr[-1])
        src = _types(name)[0]
        lo = off[src]
        indices = torch.randint(lo, lo + nodes[src], (e,), generator=gen, device=dev,
                                dtype=torch.int32)
        csrs[name] = (torch.as_tensor(indptr, device=dev), indices)
        maxdeg[name], nedges[name], bases[name] = int(deg.max()), e, base
        base += e
    feats = torch.randn((total, feat_dim), generator=gen, device=dev)
    labels = torch.randint(0, classes, (nodes["paper"],), generator=gen, device=dev)
    return SyntheticMag(csrs, bases, maxdeg, nedges, nodes, feats, labels)


def level_sizes(batch_size: int = BATCH) -> List[int]:
    """The typed layout's level widths for one step: every target expands
    by all three types (they all end at papers) and only papers are
    targets, so level 1 = B * 21 and level 2 = level 1 + papers of level 1
    (B * 9) * 20: 512 / 10,752 / 102,912 at B = 512."""
    grow = sum(f[0] for f in FANOUTS.values())
    l1 = batch_size * (1 + grow)
    papers = batch_size * (1 + FANOUTS["paper__cites__paper"][0])
    return [batch_size, l1, l1 + papers * sum(f[1] for f in FANOUTS.values())]


def sample_block(graph: SyntheticMag, generator: torch.Generator, reps: int = REPS,
                 batch_size: int = BATCH) -> Tuple[torch.Tensor, HeteroMultihopBatch]:
    """``reps`` steps' paper seeds (uniform) and their typed two-hop sample
    as one batched frontier per hop per edge type (six sampler launches)."""
    dev = graph.feats.device
    seeds = torch.randint(0, graph.num_nodes["paper"], (reps, batch_size),
                          generator=generator, device=dev, dtype=torch.int32)
    return seeds, hetero_multihop_batched(seeds, generator=generator, device=dev,
                                          **graph.sampler_args())


def gather_features(batch: HeteroMultihopBatch, feats: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Input rows of one step, converted to ``dtype`` (one row-gather
    launch); -1 slots give zero rows."""
    return gather_rows(feats, batch.input_nodes, out_dtype=dtype)


def masked_loss(logits, labels, valid):
    """Mean softmax cross-entropy over the valid seeds (float32)."""
    ls = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    return torch.where(valid, ls, 0).sum() / valid.sum().clamp(min=1)


def rgcn_step(model, optimizer, x, batch: HeteroMultihopBatch, labels,
              etype_names=ETYPES) -> torch.Tensor:
    """One step: ``RGCN.batch_call``, masked cross-entropy over the valid
    paper seeds (their labels read at the seeds' ids, papers first), backward,
    optimizer update.  Returns the loss (f32, on the device)."""
    optimizer.zero_grad(set_to_none=True)
    seeds = batch.levels[0]
    logits = model.batch_call(x, batch, list(etype_names))
    loss = masked_loss(logits, labels[seeds.clamp(min=0).long()], seeds >= 0)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_block(model, optimizer, graph: SyntheticMag, generator: torch.Generator,
                reps: int = REPS, batch_size: int = BATCH):
    """One block of ``reps`` R-GCN steps over one batched typed sample.
    Returns the per-step losses and the sampled edges (every hop's and edge
    type's mask summed), as device tensors."""
    _, sample = sample_block(graph, generator, reps, batch_size)
    edges = sum(b.mask.sum() for hop in sample.hops for b in hop.values())
    losses = []
    for i in range(reps):
        step = sample.step(i)
        x = gather_features(step, graph.feats)
        losses.append(rgcn_step(model, optimizer, x, step, graph.labels))
    return losses, edges


# -- the loaders' hetero paths ------------------------------------------------

def mag_stores(graph: SyntheticMag, device=None):
    """The graph as a ``GraphStore`` (COO edges ``(src, rel, dst)`` in
    type-local ids, node types in the store's own lexicographic order) and a
    ``FeatureStore`` with each node type's ``x`` and the papers' ``y``, on
    ``device`` (default: the card).  Returns (feature store, graph store)."""
    from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore

    dev = resolve_device(device)
    gs = GraphStore(device=dev)
    for name in ETYPES:
        src_t, rel, dst_t = _types(name)
        indptr, indices = (t.cpu().numpy() for t in graph.csrs[name])
        dst = np.repeat(np.arange(graph.num_nodes[dst_t], dtype=np.int64),
                        np.diff(indptr[:graph.num_nodes[dst_t] + 1]))
        src = indices.astype(np.int64) - graph.offset(src_t)
        gs.put_edge_index((src, dst), (src_t, rel, dst_t),
                          num_nodes=(graph.num_nodes[src_t], graph.num_nodes[dst_t]))
    fs = FeatureStore(device=dev)
    for nt in ("paper", "author", "field"):
        lo = graph.offset(nt)
        fs[(nt, "x")] = graph.feats[lo:lo + graph.num_nodes[nt]]
    fs[("paper", "y")] = graph.labels
    return fs, gs


def input_features(x_dict, dtype=None):
    """The per-node-type feature dict of a hetero batch (each type's rows at
    its slots, zeros elsewhere) summed into one input, cast to ``dtype``."""
    total = None
    for x in x_dict.values():
        total = x if total is None else total + x
    return total if dtype is None else total.to(dtype)


def loader_step(model, optimizer, batch, etype_names, dtype=torch.bfloat16) -> torch.Tensor:
    """One R-GCN step on a hetero ``NodeBatch``: the summed features in
    ``dtype``, ``RGCN.batch_call``, masked cross-entropy over the valid seeds
    against ``batch.y``, backward, optimizer update."""
    optimizer.zero_grad(set_to_none=True)
    logits = model.batch_call(input_features(batch.x, dtype), batch.sample, list(etype_names))
    loss = masked_loss(logits, batch.y.clamp(min=0), batch.seeds >= 0)
    loss.backward()
    optimizer.step()
    return loss.detach()


class RGCNEncoder(nn.Module):
    """An RGCN as a model of hetero batches (``train_link.link_step``'s
    encoder, ``train_dist.dist_train_step``'s model): ``encoder(x_dict,
    sample)`` runs ``batch_call`` over the summed per-type features (in
    ``dtype``), relations in ``etype_names`` order; its parameters are the
    RGCN's."""

    def __init__(self, model, etype_names, dtype=None):
        super().__init__()
        self.model, self.etype_names, self.dtype = model, list(etype_names), dtype

    def forward(self, x_dict, sample):
        return self.model.batch_call(input_features(x_dict, self.dtype), sample,
                                     self.etype_names)
