"""Sampled GraphSAGE training at ogbn-products scale: data, sampling, the
feature gather and one optimizer step.

The step logic of ``bench.py`` in the JAX package: each block draws REPS
steps' seeds and samples them as one flattened frontier per hop; each step
gathers its input rows (f32 table, bf16 rows, through the row-gather kernel),
runs GraphSAGE forward and backward and applies Adam (lr 1e-3, whose defaults
match ``optax.adam``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import multihop_uniform_batched
from cugraph_gnn_tpu_torch.sampler.output import MultihopBatch

# ogbn-products scale, as bench.py builds it: 2.45M nodes, power-law
# degrees min(floor(25 u^-0.5), 17000) (121,124,824 edges for seed 0, mean
# degree ~49.5), features padded from 100 to 128, 47 classes.
NUM_NODES = 2_449_029
DEG_SCALE = 25.0
DEG_ALPHA = -0.5
DEG_CAP = 17_000
FEAT_DIM = 128
HIDDEN = 256
CLASSES = 47
BATCH = 1024
FANOUTS = (10, 10)
REPS = 10


@dataclass
class SyntheticGraph:
    """CSR graph plus node features and labels, all on one device."""

    indptr: torch.Tensor    # (N+1,) int32
    indices: torch.Tensor   # (E,) int32
    feats: torch.Tensor     # (N, F) float32
    labels: torch.Tensor    # (N,) int64
    max_degree: int

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1


def make_synthetic_products(seed: int = 0, device=None, *,
                            num_nodes: int = NUM_NODES,
                            feat_dim: int = FEAT_DIM,
                            classes: int = CLASSES) -> SyntheticGraph:
    """The synthetic ogbn-products-scale graph of ``bench.py``.

    Degrees are drawn on the host exactly as bench.py draws them (for seed 0
    the same degrees).  Neighbor ids are degree-proportional (a uniform edge
    slot, mapped to the row owning it), features standard normal and labels
    uniform, all drawn on ``device`` (default: the card) from a
    ``torch.Generator`` seeded with ``seed``.
    """
    dev = resolve_device(device)
    host_rng = np.random.default_rng(seed)
    deg = np.minimum(np.floor(DEG_SCALE * host_rng.random(num_nodes) ** DEG_ALPHA),
                     DEG_CAP).astype(np.int64)
    indptr_np = np.concatenate([[0], np.cumsum(deg)])
    if indptr_np[-1] >= 2**31:
        raise ValueError(f"{indptr_np[-1]} edges do not fit int32 edge ids")
    indptr = torch.as_tensor(indptr_np.astype(np.int32), device=dev)
    num_edges = int(indptr_np[-1])
    gen = torch.Generator(device=dev).manual_seed(seed)
    slot = torch.randint(0, num_edges, (num_edges,), generator=gen, device=dev,
                         dtype=torch.int32)
    indices = torch.searchsorted(indptr, slot, right=True, out_int32=True) - 1
    del slot
    feats = torch.randn((num_nodes, feat_dim), generator=gen, device=dev)
    labels = torch.randint(0, classes, (num_nodes,), generator=gen, device=dev)
    return SyntheticGraph(indptr, indices, feats, labels, int(deg.max()))


def sample_block(graph: SyntheticGraph, generator: torch.Generator,
                 reps: int = REPS, batch_size: int = BATCH,
                 fanouts: Sequence[int] = FANOUTS) -> MultihopBatch:
    """``reps`` steps' seeds, uniform over the nodes (``levels[0]``), and
    their two-hop sample as one batched frontier (two sampler launches)."""
    dev = graph.indptr.device
    seeds = torch.randint(0, graph.num_nodes, (reps, batch_size),
                          generator=generator, device=dev, dtype=torch.int32)
    return multihop_uniform_batched(graph.indptr, graph.indices, seeds,
                                    fanouts, generator=generator, device=dev)


def gather_features(batch: MultihopBatch, feats: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Input rows of one step, converted to ``dtype`` in the same pass (one
    row-gather launch).  Padded (-1) slots give zero rows; consumers mask."""
    return gather_rows(feats, batch.input_nodes, out_dtype=dtype)


def train_step(model, optimizer, x, batch: MultihopBatch, labels) -> torch.Tensor:
    """One step: masked mean softmax cross-entropy over the valid seeds of
    ``batch``, backward, optimizer update.  Returns the loss (f32, on the
    device, not synchronised); the parameters' ``.grad`` hold this step's
    gradients afterwards."""
    optimizer.zero_grad(set_to_none=True)
    seeds = batch.levels[0]
    valid = seeds >= 0
    logits = model(x, batch).float()
    y = labels[seeds.clamp(min=0).long()]
    ls = F.cross_entropy(logits, y, reduction="none")
    loss = torch.where(valid, ls, 0).sum() / valid.sum().clamp(min=1)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_block(model, optimizer, graph: SyntheticGraph,
                generator: torch.Generator, reps: int = REPS,
                batch_size: int = BATCH, fanouts: Sequence[int] = FANOUTS
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One block of ``reps`` training steps over one batched sample.
    Returns the per-step losses and the number of sampled edges (the sum of
    every hop's mask), as device tensors."""
    sample = sample_block(graph, generator, reps, batch_size, fanouts)
    edges = sum(hop.mask.sum() for hop in sample.hops)
    losses = []
    for i in range(reps):
        step = sample.step(i)
        x = gather_features(step, graph.feats)
        losses.append(train_step(model, optimizer, x, step, graph.labels))
    return losses, edges
