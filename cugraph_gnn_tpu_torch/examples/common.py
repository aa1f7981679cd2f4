"""What the example scripts share: the masked cross-entropy, the training and
evaluation steps, the hetero scripts' R-GCN encoder and the distributed
scripts' mesh."""

from __future__ import annotations

import contextlib
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.parallel.mesh import BACKENDS, create_store_mesh
from cugraph_gnn_tpu_torch.sampler.disjoint import DisjointBatch
from cugraph_gnn_tpu_torch.train_hetero import input_features
from cugraph_gnn_tpu_torch.utils import distributed as D


def masked_ce(logits, batch, mask=None) -> torch.Tensor:
    """The mean softmax cross-entropy (f32) of the batch's valid (non -1)
    seeds against its labels; with ``mask`` (a bool tensor over the nodes)
    only of the seeds that it holds."""
    valid = batch.seeds >= 0
    if mask is not None:
        valid = valid & mask[batch.seeds.clamp(min=0).long()]
    ls = F.cross_entropy(logits.float(), torch.where(valid, batch.y, 0).long(),
                         reduction="none")
    return torch.where(valid, ls, 0).sum() / valid.sum().clamp(min=1)


def loader_step(model, optimizer, batch, mask=None) -> torch.Tensor:
    """One optimizer step on a loader batch: ``masked_ce`` of the model's
    logits.  Returns the loss (f32, on the device, not synchronised)."""
    optimizer.zero_grad(set_to_none=True)
    loss = masked_ce(model(batch.x, batch.sample), batch, mask)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def accuracy(model, loader) -> float:
    """The share of the loader's valid seeds whose argmax logit is their
    label (one host read at the end)."""
    hits = total = 0
    for b in loader:
        valid = b.seeds >= 0
        hits = hits + ((model(b.x, b.sample).argmax(-1) == b.y) & valid).sum()
        total = total + valid.sum()
    return float(hits) / max(int(total), 1)


def to_rel_batches(sample, etype_names):
    """A hetero sample as ``RGCN.forward`` reads it: per layer (input side
    first), per relation in ``etype_names`` order, the hop's (neigh_local,
    mask), or None where the hop has no block of that relation."""
    return [[(hop[en].neigh_local, hop[en].mask) if en in hop else None
             for en in etype_names]
            for hop in reversed(sample.hops)]


class RelEncoder(nn.Module):
    """The hetero examples' encoder: an ``RGCN`` over the summed per-type
    features of a hetero batch, relations in ``etype_names`` order.  A
    disjoint batch runs flattened (``DisjointBatch.flat``, one block a seed),
    so that row s of the output is seed s's, as JAX's ``vmap`` over the
    seeds gives it."""

    def __init__(self, rgcn, etype_names):
        super().__init__()
        self.rgcn, self.etype_names = rgcn, list(etype_names)

    def forward(self, x_dict, sample):
        x = input_features(x_dict)
        if isinstance(sample, DisjointBatch):
            flat = sample.flat()
            return self.rgcn(x.reshape(-1, x.shape[-1]), to_rel_batches(flat, self.etype_names),
                             num_shards=flat.num_shards)
        return self.rgcn(x, to_rel_batches(sample, self.etype_names))


@contextlib.contextmanager
def example_mesh(devices: Optional[int] = None, device=None):
    """The store mesh of the distributed examples: the first ``min(devices,
    world size)`` ranks of the current process group (every rank with
    ``devices`` None), one process a device (None on the ranks left out).
    With no group, a world of one is started for the duration (NCCL on the
    card, gloo with ``device="cpu"``) over a ``file://`` store in a
    temporary directory."""
    dev = resolve_device(device)
    root = None
    if not dist.is_initialized():
        root = tempfile.mkdtemp(prefix="example_mesh_")
        D.init(init_method=f"file://{root}/store", rank=0, world_size=1, device=dev)
    try:
        size = dist.get_world_size()
        world = size if devices is None else min(devices, size)
        group = None
        if world < size:
            group = dist.new_group(list(range(world)), backend=BACKENDS[dev.type])
        yield create_store_mesh(dev, group) if dist.get_rank() < world else None
    finally:
        if root is not None:
            D.finalize()
            shutil.rmtree(root, ignore_errors=True)
