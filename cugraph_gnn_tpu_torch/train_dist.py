"""Distributed sampled training: the loop of ``examples/multichip_training.py``.

Every rank iterates a ``loader.DistNeighborLoader`` together, runs the model
(GraphSAGE in the example) on its own batch and takes an Adam step.  The
loss is JAX's global masked mean over the sharded batch: each rank's share
is its masked sum of cross-entropies over the global count of valid seeds
(one all-reduce, sum), and the gradients are summed over the ranks (one
all-reduce each, sum) before ``step()``.  So every rank applies the same
update, as long as its parameters start equal: build the model after the
same ``torch.manual_seed`` on every rank, or convert the same flax tree
(``models/convert.py``).

    mesh = utils.distributed.init(...)
    loader = DistNeighborLoader((fs, gs), [10, 10], mesh, batch_size=1024, shuffle=True)
    torch.manual_seed(0)
    model = GraphSAGE(128, 256, 47, device=mesh.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for batch in loader:
        loss = dist_train_step(model, opt, batch, mesh)
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.nn import functional as F

from cugraph_gnn_tpu_torch.parallel.mesh import Mesh
from cugraph_gnn_tpu_torch.store.dist_array import _count


def all_reduce_gradients(model: torch.nn.Module, mesh: Mesh) -> None:
    """Sum every parameter's gradient over the mesh's ranks, in place."""
    for p in model.parameters():
        if p.grad is not None:
            dist.all_reduce(p.grad, group=mesh.group)
            _count(collectives=1)


def dist_loss(logits: torch.Tensor, batch, mesh: Mesh) -> torch.Tensor:
    """This rank's share of the global masked mean cross-entropy: the sum
    over its valid seeds (seeds >= 0; labels of pads clipped to 0, as in
    JAX) over the valid seeds of every rank."""
    valid = batch.seeds >= 0
    count = valid.sum()
    dist.all_reduce(count, group=mesh.group)
    _count(collectives=1)
    ls = F.cross_entropy(logits.float(), batch.y.long().clamp(min=0), reduction="none")
    return torch.where(valid, ls, 0).sum() / count.clamp(min=1)


def dist_train_step(model: torch.nn.Module, optimizer, batch, mesh: Mesh) -> torch.Tensor:
    """One step on this rank's ``NodeBatch``, every rank together: the
    global loss (summed over the ranks; on the device, not synchronised) is
    returned.  The parameters' ``.grad`` hold the summed gradients."""
    optimizer.zero_grad(set_to_none=True)
    loss = dist_loss(model(batch.x, batch.sample), batch, mesh)
    loss.backward()
    all_reduce_gradients(model, mesh)
    optimizer.step()
    total = loss.detach().clone()
    dist.all_reduce(total, group=mesh.group)
    _count(collectives=1)
    return total
