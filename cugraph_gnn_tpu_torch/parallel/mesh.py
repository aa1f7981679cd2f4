"""The mesh of the port: one axis over the ranks of a process group.

Counterpart of ``cugraph_gnn_tpu/parallel/mesh.py``.  The JAX package names
the axis that node rows are sharded over (``STORE_AXIS``) on a
``jax.sharding.Mesh`` and runs its per-shard code under ``shard_map``.  The
port runs one process per device instead, as ``torch.distributed`` does: a
:class:`Mesh` is this process's view of the group (its rank, the world size,
its device) and the collectives take its ``group``.

The backend follows the device and is checked, never chosen behind the
caller's back: NCCL for a CUDA device, gloo for the CPU.  A mesh over a gloo
group refuses a CUDA device and one over an NCCL group the CPU, so that a
run on the card never drops to gloo and a CPU run never moves tensors to a
card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from cugraph_gnn_tpu_torch._device import resolve_device

STORE_AXIS = "store"

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class Mesh:
    """This process's place on a 1-D mesh over a process group.

    group:   the ``torch.distributed`` process group (None: the default one)
    rank:    this process's rank in ``group``
    world:   the number of ranks in ``group``
    device:  where this rank's shards live
    backend: "nccl" (``device`` a card) or "gloo" (``device`` the CPU)
    """

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device
    backend: str
    axis: str = STORE_AXIS

    @property
    def shape(self):
        """{axis: world}, as a ``jax.sharding.Mesh``'s ``shape``."""
        return {self.axis: self.world}

    def global_rank(self, rank: int) -> int:
        """The default group's rank of ``rank`` in this mesh's group (the
        peer argument of point-to-point calls)."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)


def create_store_mesh(device=None, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh of ``group`` (default: the whole default group) with this
    rank's shards on ``device`` (default: the card, ``cuda:<current>``).
    Raises unless ``torch.distributed`` is initialised with the backend that
    ``device`` needs (NCCL for a card, gloo for the CPU)."""
    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "cugraph_gnn_tpu_torch.utils.distributed.init first")
    if dev.type not in BACKENDS:
        raise ValueError(f"no collective backend for device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend(group))
    if backend != BACKENDS[dev.type]:
        raise ValueError(f"a {dev.type} mesh needs the {BACKENDS[dev.type]} backend, "
                         f"the process group has {backend}")
    return Mesh(group=group, rank=dist.get_rank(group), world=dist.get_world_size(group),
                device=dev, backend=backend)
