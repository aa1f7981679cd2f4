"""Process-group start-up for the port's distributed paths.

Counterpart of ``cugraph_gnn_tpu/utils/distributed.py``, whose ``init``
starts ``jax.distributed``: here ``torch.distributed.init_process_group``,
with rank and world size from the arguments or the launcher's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, as ``torchrun`` sets them) and the
backend from the device (NCCL for the card, gloo for the CPU; see
``parallel/mesh.py``).  ``init_method`` may be ``tcp://host:port`` or a
``file://`` store, which needs no free port; the default ``env://`` reads
``MASTER_ADDR`` and ``MASTER_PORT``.

    mesh = init(init_method="tcp://localhost:29500", rank=0, world_size=1)
    ...
    finalize()

``get_global_mesh`` and ``get_hierarchical_mesh`` are the reference's global
and (local-node, global) communicator pair: the flat mesh, and the (node,
device) mesh with a node for every ``LOCAL_WORLD_SIZE`` ranks (one host).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.parallel.mesh import (
    BACKENDS,
    HierarchicalMesh,
    Mesh,
    create_hierarchical_mesh,
    create_store_mesh,
)


def _int_env(*names) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v is not None:
            return int(v)
    return None


def init(init_method: Optional[str] = None, rank: Optional[int] = None,
         world_size: Optional[int] = None, device=None) -> Mesh:
    """Join the default process group and return its store mesh.

    ``device``: this rank's device (default: the card, ``cuda:LOCAL_RANK``;
    ``"cpu"`` for gloo).  Arguments beat the environment; without either,
    rank 0 of a world of 1."""
    rank = rank if rank is not None else (_int_env("RANK") or 0)
    world_size = world_size or _int_env("WORLD_SIZE") or 1
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", _int_env("LOCAL_RANK") or 0)
        torch.cuda.set_device(dev)
    if dev.type not in BACKENDS:
        raise ValueError(f"no collective backend for device {dev}")
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return create_store_mesh(dev)


def finalize() -> None:
    """Leave the default process group (a no-op when none was joined)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_info():
    """(rank, world_size, local_rank, local_size) of this process."""
    if not dist.is_initialized():
        return 0, 1, 0, 1
    world = dist.get_world_size()
    return (dist.get_rank(), world, _int_env("LOCAL_RANK") or 0,
            _int_env("LOCAL_WORLD_SIZE") or world)


def num_hosts() -> int:
    """The nodes of the default group: its world size over
    ``LOCAL_WORLD_SIZE`` (the ranks of one host, as ``torchrun`` sets it;
    unset: one host)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = _int_env("LOCAL_WORLD_SIZE") or world
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the world of {world}")
    return world // local


def get_global_mesh(device=None) -> Mesh:
    """The flat mesh of every rank (the reference's global communicator)."""
    return create_store_mesh(device)


def get_hierarchical_mesh(device=None) -> HierarchicalMesh:
    """The (node = host, device = local rank) mesh of every rank; every rank
    calls it together."""
    return create_hierarchical_mesh(num_hosts(), device)
