"""The meshes of the port: one axis over the ranks of a process group, or
the hierarchical (node, device) view of it.

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
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from cugraph_gnn_tpu_torch._device import resolve_device

STORE_AXIS = "store"
HIER_AXES = ("node", "device")

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


@dataclass(frozen=True)
class HierarchicalMesh:
    """This process's place on a (node, device) mesh over the default group.

    group / rank / world / device / backend: as :class:`Mesh`'s, of the flat
    group (rank = node * devices_per_node + device)
    num_nodes, devices_per_node: the mesh's shape
    device_mesh: the 1-D mesh of this rank's node (its ``device`` axis)
    node_mesh:   the 1-D mesh of this rank's device column (its ``node`` axis)
    """

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device
    backend: str
    num_nodes: int
    devices_per_node: int
    device_mesh: Mesh
    node_mesh: Mesh
    axis: Tuple[str, str] = HIER_AXES

    @property
    def shape(self):
        return {HIER_AXES[0]: self.num_nodes, HIER_AXES[1]: self.devices_per_node}

    @property
    def node(self) -> int:
        return self.rank // self.devices_per_node


def _checked_device(device, group) -> Tuple[torch.device, str]:
    """(device, backend): ``device`` resolved (the current card by default),
    with the backend of ``group`` that it needs, or raise."""
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
    return dev, backend


def create_store_mesh(device=None, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh of ``group`` (default: the whole default group) with this
    rank's shards on ``device`` (default: the card, ``cuda:<current>``).
    Raises unless ``torch.distributed`` is initialised with the backend that
    ``device`` needs (NCCL for a card, gloo for the CPU)."""
    dev, backend = _checked_device(device, group)
    return Mesh(group=group, rank=dist.get_rank(group), world=dist.get_world_size(group),
                device=dev, backend=backend)


def _subgroup(rank_lists: List[List[int]], backend: str):
    """``dist.new_group`` of every list in order (every rank makes every
    group, as ``torch.distributed`` requires); the group of this rank's."""
    me, mine = dist.get_rank(), None
    for ranks in rank_lists:
        g = dist.new_group(ranks, backend=backend)
        if me in ranks:
            mine = g
    return mine


def create_hierarchical_mesh(num_nodes: int, device=None) -> HierarchicalMesh:
    """The (node, device) mesh of the default group: ``num_nodes`` nodes of
    world / num_nodes ranks each, rank = node * d + device.  Every rank calls
    it together: it makes the node groups' subgroups, then the device
    columns', in that order.  ``device`` and the backend as in
    :func:`create_store_mesh`.  On NCCL one card holds one rank, so a card
    alone makes only the 1 x 1 mesh."""
    dev, backend = _checked_device(device, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_nodes < 1 or world % num_nodes:
        raise ValueError(f"{world} ranks do not split into {num_nodes} nodes")
    d = world // num_nodes
    dev_group = _subgroup([list(range(n * d, (n + 1) * d)) for n in range(num_nodes)],
                          backend)
    node_group = _subgroup([list(range(c, world, d)) for c in range(d)], backend)
    return HierarchicalMesh(
        group=None, rank=rank, world=world, device=dev, backend=backend,
        num_nodes=num_nodes, devices_per_node=d,
        device_mesh=Mesh(dev_group, rank % d, d, dev, backend, HIER_AXES[1]),
        node_mesh=Mesh(node_group, rank // d, num_nodes, dev, backend, HIER_AXES[0]))


def split_mesh(mesh: Mesh, group_size: int) -> List[Optional[Mesh]]:
    """The disjoint sub-meshes of ``group_size`` consecutive ranks of
    ``mesh`` (the reference's communicator split), in rank order; every
    rank of ``mesh`` calls it together.  A process holds only its own
    sub-mesh: the entries of the groups it is not in are None."""
    if group_size < 1 or mesh.world % group_size:
        raise ValueError(f"{mesh.world} ranks do not split into groups of {group_size}")
    ranks = [mesh.global_rank(r) for r in range(mesh.world)]
    out: List[Optional[Mesh]] = []
    for i in range(0, mesh.world, group_size):
        g = dist.new_group(ranks[i:i + group_size], backend=mesh.backend)
        mine = i <= mesh.rank < i + group_size
        out.append(Mesh(g, mesh.rank - i, group_size, mesh.device, mesh.backend, mesh.axis)
                   if mine else None)
    return out


def axis_size(mesh, axis=STORE_AXIS) -> int:
    """The number of ranks along ``axis`` of ``mesh`` (a tuple of axes: their
    product)."""
    shape, out = mesh.shape, 1
    for a in axis if isinstance(axis, (tuple, list)) else (axis,):
        if a not in shape:
            raise ValueError(f"no axis {a!r} on the mesh (its axes: {tuple(shape)})")
        out *= shape[a]
    return out
