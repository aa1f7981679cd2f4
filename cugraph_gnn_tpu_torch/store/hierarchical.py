"""Hierarchical (two-level) distributed gather over a (node, device) mesh.

Counterpart of ``cugraph_gnn_tpu/store/hierarchical.py`` (the reference's
MT_HIERARCHY gather: bucket by node, sort-unique, cross-node exchange,
intra-node gather).  Rows are partitioned evenly over the flat rank space of
a ``parallel.mesh.HierarchicalMesh`` (rank = node * d + device).  The ids are
deduplicated before the cross-node hop, so that each remote row crosses
between nodes once for all the ranks of a node that ask for it:

A. local dedup, then an all-to-all inside the node (``device_mesh``) to the
   owner's device column, then a node-level dedup of what arrived;
B. an all-to-all across the nodes (``node_mesh``) to the owner's node, whose
   rank owns every id it receives, and the owner's read (``read``, the
   row-gather kernel for the loaders);
C. the rows back along B, the node dedup expanded, back along A, the local
   dedup expanded.

As every exchange of the port, the all-to-alls move only real ids (their
sizes exchanged first), where JAX fills static buffers with -1.  The
cross-node count (the deduplicated ids a rank sends to other nodes) is
JAX's.
"""

from __future__ import annotations

import torch

from cugraph_gnn_tpu_torch.parallel.mesh import HierarchicalMesh
from cugraph_gnn_tpu_torch.store.dist_array import DistArray, _ragged_a2a, _read_owned, alltoallv
from cugraph_gnn_tpu_torch.store.partition import PartitionBook


def _dedup(ids: torch.Tensor):
    """(the sorted distinct valid ids, each id's position among them or -1
    for an id of -1)."""
    valid = ids >= 0
    uniq, inv = torch.unique(ids[valid], sorted=True, return_inverse=True)
    pos = torch.full_like(ids, -1, dtype=torch.int64)
    pos[valid] = inv
    return uniq, pos


def _bucket_by_key(ids: torch.Tensor, keys: torch.Tensor, nbuckets: int):
    """``ids`` (all valid) stably sorted by ``keys`` in [0, nbuckets):
    (sorted ids, perm, counts per bucket)."""
    perm = torch.argsort(keys, stable=True)
    return ids[perm], perm, torch.bincount(keys, minlength=nbuckets)[:nbuckets]


def _hier_gather_shard(table: torch.Tensor, ids: torch.Tensor, *, book: PartitionBook,
                       mesh: HierarchicalMesh, fill=0, read=None):
    """rows = global_table[ids] for this rank's ``ids`` (B,) and its shard
    ``table``, through phases A-C (module docstring); every rank calls it
    together.  ``read`` and ``fill`` as in ``dist_array._dist_gather_shard``.
    Returns (rows (B, ...) in the order of ``ids``, the cross-node count (1,)
    int64: the deduplicated ids this rank sent to other nodes)."""
    if read is not None and fill != 0:
        raise ValueError("a read function gives zero rows: fill must be 0")
    d, n_nodes = mesh.devices_per_node, mesh.num_nodes
    uniq, inv = _dedup(ids)
    # A: to the owner's device column inside this node, then the node dedup
    a_ids, a_perm, a_counts = _bucket_by_key(uniq, book.owner_of(uniq) % d, d)
    recv_a, a_send, a_recv = _ragged_a2a(a_ids, a_counts, mesh.device_mesh)
    uniq2, inv2 = _dedup(recv_a)
    # B: to the owner's node; the receiver owns every id it gets
    b_ids, b_perm, b_counts = _bucket_by_key(
        uniq2, torch.div(book.owner_of(uniq2), d, rounding_mode="floor"), n_nodes)
    recv_b, b_send, b_recv = _ragged_a2a(b_ids, b_counts, mesh.node_mesh)
    cross = torch.as_tensor([sum(b_send) - b_send[mesh.node]], dtype=torch.int64)
    rows = _read_owned(table, recv_b, book, mesh, fill, read)
    # C: back along B, the node dedup expanded, back along A, the local one
    tail = tuple(table.shape[1:])
    back_b = alltoallv(rows, b_recv, b_send, mesh.node_mesh)
    rows2 = back_b.new_empty((uniq2.shape[0],) + tail)
    rows2[b_perm] = back_b
    back_a = alltoallv(rows2[inv2], a_recv, a_send, mesh.device_mesh)
    rows1 = back_a.new_empty((uniq.shape[0],) + tail)
    rows1[a_perm] = back_a
    out = table.new_full((ids.shape[0],) + tail, fill)
    ok = inv >= 0
    out[ok] = rows1[inv[ok]]
    return out, cross


class HierarchicalDistArray(DistArray):
    """A row-sharded :class:`DistArray` on a (node, device) mesh, gathered
    with the dedup-before-exchange gather; its other methods (constructors,
    scatters, ``to_global``) run over the mesh's flat group."""

    def gather(self, ids, fill=0, read=None) -> torch.Tensor:
        """rows = self[ids] for this rank's ``ids``, -1 giving ``fill``."""
        return self.gather_with_stats(ids, fill=fill, read=read)[0]

    def gather_with_stats(self, ids, fill=0, read=None):
        """(rows, this rank's cross-node id count (1,)): the deduplicated ids
        it shipped to other nodes, the volume the two-phase design keeps
        down."""
        ids = torch.as_tensor(ids, device=self.mesh.device)
        return _hier_gather_shard(self.data, ids, book=self.book, mesh=self.mesh, fill=fill,
                                  read=read)
