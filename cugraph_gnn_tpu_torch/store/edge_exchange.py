"""Construction-time edge routing: rank-local COO edges to their owners.

Counterpart of ``cugraph_gnn_tpu/store/edge_exchange.py``.  Every rank holds
its own slice of a graph's edges (``GraphStore.put_local_edge_index``) and
the row-sharded ``sampler.dist_sampler.DistGraph`` needs each destination
row's edges on the rank that owns the row.  The shuffle is a collective:
chunks of packed ``[src, dst, attributes...]`` rows go to the owner of their
``dst`` by ``store/dist_array.py``'s ragged all-to-all (on the mesh's device:
the card over NCCL, the CPU over gloo), and each rank keeps what it receives
on the host.  No rank ever holds the whole COO: memory is O(local edges +
chunk * world) a rank.

Determinism: the logical global COO is the concatenation of the ranks'
local edge lists in rank order.  Chunks split each sender's list in order
and the per-chunk bucketing by owner is a stable sort, so reassembling the
received segments sender-major, then round-major, then within-segment gives
each owner its edges in global COO order: per-shard CSRs built from them
equal ``DistGraph.from_global_csr`` of that COO's CSR bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch.parallel.mesh import Mesh
from cugraph_gnn_tpu_torch.store.dist_array import _bucket_by_owner, _ragged_a2a, all_reduce_np
from cugraph_gnn_tpu_torch.store.partition import PartitionBook


def _pack(src, dst, vals):
    """(E, width) int32 wire rows [src, dst, attribute lanes...] and each
    attribute's (dtype, wire dtype, lanes, first column).  Attributes ride as
    raw bits: a 4-byte dtype takes one lane, an 8-byte dtype two, and a
    narrower one is widened losslessly to a 4-byte type first."""
    cols = [src.astype(np.int32), dst.astype(np.int32)]
    meta = {}
    for name, v in (vals or {}).items():
        v = np.ascontiguousarray(np.asarray(v))
        orig = v.dtype
        if v.dtype.itemsize < 4:
            if v.dtype.kind == "f" or v.dtype.name == "bfloat16":
                v = v.astype(np.float32)
            elif v.dtype.kind == "u":
                v = v.astype(np.uint32)
            elif v.dtype.kind in "ib":
                v = v.astype(np.int32)
        if v.dtype.itemsize % 4 or v.dtype.kind not in "ifub":
            raise ValueError(f"unsupported edge-attribute dtype {orig} for {name!r}")
        lanes = v.dtype.itemsize // 4
        meta[name] = (orig, v.dtype, lanes, len(cols))
        view = v.view(np.int32).reshape(len(v), lanes)
        cols.extend(view[:, j] for j in range(lanes))
    return np.stack(cols, axis=1) if len(src) else np.zeros((0, len(cols)), np.int32), meta


def _unpack(rows: np.ndarray, meta) -> dict:
    out = {"src": rows[:, 0].astype(np.int64), "dst": rows[:, 1].astype(np.int64)}
    for name, (orig, wire, lanes, off) in meta.items():
        col = np.ascontiguousarray(rows[:, off:off + lanes]).view(wire).reshape(-1)
        out[name] = col if wire == orig else col.astype(orig)
    return out


def route_local_edges(src, dst, num_nodes: int, mesh: Mesh, vals: Optional[dict] = None,
                      book: Optional[PartitionBook] = None, chunk: int = 1 << 18):
    """Route this rank's COO edges to the owners of their destinations.

    src, dst: (E_local,) host arrays, this rank's slice of the edges (every
    rank passes its own).  vals: optional {name: (E_local,) array} of edge
    attributes that travel with the edges.  book: the row partition; by
    default the edge-balanced book of the global in-degree histogram (one
    all-reduce, sum).  chunk: edges a rank sends per round; the number of
    rounds is agreed by an all-reduce (max).  Every rank calls it together.

    Returns (book, shard): ``shard`` holds this rank's rows' edges in global
    COO order: "src", "dst" (int64, global ids) and each attribute in its own
    dtype.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape:
        raise ValueError(f"src {src.shape} and dst {dst.shape} differ")
    if src.max(initial=0) >= 2**31 or num_nodes >= 2**31:
        raise ValueError("node ids must fit int32")
    world = mesh.world
    if book is None:
        hist = np.bincount(dst.astype(np.int64), minlength=num_nodes)[:num_nodes]
        hist = all_reduce_np(hist, mesh, "sum")
        book = PartitionBook.edge_balanced(np.concatenate([[0], np.cumsum(hist)]), world)
    packed, meta = _pack(src, dst, vals)
    e_local = len(src)
    rounds = max(int(all_reduce_np([-(-e_local // chunk)], mesh, "max")[0]), 1)
    segments = [[] for _ in range(world)]      # segments[sender]: this rank's rows
    for rnd in range(rounds):
        rows = torch.as_tensor(packed[rnd * chunk:(rnd + 1) * chunk], device=mesh.device)
        _, perm, counts = _bucket_by_owner(rows[:, 1], book)
        recv, _, recv_sizes = _ragged_a2a(rows[perm], counts, mesh)
        recv = recv.cpu().numpy()
        bounds = np.concatenate([[0], np.cumsum(recv_sizes)])
        for sender in range(world):
            if recv_sizes[sender]:
                segments[sender].append(recv[bounds[sender]:bounds[sender + 1]])
    parts = [seg for sender in segments for seg in sender]
    mine = np.concatenate(parts) if parts else np.zeros((0, packed.shape[1]), np.int32)
    return book, _unpack(mine, meta)
