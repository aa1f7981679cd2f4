"""Checkpoint and resume of row stores: per-rank binary shard files.

Counterpart of ``cugraph_gnn_tpu/utils/checkpoint.py`` (the reference's file
format): a shard file is the raw little-endian rows of one rank of a
logically concatenated row-major matrix, ``{prefix}_part_{r}_of_{w}``, with
``{prefix}_meta.json`` beside them.  For the same array and partition book
the files are byte for byte those of the JAX package, so each package loads
the other's.  Loading re-partitions the rows to the reader's book, so the
world size may change between save and load.

A rank-local load takes a contiguous book (``store.partition.PartitionBook``:
one range of rows) or any other, such as a ``RoundRobinBook``, whose rows it
picks one by one.  ``utils/orbax_ckpt.py`` is the other checkpoint of
``DistArray`` and ``DistEmbedding`` state: sharded ``torch.distributed.checkpoint``
files, restored at the saved world size only.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cugraph_gnn_tpu_torch.store.dist_array import DistArray
from cugraph_gnn_tpu_torch.store.partition import PartitionBook


def _numpy(array) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def store_shard_files(prefix: str, array, book: PartitionBook) -> None:
    """Write ``array`` (numpy or torch, rows in global order) as one file
    per rank of ``book``, and the meta file."""
    arr = _numpy(array)
    w = book.world_size
    meta = {
        "total": book.total,
        "world_size": w,
        "counts": [int(c) for c in book.counts],
        "dtype": str(arr.dtype),
        "shape_tail": list(arr.shape[1:]),
    }
    with open(f"{prefix}_meta.json", "w") as f:
        json.dump(meta, f)
    for r in range(w):
        lo, hi = int(book.offsets[r]), int(book.offsets[r + 1])
        arr[lo:hi].tofile(f"{prefix}_part_{r}_of_{w}")


def load_shard_files(prefix: str) -> np.ndarray:
    """The whole array of a shard-file prefix, written at any world size."""
    with open(f"{prefix}_meta.json") as f:
        meta = json.load(f)
    w = meta["world_size"]
    tail = tuple(meta["shape_tail"])
    dtype = np.dtype(meta["dtype"])
    parts = []
    for r in range(w):
        buf = np.fromfile(f"{prefix}_part_{r}_of_{w}", dtype=dtype)
        parts.append(buf.reshape((-1, *tail)) if tail else buf)
    out = np.concatenate(parts)
    if out.shape[0] != meta["total"]:
        raise ValueError(f"{prefix}: {out.shape[0]} rows in the files, {meta['total']} "
                         f"in the meta file")
    return out


def load_filelist(filelist: Sequence[str], dtype, row_size: int,
                  book: Optional[PartitionBook] = None, rank: Optional[int] = None,
                  entry_stride: Optional[int] = None) -> np.ndarray:
    """Rows of a logically concatenated list of binary files (memory-mapped):
    all of them, or with ``book`` and ``rank`` only that rank's.
    ``entry_stride``: the width of the rows returned, when wider than
    ``row_size`` (zeros after the row).  A book whose rows are not one
    range (a ``RoundRobinBook``) gives the rank's rows in local order."""
    dtype = np.dtype(dtype)
    sizes = [os.path.getsize(f) // (dtype.itemsize * row_size) for f in filelist]
    total = sum(sizes)
    out_w = entry_stride or row_size
    if book is not None and rank is not None and not isinstance(book, PartitionBook):
        gids = np.flatnonzero(book.owner_of_np(np.arange(total, dtype=np.int64)) == rank)
        loc = book.local_offset_np(gids)
        out = np.zeros((len(gids), out_w), dtype)
        row0 = 0
        for f, n in zip(filelist, sizes):
            sel = (gids >= row0) & (gids < row0 + n)
            if sel.any():
                mm = np.memmap(f, dtype=dtype, mode="r", shape=(n, row_size))
                out[loc[sel], :row_size] = mm[gids[sel] - row0]
            row0 += n
        return out
    if book is None or rank is None:
        lo, hi = 0, total
    else:
        lo, hi = int(book.offsets[rank]), int(book.offsets[rank + 1])
    out = np.zeros((hi - lo, out_w), dtype)
    row0 = 0
    for f, n in zip(filelist, sizes):
        a, b = max(lo, row0), min(hi, row0 + n)
        if a < b:
            mm = np.memmap(f, dtype=dtype, mode="r", shape=(n, row_size))
            out[a - lo:b - lo, :row_size] = mm[a - row0:b - row0]
        row0 += n
    return out


def save_embedding(prefix: str, embedding) -> None:
    """Save a ``DistEmbedding``'s table and each optimizer state
    (``{prefix}.{optimizer}.{name}``).  Every rank calls it together; rank
    0 writes."""
    table = embedding.table
    book, mesh = table.book, table.mesh
    arrays = {prefix: table.to_global()}
    for k in sorted(embedding._state):
        arrays[f"{prefix}.{embedding.optimizer}.{k}"] = DistArray(
            embedding._state[k], book, mesh).to_global()
    if mesh.rank == 0:
        for p, a in arrays.items():
            store_shard_files(p, a, book)
    if mesh.world > 1:
        dist.barrier(group=mesh.group)


def load_embedding(prefix: str, embedding) -> None:
    """Load the table and optimizer states that :func:`save_embedding` (or
    the JAX package's) wrote, re-partitioned to the embedding's book."""
    table = embedding.table
    table.data = DistArray.from_array(load_shard_files(prefix), table.mesh, book=table.book,
                                      dtype=table.data.dtype).data
    for k in sorted(embedding._state):
        st = load_shard_files(f"{prefix}.{embedding.optimizer}.{k}")
        embedding._state[k] = DistArray.from_array(st, table.mesh, book=table.book,
                                                   dtype=torch.float32).data
