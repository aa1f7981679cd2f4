"""Sharded checkpoints of ``DistArray`` and ``DistEmbedding`` state with
``torch.distributed.checkpoint`` (DCP).

Counterpart of ``cugraph_gnn_tpu/utils/orbax_ckpt.py``, keeping its path and
names; the files are DCP's, not orbax's.  Every rank writes its own shard
(the rows it holds, padded to the book's ``shard_size``) under a key of its
own, ``data.rank<r>`` (``table.rank<r>``, ``state_<name>.rank<r>``): DCP
writes a plain tensor saved under one key on every rank once, as a
replicated value, so one shared key would keep one rank's rows only.
Beside the DCP files, rank 0 writes ``dist_meta.json``, the JAX package's
sidecar with the same fields and dtype strings (``"bfloat16"`` included),
which holds the partition book.

A restore runs on a mesh of the saved world size and raises ``ValueError``
on another, as the JAX package does: each rank reads back its own shard.
For a world-size change use ``utils/checkpoint.py``'s shard files, which
re-partition on load.  Every rank calls each function together.
"""

from __future__ import annotations

import json
import os

import torch
import torch.distributed.checkpoint as dcp

from cugraph_gnn_tpu_torch.parallel.mesh import STORE_AXIS, create_store_mesh
from cugraph_gnn_tpu_torch.store.dist_array import DistArray
from cugraph_gnn_tpu_torch.store.partition import PartitionBook, RoundRobinBook


def _meta_path(path: str) -> str:
    return os.path.join(path, "dist_meta.json")


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", "int64", ...)."""
    return str(dtype).removeprefix("torch.")


def _book_meta(book) -> dict:
    return {
        "total": int(book.total),
        "world_size": int(book.world_size),
        "counts": [int(c) for c in book.counts],
        "kind": type(book).__name__,
    }


def _book_from_meta(meta: dict):
    if meta["kind"] == "RoundRobinBook":
        return RoundRobinBook(total=meta["total"], world_size=meta["world_size"])
    return PartitionBook.from_counts(meta["counts"])


def _save(path: str, mesh, meta: dict, tensors: dict) -> None:
    """Rank 0 writes the sidecar, then every rank its tensors under
    ``<key>.rank<r>``; DCP's closing collective orders the sidecar before
    any rank returns."""
    if mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        with open(_meta_path(path), "w") as f:
            json.dump(meta, f)
    dcp.save({f"{k}.rank{mesh.rank}": v.contiguous() for k, v in tensors.items()},
             checkpoint_id=path, process_group=mesh.group)


def _open(path: str, mesh, axis: str):
    """(mesh, meta, book) of a checkpoint at ``path`` for ``mesh`` (default:
    the card's), or ValueError when the world sizes differ."""
    mesh = mesh if mesh is not None else create_store_mesh()
    with open(_meta_path(path)) as f:
        meta = json.load(f)
    world = mesh.shape[axis]
    if world != meta["world_size"]:
        raise ValueError(
            f"checkpoint was saved for world_size={meta['world_size']}, restoring onto "
            f"{world} ranks; each rank reads back its own shard, so the world size must "
            "match: use utils.checkpoint.load_shard_files for world-size-elastic reload")
    return mesh, meta, _book_from_meta(meta)


def _load(path: str, mesh, shapes: dict) -> dict:
    """This rank's tensors of ``shapes`` ({key: (shape, dtype name)}),
    read into new tensors on the mesh's device."""
    out = {f"{k}.rank{mesh.rank}": torch.empty(shape, dtype=getattr(torch, dtype),
                                               device=mesh.device)
           for k, (shape, dtype) in shapes.items()}
    dcp.load(out, checkpoint_id=path, process_group=mesh.group)
    return {k: out[f"{k}.rank{mesh.rank}"] for k in shapes}


def save_dist_array(path: str, arr: DistArray) -> None:
    """Checkpoint a ``DistArray`` at ``path`` (a directory): each rank's
    shard through DCP and the sidecar with the partition book."""
    path = os.path.abspath(path)
    meta = _book_meta(arr.book)
    meta["dtype"] = _dtype_name(arr.data.dtype)
    meta["shape_tail"] = list(arr.data.shape[1:])
    _save(path, arr.mesh, meta, {"data": arr.data})


def restore_dist_array(path: str, mesh=None, axis: str = STORE_AXIS) -> DistArray:
    """Restore a ``DistArray`` onto ``mesh`` (default: the card's), whose
    world size must be the saved one."""
    path = os.path.abspath(path)
    mesh, meta, book = _open(path, mesh, axis)
    data = _load(path, mesh, {"data": ((book.shard_size, *meta["shape_tail"]),
                                       meta["dtype"])})["data"]
    return DistArray(data, book, mesh)


def save_embedding(path: str, emb) -> None:
    """Checkpoint a ``DistEmbedding``: the table's shards and every sparse
    optimizer state, with the sidecar naming the optimizer and its states."""
    path = os.path.abspath(path)
    table = emb.table
    meta = _book_meta(table.book)
    meta["dtype"] = _dtype_name(table.data.dtype)
    meta["shape_tail"] = list(table.data.shape[1:])
    meta["optimizer"] = emb.optimizer
    meta["state_keys"] = sorted(emb._state)
    meta["state_dtypes"] = {k: _dtype_name(v.dtype) for k, v in emb._state.items()}
    meta["state_tails"] = {k: list(v.shape[1:]) for k, v in emb._state.items()}
    tensors = {"table": table.data}
    tensors.update({f"state_{k}": emb._state[k] for k in sorted(emb._state)})
    _save(path, table.mesh, meta, tensors)


def restore_embedding(path: str, mesh=None, axis: str = STORE_AXIS, hyper=None):
    """Restore a ``DistEmbedding`` (table and optimizer state) onto ``mesh``
    (default: the card's), whose world size must be the saved one."""
    from cugraph_gnn_tpu_torch.embedding import DistEmbedding

    path = os.path.abspath(path)
    mesh, meta, book = _open(path, mesh, axis)
    rows = book.shard_size
    shapes = {"table": ((rows, *meta["shape_tail"]), meta["dtype"])}
    for k in meta["state_keys"]:
        shapes[f"state_{k}"] = ((rows, *meta["state_tails"][k]), meta["state_dtypes"][k])
    out = _load(path, mesh, shapes)
    emb = DistEmbedding(DistArray(out["table"], book, mesh), optimizer=meta["optimizer"],
                        hyper=hyper or {})
    for k in meta["state_keys"]:
        emb._state[k] = out[f"state_{k}"]
    return emb
