"""Distributed gather and scatter of row-sharded arrays over a process group.

Counterpart of ``cugraph_gnn_tpu/store/dist_array.py:61-301``: the per-shard
exchange routines of the reference's hot path (bucket the ids by owner, send
them to their owners, gather locally, send the rows back, restore the order).
Each function runs on every rank of ``mesh`` with this rank's tensors, as the
JAX bodies run under ``shard_map``; every rank must call it, in the same
order.

The exchange is ``torch.distributed.all_to_all_single`` with split sizes
known on the host: the send sizes are counted on this rank and the receive
sizes come from a one-element-per-peer exchange first, so each call reads
two small tensors back to the host.  Only the actual rows cross (the TPU's
ragged all-to-all semantics; the JAX package's CPU path pads every peer's
slot to the whole batch).  Ids of -1 are not sent: their rows are ``fill``
(gather) or dropped (scatter).  :class:`DistArray` holds one row-sharded
array and runs these routines on it.  ``recv_cap`` bounds the gather's
request buffer by a multi-round exchange (:func:`dist_gather_recv_cap`
picks it: none up to world 8, as the JAX package does where its exchanges
are actual-size).  ``EXCHANGES`` counts the collectives and host reads that
these routines make.  A book may also be a ``RoundRobinBook``, whose padded
layout puts id at ``owner * shard_size + local``; ``DistArray.from_file``
reads only this rank's rows of a ``.npy`` or ``.pt`` file.

Sums of rows keyed by ids (the scatter's "add", and the sharded SpMM's and
attention's fallback edges in ``ops/dist_full_batch.py``) take a fixed
order: :func:`segment_plan` sorts the ids once (stably) into a row pointer,
and :func:`segment_add` sums each id's rows in that order with the CSR SpMM
kernel in accumulate mode (``ops/kernels/spmm_kernel.py``; its plain version
on the CPU).  ``index_add_`` on a card adds with atomics, whose order, and
so whose rounding, changes from run to run.  Where the ids of a scatter-add
are fixed, :func:`scatter_add_plan` does its id exchange and sort once, and
:func:`_dist_scatter_add` then moves and sums only the values; likewise
:func:`gather_plan` exchanges a fixed gather's ids once, and
:func:`_dist_gather_planned` then moves only the rows, reading nothing back
to the host.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import PaddedCSR, csr_spmm
from cugraph_gnn_tpu_torch.parallel.mesh import Mesh, axis_size
from cugraph_gnn_tpu_torch.store.partition import PartitionBook, RoundRobinBook


# collectives issued and host reads made by this module's exchanges (read
# and reset by callers that report them)
EXCHANGES = {"collectives": 0, "host_reads": 0}


def _count(collectives: int = 0, host_reads: int = 0) -> None:
    EXCHANGES["collectives"] += collectives
    EXCHANGES["host_reads"] += host_reads


def mesh_axis_size(mesh, axis=None) -> int:
    """The number of ranks along ``axis`` of ``mesh`` (default: all of them);
    a tuple of axes, such as the hierarchical mesh's ("node", "device"),
    gives the product of their sizes."""
    return mesh.world if axis is None else axis_size(mesh, axis)


def all_reduce_np(values, mesh: Mesh, op: str = "sum") -> np.ndarray:
    """Elementwise ``op`` ("sum" or "max") of an int64 host array over the
    mesh's ranks, back on the host (one collective, one host read); every
    rank calls it together."""
    t = torch.as_tensor(np.asarray(values, dtype=np.int64), device=mesh.device).clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=mesh.group)
    _count(collectives=1, host_reads=1)
    return t.cpu().numpy()


def put_global(host_array, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a host array row-sharded evenly over ``mesh``
    (its length a multiple of the world size), on the mesh's device."""
    host = torch.as_tensor(np.asarray(host_array))
    per = host.shape[0] // mesh.world
    if per * mesh.world != host.shape[0]:
        raise ValueError(f"{host.shape[0]} rows do not split evenly over "
                         f"{mesh.world} ranks")
    return host[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)


def segment_plan(ids: torch.Tensor, num_rows: int, weights=None) -> PaddedCSR:
    """The fixed order in which :func:`segment_add` sums values keyed by
    ``ids`` (E,): slot e of row r names value row ``cols[e]``, the slots of
    each row in the order of ``ids`` (a stable sort); ids outside [0,
    num_rows) are dropped.  ``weights`` (E,) float32, in the order of
    ``ids``, scale the values.  Built once where the ids are fixed."""
    ids = ids.long()
    key = torch.where((ids >= 0) & (ids < num_rows), ids, num_rows)
    order = torch.argsort(key, stable=True)
    key = key[order]
    rowptr = torch.searchsorted(key, torch.arange(num_rows + 1, device=ids.device))
    rows = torch.where(key < num_rows, key, -1).to(torch.int32)
    w = None if weights is None else weights[order].float().contiguous()
    return PaddedCSR(order.to(torch.int32), rows, -(-order.numel() // 128), int(num_rows),
                     rowptr, w)


def segment_add(out: torch.Tensor, plan: PaddedCSR, values: torch.Tensor) -> torch.Tensor:
    """out[r] += the sum, in ``plan``'s order, of its slots' (weighted)
    value rows, in place; ``out`` (num_rows, ...) contiguous and ``values``
    (E, ...) with the same trailing shape, float32 or bfloat16, summed in
    float32 and rounded once per row.  Returns ``out``."""
    flat = out.view(out.shape[0], -1)
    csr_spmm(plan, values.reshape(values.shape[0], flat.shape[1]).contiguous(), out=flat)
    return out


def _bucket_by_owner(ids: torch.Tensor, book: PartitionBook):
    """Sort query ids by owner rank; -1 ids go last and are not counted.
    Returns (sorted_ids, perm, counts): counts[r] ids for rank r lead
    ``sorted_ids`` in rank order."""
    world = book.world_size
    valid = ids >= 0
    owner = book.owner_of(ids.clamp(min=0)).clamp(0, world - 1)
    owner = torch.where(valid, owner, world)
    perm = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=world + 1)[:world]
    return ids[perm], perm, counts


def alltoallv(data: torch.Tensor, send_sizes: Sequence[int], recv_sizes: Sequence[int],
              mesh: Mesh) -> torch.Tensor:
    """Variable-size exchange: ``data`` holds send_sizes[r] rows for each
    rank r in rank order; returns the recv_sizes[r] rows from each rank r,
    in rank order."""
    out = data.new_empty((int(sum(recv_sizes)),) + tuple(data.shape[1:]))
    dist.all_to_all_single(out, data.contiguous(), list(recv_sizes), list(send_sizes),
                           group=mesh.group)
    _count(collectives=1)
    return out


def _ragged_a2a(data: torch.Tensor, counts: torch.Tensor, mesh: Mesh):
    """alltoallv of the leading counts[r] rows of ``data`` for each rank r,
    with the receive sizes (the peers' counts for this rank, one element
    from each) exchanged first and read to the host together with the send
    sizes.  Returns (received rows, send_sizes, recv_sizes)."""
    send_sizes, recv_sizes = _exchange_sizes(counts, mesh)
    out = alltoallv(data[:sum(send_sizes)], send_sizes, recv_sizes, mesh)
    return out, send_sizes, recv_sizes


def _exchange_sizes(counts: torch.Tensor, mesh: Mesh):
    """(this rank's counts for each peer, each peer's count for this rank),
    both as host lists: one one-element-per-peer exchange, one host read."""
    counts = counts.to(device=mesh.device, dtype=torch.int64)
    recv = torch.empty_like(counts)
    dist.all_to_all_single(recv, counts, group=mesh.group)
    _count(collectives=1, host_reads=1)
    send_sizes, recv_sizes = torch.stack([counts, recv]).tolist()
    return send_sizes, recv_sizes


def _owned_local(req_ids: torch.Tensor, book: PartitionBook, mesh: Mesh):
    """(is-mine mask, local offset) of requested global ids."""
    safe = req_ids.clamp(min=0)
    local = book.local_offset(safe)
    ok = ((req_ids >= 0) & (book.owner_of(safe) == mesh.rank)
          & (local < int(book.counts[mesh.rank])))
    return ok, local


def _read_owned(table: torch.Tensor, req: torch.Tensor, book: PartitionBook, mesh: Mesh,
                fill, read):
    """The rows of this rank's shard at requested global ids ``req``: ``fill``
    where this rank holds no such row; through ``read`` where given."""
    ok, local = _owned_local(req, book, mesh)
    if read is not None:
        return read(table, torch.where(ok, local, -1))
    rows = table[torch.where(ok, local, 0)]
    keep = ok.view((-1,) + (1,) * (table.dim() - 1))
    return torch.where(keep, rows, torch.as_tensor(fill, dtype=rows.dtype, device=rows.device))


def _dist_gather_shard(table: torch.Tensor, ids: torch.Tensor, *, book: PartitionBook,
                       mesh: Mesh, fill=0, read=None,
                       recv_cap: Optional[int] = None) -> torch.Tensor:
    """rows = global_table[ids], each rank with its own ``ids`` (B,) and its
    shard ``table`` (shard_size, ...).  Ids of -1, and ids that no rank
    holds, give ``fill`` rows.  Returns (B, ...) in the order of ``ids``.

    ``read(table, local)``, where given, reads the requested rows of the
    shard (``local``: offsets, -1 where this rank holds no row, which must
    give a zero row) in place of indexing: the loaders and the embedding
    lookup pass ``ops/kernels/gather_kernel.py::read_rows``, the row-gather
    kernel for float tables.  It needs ``fill`` 0.

    ``recv_cap``: None receives every peer's requests in one exchange (at
    most world * B ids); an int bounds each round's requests at an owner to
    it, over as many rounds as the largest queue needs
    (:func:`_dist_gather_shard_bounded`).  Both give the same rows."""
    if read is not None and fill != 0:
        raise ValueError("a read function gives zero rows: fill must be 0")
    if recv_cap is not None:
        return _dist_gather_shard_bounded(table, ids, book=book, mesh=mesh, fill=fill,
                                          read=read, recv_cap=recv_cap)
    sorted_ids, perm, counts = _bucket_by_owner(ids, book)
    req, send_sizes, recv_sizes = _ragged_a2a(sorted_ids, counts, mesh)
    n_send = sum(send_sizes)
    rows = _read_owned(table, req, book, mesh, fill, read)
    back = alltoallv(rows, recv_sizes, send_sizes, mesh)
    out = table.new_full((ids.shape[0],) + tuple(table.shape[1:]), fill)
    out[perm[:n_send]] = back
    return out


def dist_gather_recv_cap(batch: int, world: int, policy="auto") -> Optional[int]:
    """The receive capacity of the distributed gather: ``"flat"`` None (one
    exchange), an int taken as it is, ``"auto"`` None up to world 8 and
    beyond it max(2 * batch, 8 * world) rounded up to a multiple of the
    world (each sender's quota a round at least 8 ids).  The JAX package's
    ragged (TPU) branch: the port's exchanges are actual-size, so the one
    exchange moves only the requested ids at any world size; its dense CPU
    branch bounds from world 4, which the port never needs."""
    if policy == "flat":
        return None
    if isinstance(policy, int) and not isinstance(policy, bool):
        return policy
    if policy != "auto":
        raise ValueError(f"recv_cap policy must be 'auto', 'flat' or an int, got {policy!r}")
    if world <= 8:
        return None
    cap = max(2 * batch, 8 * world)
    return -(-cap // world) * world


def _dist_gather_shard_bounded(table: torch.Tensor, ids: torch.Tensor, *,
                               book: PartitionBook, mesh: Mesh, fill, read,
                               recv_cap: int) -> torch.Tensor:
    """:func:`_dist_gather_shard` in rounds: each round every rank sends at
    most ``quota = recv_cap // world`` of its queued ids to each owner, so
    no rank receives more than ``recv_cap`` ids a round.  The queues' sizes
    are exchanged once, so each round's send and receive sizes are known on
    the host; the number of rounds is agreed by one all-reduce (max), so
    every rank makes the same collective calls."""
    world = book.world_size
    quota = max(int(recv_cap) // world, 1)
    sorted_ids, perm, counts = _bucket_by_owner(ids, book)
    send_total, recv_total = _exchange_sizes(counts, mesh)
    starts = np.concatenate([[0], np.cumsum(send_total)[:-1]]).astype(np.int64)
    rounds = int(all_reduce_np([-(-max(send_total, default=0) // quota)], mesh, "max")[0])
    out = table.new_full((ids.shape[0],) + tuple(table.shape[1:]), fill)
    for r in range(rounds):
        send = [int(min(max(c - r * quota, 0), quota)) for c in send_total]
        recv = [int(min(max(c - r * quota, 0), quota)) for c in recv_total]
        pos = torch.as_tensor(np.concatenate(
            [np.arange(s + r * quota, s + r * quota + n) for s, n in zip(starts, send)]
            + [np.zeros(0, np.int64)]), device=ids.device)
        req = alltoallv(sorted_ids[pos], send, recv, mesh)
        rows = _read_owned(table, req, book, mesh, fill, read)
        out[perm[pos]] = alltoallv(rows, recv, send, mesh)
    return out


class GatherPlan(NamedTuple):
    """A gather of fixed global ids: the local rows this rank sends to each
    peer, peer by peer, and the sizes of the one exchange."""

    send_rows: torch.Tensor       # local offsets, the peers' requests in rank order
    send_sizes: List[int]
    recv_sizes: List[int]         # the ids' count at each owner


def gather_plan(ids: torch.Tensor, *, book: PartitionBook, mesh: Mesh) -> GatherPlan:
    """The plan of :func:`_dist_gather_planned` for this rank's ``ids``
    (global, valid, grouped by owner in rank order, as a sorted array is):
    the ids go to their owners once, here; every rank calls it together."""
    owner = book.owner_of(ids)
    if ids.numel() and bool((owner[1:] < owner[:-1]).any()):
        raise ValueError("gather_plan needs ids grouped by owner in rank order")
    counts = torch.bincount(owner, minlength=book.world_size)[:book.world_size]
    req, my_sizes, peer_sizes = _ragged_a2a(ids, counts, mesh)
    ok, local = _owned_local(req, book, mesh)
    if not bool(ok.all()):
        raise ValueError("gather_plan: an id is outside its owner's rows")
    return GatherPlan(local, peer_sizes, my_sizes)


def _dist_gather_planned(table: torch.Tensor, plan: GatherPlan, *, mesh: Mesh) -> torch.Tensor:
    """rows = global_table[ids] for the ids of ``plan``, in their order, each
    rank with its shard ``table``: one exchange of rows; every rank calls it
    together."""
    return alltoallv(table[plan.send_rows], plan.send_sizes, plan.recv_sizes, mesh)


class ScatterAddPlan(NamedTuple):
    """A scatter-add of values keyed by fixed ids into ``rows``-row shards:
    the values' sending order and sizes, and the order of the sums of what
    this rank receives."""

    perm: torch.Tensor            # the values sent, in rank order
    send_sizes: List[int]
    recv_sizes: List[int]
    sums: PaddedCSR               # received slot -> local row


def _route(ids: torch.Tensor, rows: int, book: PartitionBook, mesh: Mesh):
    """Where a scatter of this rank's ``ids`` into shards of ``rows`` rows
    sends its values: (the values' sending order, send sizes, receive
    sizes, each received value's local row, ``rows`` where dropped)."""
    sorted_ids, perm, counts = _bucket_by_owner(ids, book)
    req_ids, send_sizes, recv_sizes = _ragged_a2a(sorted_ids, counts, mesh)
    ok, local = _owned_local(req_ids, book, mesh)
    return perm[:sum(send_sizes)], send_sizes, recv_sizes, torch.where(ok, local, rows)


def scatter_add_plan(ids: torch.Tensor, rows: int, *, book: PartitionBook,
                     mesh: Mesh) -> ScatterAddPlan:
    """The plan of :func:`_dist_scatter_add` for this rank's ``ids`` (-1
    dropped) into shards of ``rows`` rows; every rank calls it together."""
    perm, send_sizes, recv_sizes, local = _route(ids, rows, book, mesh)
    return ScatterAddPlan(perm, send_sizes, recv_sizes, segment_plan(local, rows))


def _dist_scatter_add(table: torch.Tensor, values: torch.Tensor, plan: ScatterAddPlan, *,
                      mesh: Mesh) -> torch.Tensor:
    """global_table[ids] += values along ``plan`` (the ids' plan), in place
    in this rank's contiguous shard ``table`` (float32 or bfloat16), summed
    in the plan's fixed order; every rank calls it together.  Returns
    ``table``."""
    vals = alltoallv(values[plan.perm], plan.send_sizes, plan.recv_sizes, mesh)
    return segment_add(table, plan.sums, vals.to(table.dtype))


def _dist_scatter_shard(table: torch.Tensor, ids: torch.Tensor, values: torch.Tensor, *,
                        book: PartitionBook, mesh: Mesh, mode: str) -> torch.Tensor:
    """global_table[ids] = values ("set") or += values ("add", repeated ids
    accumulate, float32 or bfloat16 in the fixed order of
    :func:`segment_add`), each rank with its own ``ids``/``values`` and its
    shard ``table``; -1 ids are dropped.  Returns this rank's updated shard
    (a new tensor)."""
    if mode not in ("set", "add"):
        raise ValueError(mode)
    rows = table.shape[0]
    if mode == "add" and table.dtype in (torch.float32, torch.bfloat16):
        return _dist_scatter_add(table.clone(memory_format=torch.contiguous_format), values,
                                 scatter_add_plan(ids, rows, book=book, mesh=mesh), mesh=mesh)
    perm, send_sizes, recv_sizes, safe = _route(ids, rows, book, mesh)
    vals = alltoallv(values[perm], send_sizes, recv_sizes, mesh).to(table.dtype)
    out = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    if mode == "set":
        out[safe] = vals
    else:   # integers: exact in any order
        out.index_add_(0, safe, vals)
    return out[:rows]


class DistArray:
    """A row-sharded array over a mesh (the JAX package's ``DistArray``):
    rank r holds the book's rows [offsets[r], offsets[r+1]) in ``data``,
    padded to ``shard_size`` rows, on ``mesh.device``.  Every method that exchanges rows
    runs on every rank together, each rank with its own ids, as the JAX
    methods run under ``shard_map``."""

    def __init__(self, data: torch.Tensor, book: PartitionBook, mesh: Mesh):
        self.data = data
        self.book = book
        self.mesh = mesh

    @classmethod
    def create(cls, shape, dtype: torch.dtype, mesh: Mesh,
               book: Optional[PartitionBook] = None) -> "DistArray":
        """Zeros of global ``shape`` (rows first) in ``dtype``."""
        total, *feat = shape
        book = book or PartitionBook.even(total, mesh.world)
        data = torch.zeros((book.shard_size, *feat), dtype=dtype, device=mesh.device)
        return cls(data, book, mesh)

    @classmethod
    def from_array(cls, host_array, mesh: Mesh, book: Optional[PartitionBook] = None,
                   dtype: Optional[torch.dtype] = None) -> "DistArray":
        """This rank's shard of a whole (replicated) host array or tensor,
        padded to ``world * shard_size`` rows (a ``RoundRobinBook`` takes
        every world-th row)."""
        host = torch.as_tensor(host_array)
        if dtype is not None:
            host = host.to(dtype)
        book = book or PartitionBook.even(host.shape[0], mesh.world)
        return cls(_shard_of(host, book, mesh), book, mesh)

    @classmethod
    def from_file(cls, path: str, mesh: Mesh, book: Optional[PartitionBook] = None,
                  dtype: Optional[torch.dtype] = None) -> "DistArray":
        """This rank's shard of the array in a ``.npy`` file (memory-mapped
        by numpy) or a ``.pt`` file (a tensor, memory-mapped by
        ``torch.load``): only this rank's rows are read, never the whole
        array."""
        if path.endswith(".npy"):
            host = np.load(path, mmap_mode="r")
        elif path.endswith(".pt"):
            host = torch.load(path, mmap=True, weights_only=True)
        else:
            raise ValueError(f"unsupported file type {path!r} (expect .npy or .pt)")
        book = book or PartitionBook.even(host.shape[0], mesh.world)
        return cls(_shard_of(host, book, mesh, dtype), book, mesh)

    @property
    def shape(self):
        return (self.book.total,) + tuple(self.data.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def world(self) -> int:
        return self.mesh.world

    def local_shard(self, rank: int) -> torch.Tensor:
        """The logical (unpadded) rows that ``rank`` owns; only this rank's
        are held here."""
        if rank != self.mesh.rank:
            raise ValueError(f"rank {self.mesh.rank} holds its own shard, not rank {rank}'s")
        return self.data[:int(self.book.counts[rank])]

    def gather(self, ids, fill=0, recv_cap="auto") -> torch.Tensor:
        """rows = self[ids] for this rank's ``ids`` (B,), -1 giving ``fill``
        rows, through the exchange of :func:`_dist_gather_shard`; ``recv_cap``
        a policy of :func:`dist_gather_recv_cap`."""
        ids = torch.as_tensor(ids, device=self.mesh.device)
        cap = dist_gather_recv_cap(ids.shape[0], self.mesh.world, recv_cap)
        return _dist_gather_shard(self.data, ids, book=self.book, mesh=self.mesh, fill=fill,
                                  recv_cap=cap)

    def scatter(self, ids, values) -> None:
        """self[ids] = values for this rank's ``ids`` (-1 dropped)."""
        self._scatter(ids, values, "set")

    def scatter_add(self, ids, values) -> None:
        """self[ids] += values for this rank's ``ids`` (-1 dropped; repeated
        ids accumulate in a fixed order)."""
        self._scatter(ids, values, "add")

    def _scatter(self, ids, values, mode: str) -> None:
        ids = torch.as_tensor(ids, device=self.mesh.device)
        values = torch.as_tensor(values, device=self.mesh.device)
        self.data = _dist_scatter_shard(self.data, ids, values, book=self.book,
                                        mesh=self.mesh, mode=mode)

    def to_global(self) -> torch.Tensor:
        """The whole (unpadded) array, gathered from every rank, on the
        host: a test and debugging helper."""
        if self.mesh.world == 1:
            shards = [self.data]
        else:
            shards = [torch.empty_like(self.data) for _ in range(self.mesh.world)]
            dist.all_gather(shards, self.data.contiguous(), group=self.mesh.group)
        padded = torch.cat(shards).cpu()
        gids = np.arange(self.book.total)
        pos = (self.book.owner_of_np(gids).astype(np.int64) * self.book.shard_size
               + self.book.local_offset_np(gids))
        return padded[torch.as_tensor(pos)]


def _shard_of(host, book, mesh: Mesh, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's rows of ``host`` (a tensor, or a numpy array that may be
    memory-mapped: only the rows read are loaded) in local order, padded to
    ``shard_size`` rows, on the mesh's device."""
    r = mesh.rank
    if isinstance(book, RoundRobinBook):
        rows = host[r::book.world_size]
    else:
        rows = host[int(book.offsets[r]):int(book.offsets[r + 1])]
    rows = torch.from_numpy(np.array(rows)) if isinstance(rows, np.ndarray) else rows
    if dtype is not None:
        rows = rows.to(dtype)
    data = torch.zeros((book.shard_size, *rows.shape[1:]), dtype=rows.dtype,
                       device=mesh.device)
    data[:rows.shape[0]] = rows.to(mesh.device)
    return data
