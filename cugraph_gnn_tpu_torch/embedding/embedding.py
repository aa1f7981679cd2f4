"""Trainable sharded embedding tables with sparse optimizers.

Counterpart of ``cugraph_gnn_tpu/embedding/embedding.py``.  A
:class:`DistEmbedding` is a row-sharded ``store.DistArray`` over a
:class:`~cugraph_gnn_tpu_torch.parallel.mesh.Mesh` (one process a rank) with
float32 optimizer state beside it, on the mesh's device.  Training:

    tap = emb.make_tap(len(ids))          # zeros that require grad
    rows = emb.lookup(tap, ids)           # the rows, plus the tap
    loss_of(rows).backward()              # tap.grad = d loss / d rows
    emb.add_gradients(ids, tap.grad)
    emb.apply_gradients(lr)               # every rank together

The lookup's local read is the row-gather kernel
(``ops/kernels/gather_kernel.py::gather_rows``), which has no backward: the
rows carry no autograd history of the table (the JAX ``stop_gradient``), so
no dense table-sized gradient ever exists.

A sparse step on each rank: :func:`dedup_ids_grads` (sorted unique ids, the
gradients of each id summed by ``store.dist_array.segment_add``, the CSR
kernel in a fixed order), the ids and summed gradients sent to their owners
(actual-size exchanges), a second dedup of what arrives, and the optimizer on
the owned rows, written back in place (``index_copy_``): untouched rows and
their state are never written.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from cugraph_gnn_tpu_torch.embedding import optimizers as opt_mod
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import read_rows
from cugraph_gnn_tpu_torch.parallel.mesh import Mesh
from cugraph_gnn_tpu_torch.store.dist_array import (
    DistArray,
    _bucket_by_owner,
    _dist_gather_shard,
    _owned_local,
    _ragged_a2a,
    alltoallv,
    segment_add,
    segment_plan,
)
from cugraph_gnn_tpu_torch.store.partition import PartitionBook

_PAD = 2**31 - 1     # where the JAX dedup puts -1 ids: after every real id


def dedup_plan(ids: torch.Tensor, max_unique: Optional[int] = None):
    """(uids, plan): the sorted unique ids of ``ids`` (B,), -1 ignored, in
    ``max_unique`` slots (default B) padded with -1 (ids past the slots
    dropped), and the ``segment_plan`` that sums each id's rows into its
    slot in the order of ``ids``.  ``uids`` keeps the ids' dtype."""
    max_unique = ids.shape[0] if max_unique is None else int(max_unique)
    key = torch.where(ids >= 0, ids.long(), _PAD)
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    k = min(uniq.numel(), max_unique)
    uids = torch.full((max_unique,), -1, dtype=ids.dtype, device=ids.device)
    uids[:k] = torch.where(uniq[:k] == _PAD, -1, uniq[:k]).to(ids.dtype)
    seg = torch.where((key != _PAD) & (inv < max_unique), inv, -1)
    return uids, segment_plan(seg, max_unique)


def dedup_ids_grads(ids: torch.Tensor, grads: torch.Tensor,
                    max_unique: Optional[int] = None):
    """(uids, summed): :func:`dedup_plan`'s ids, and (max_unique, F) the sum
    of each id's gradient rows, zero rows at the padding.

    The sums run through ``segment_add``: each id's rows in the order of
    ``ids``, summed in float32 and rounded once to the gradients' dtype
    (float32 or bfloat16) — the CSR kernel on the card, the same result at
    every call."""
    uids, plan = dedup_plan(ids, max_unique)
    summed = grads.new_zeros((uids.shape[0],) + tuple(grads.shape[1:]))
    if uids.shape[0]:
        segment_add(summed, plan, grads)
    return uids, summed


def _sparse_apply_shard(table: torch.Tensor, state: Dict[str, torch.Tensor],
                        ids: torch.Tensor, grads: torch.Tensor, *, book: PartitionBook,
                        mesh: Mesh, update_fn, hyper) -> None:
    """This rank's sparse step, in place on its shard ``table`` and its
    ``state``: dedup, exchange to the owners, dedup, row update.  Every rank
    calls it together, each with its own ``ids``/``grads``."""
    uids, ugrads = dedup_ids_grads(ids, grads)
    sorted_ids, perm, counts = _bucket_by_owner(uids, book)
    req_ids, send_sizes, recv_sizes = _ragged_a2a(sorted_ids, counts, mesh)
    req_grads = alltoallv(ugrads[perm[:sum(send_sizes)]], send_sizes, recv_sizes, mesh)
    # the same id may arrive from several ranks
    fids, fgrads = dedup_ids_grads(req_ids, req_grads)
    ok, local = _owned_local(fids, book, mesh)
    idx = local[ok].long()
    rows = table[idx]
    state_rows = {k: v[idx] for k, v in state.items()}
    new_rows, new_state = update_fn(rows, fgrads[ok].to(rows.dtype), state_rows, **hyper)
    table.index_copy_(0, idx, new_rows.to(table.dtype))
    for k, v in state.items():
        v.index_copy_(0, idx, new_state[k])


class DistEmbedding:
    """A sharded trainable embedding table over ``table.mesh``; with an
    ``optimizer`` (a key of ``optimizers.SPECS``) its float32 state, row
    sharded as the table, on the mesh's device."""

    def __init__(self, table: DistArray, optimizer: Optional[str] = None,
                 hyper: Optional[dict] = None):
        self.table = table
        self.optimizer = optimizer
        self.hyper = dict(hyper or {})
        self._pending: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._state: Dict[str, torch.Tensor] = {}
        if optimizer is not None:
            self._state = opt_mod.SPECS[optimizer].init_state(
                table.data.shape[0], table.data.shape[1], device=table.mesh.device)

    @staticmethod
    def create(num_embeddings: int, dim: int, mesh: Mesh, optimizer: Optional[str] = None,
               hyper: Optional[dict] = None, dtype=torch.float32, init_scale: float = 0.01,
               seed: int = 0, book: Optional[PartitionBook] = None) -> "DistEmbedding":
        """A table of ``init_scale`` * N(0, 1) rows from a ``torch.Generator``
        seeded with ``seed`` on the mesh's device: rank r's shard is the
        (r+1)-th draw of ``shard_size`` rows, so every rank draws its own
        without holding the others'."""
        book = book or PartitionBook.even(num_embeddings, mesh.world)
        gen = torch.Generator(device=mesh.device).manual_seed(seed)
        for _ in range(mesh.rank + 1):
            data = torch.randn((book.shard_size, dim), generator=gen, dtype=dtype,
                               device=mesh.device)
        data *= init_scale
        return DistEmbedding(DistArray(data, book, mesh), optimizer=optimizer, hyper=hyper)

    @property
    def dim(self) -> int:
        return self.table.data.shape[1]

    # -- lookup -------------------------------------------------------------

    def gather(self, ids) -> torch.Tensor:
        """Rows at this rank's ``ids`` (-1: zero rows), the local reads by
        the row-gather kernel; every rank calls it together."""
        return self.lookup_fn()(self.table.data, None, ids)

    def __getitem__(self, ids):
        return self.gather(ids)

    def make_tap(self, batch_size: int) -> torch.Tensor:
        """A zero (batch_size, dim) tensor that requires grad: added to the
        looked-up rows, its ``.grad`` is the rows' gradient."""
        return torch.zeros((batch_size, self.dim), dtype=self.table.data.dtype,
                           device=self.table.mesh.device, requires_grad=True)

    def lookup_fn(self):
        """(table_data, tap, ids) -> rows + tap (tap None: the rows), with no
        autograd history of ``table_data``."""
        book, mesh = self.table.book, self.table.mesh

        def fn(table_data, tap, ids):
            ids = torch.as_tensor(ids, device=mesh.device)
            rows = _dist_gather_shard(table_data.detach(), ids, book=book, mesh=mesh,
                                      read=read_rows)
            return rows if tap is None else rows + tap

        return fn

    def lookup(self, tap, ids) -> torch.Tensor:
        return self.lookup_fn()(self.table.data, tap, ids)

    # -- training -----------------------------------------------------------

    def add_gradients(self, ids, grads) -> None:
        """Keep (ids, grads) for the next :meth:`apply_gradients`."""
        dev = self.table.mesh.device
        self._pending.append((torch.as_tensor(ids, device=dev),
                              torch.as_tensor(grads, device=dev).detach()))

    def apply_gradients(self, lr: float) -> None:
        """Dedup, exchange and the sparse optimizer step over every pending
        gradient, in place; every rank calls it together."""
        if self.optimizer is None:
            raise ValueError("embedding created without an optimizer")
        if not self._pending:
            return
        ids = torch.cat([p[0] for p in self._pending])
        grads = torch.cat([p[1] for p in self._pending])
        self._pending.clear()
        _sparse_apply_shard(self.table.data, self._state, ids, grads, book=self.table.book,
                            mesh=self.table.mesh,
                            update_fn=opt_mod.UPDATE_FNS[self.optimizer],
                            hyper={**self.hyper, "lr": lr})


class EmbeddingOptimizer:
    """Groups embeddings so that one ``step`` applies all their pending
    sparse updates."""

    def __init__(self, embeddings: Optional[List[DistEmbedding]] = None):
        self.embeddings = list(embeddings or [])

    def add_embedding(self, emb: DistEmbedding) -> None:
        self.embeddings.append(emb)

    def step(self, lr: float) -> None:
        for emb in self.embeddings:
            emb.apply_gradients(lr)
