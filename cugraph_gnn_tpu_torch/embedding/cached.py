"""Trainable device-cached host embedding: host tags, device rows.

Counterpart of ``cugraph_gnn_tpu/embedding/cached.py``, the reference's
``device_cached_host_embedding``: the table lives in host memory (a numpy
array or memmap), a set-associative LFU cache of its hot rows lives on the
card.

* :class:`HostManagedCache` keeps its metadata on the host, in numpy, and
  computes it exactly as the JAX package does: tags (int64), LFU counters
  (int32) and modified bits per (set, way); the hash ``(ids * 0x9E3779B1)
  >> 8`` (exact in int64 for ids below 2**31), then ``% sets``.  A batch's
  plan (``_plan``: an in-batch unique, hits, counters aged once per touched
  set, a per-set occurrence rank, a stable sort of the counters, and only
  cold ways (counter <= 1, rank < ways) replaced) is host work.  The device
  holds the rows ``(sets, ways, F)`` and runs, per gather: the read of the
  hit slots through the row-gather kernel over the rows viewed as (sets *
  ways, F) (slot ``s * ways + w``; -1 for a miss gives a zero row), plus the
  upload (the fetched rows, zero on hits), and one ``index_put_`` of the
  rows it inserts.  Float tables take the kernel; any other dtype (an int64
  label column) is read by indexing (``read_rows``).
* Dirty slots are written back to the host (a synchronising read of the
  slots, ``_writeback``) before an insert overwrites them, and by
  :meth:`HostManagedCache.flush`.
* :meth:`HostManagedCache.prefetch` plans the next batch in a worker thread.
  The plan mutates the metadata, so every mutating call (``update``,
  ``flush``, ``drop_all``, a ``gather`` of other ids) first joins it and
  applies it.
* :class:`CachedHostEmbedding` trains such a table: the sparse update runs on
  the device over the deduplicated rows (``embedding.dedup_ids_grads``),
  which land in the cache as dirty rows; its float32 optimizer state stays
  on the host and is streamed up and back each step.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.embedding import optimizers as opt_mod
from cugraph_gnn_tpu_torch.embedding.embedding import dedup_ids_grads
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import read_rows

_GOLDEN = 0x9E3779B1


class _Plan:
    """What a gather of ``ids_key`` does on the device: per position its
    set, way and whether the cache serves it, the upload (fetched rows,
    zero where the cache serves), the inserts, and the dirty slots to write
    back first."""

    __slots__ = ("ids_key", "s", "w", "use_cache", "upload", "ins_s", "ins_w", "ins_vals",
                 "evict_s", "evict_w", "evict_ids")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class HostManagedCache:
    """Set-associative LFU cache of ``host_rows`` (N, F), any row-indexable
    host store: metadata on the host, rows on ``device`` (default: the
    card)."""

    def __init__(self, host_rows, capacity: int, ways: int = 8, dtype=None, device=None):
        self.host_rows = host_rows
        n, f = host_rows.shape
        self.num_rows = n
        self.dim = f
        self.ways = ways
        self.sets = max(capacity // ways, 1)
        self.device = resolve_device(device)
        dtype = dtype or torch.from_numpy(np.asarray(host_rows[:0])).dtype
        self.rows = torch.zeros((self.sets, ways, f), dtype=dtype, device=self.device)
        self.tags = np.full((self.sets, ways), -1, np.int64)
        self.freq = np.zeros((self.sets, ways), np.int32)
        self.modified = np.zeros((self.sets, ways), bool)
        self.hits = 0
        self.misses = 0
        self.uploaded = 0          # miss rows fetched from the host
        self.written_back = 0      # dirty rows written to the host
        self._prefetched = None

    @property
    def _flat(self) -> torch.Tensor:
        """The rows as (sets * ways, F): slot s * ways + w."""
        return self.rows.view(self.sets * self.ways, self.dim)

    # -- host-side planning --------------------------------------------------

    def _set_of(self, ids: np.ndarray) -> np.ndarray:
        return ((ids.astype(np.int64) * _GOLDEN) >> 8) % self.sets

    def _plan(self, ids: np.ndarray) -> _Plan:
        """Hits, misses, slots and evictions of one batch; moves the host
        metadata to its state after the batch and fetches the miss rows."""
        ids = np.asarray(ids).astype(np.int64).ravel()
        b = ids.shape[0]
        valid = (ids >= 0) & (ids < self.num_rows)
        # duplicates share one lookup and one insert
        uids, inv = np.unique(np.where(valid, ids, -1), return_inverse=True)
        uvalid = uids >= 0
        s = np.where(uvalid, self._set_of(np.maximum(uids, 0)), 0)
        eq = self.tags[s] == uids[:, None]                    # (U, W)
        hit = eq.any(1) & uvalid
        way = np.where(hit, eq.argmax(1), 0)
        np.add.at(self.freq, (s[hit], way[hit]), 1)
        self.hits += int(valid.sum() - (~hit[inv] & valid).sum())

        miss = uvalid & ~hit
        self.misses += int((miss[inv] & valid).sum())
        m_idx = np.nonzero(miss)[0]
        ins_s = ins_w = np.zeros((0,), np.int64)
        ins_pos = np.zeros((0,), np.int64)
        ev_s = ev_w = np.zeros((0,), np.int64)
        ev_ids = np.zeros((0,), np.int64)
        if len(m_idx):
            ms = s[m_idx]
            # age the touched sets once per batch
            self.freq[np.unique(ms)] = np.maximum(self.freq[np.unique(ms)] - 1, 0)
            # occurrence rank of each miss within its set
            order = np.argsort(ms, kind="stable")
            ms_sorted = ms[order]
            first = np.searchsorted(ms_sorted, ms_sorted, side="left")
            rank = np.empty(len(ms), np.int64)
            rank[order] = np.arange(len(ms)) - first
            way_order = np.argsort(self.freq[ms], axis=1, kind="stable")
            mway = way_order[np.arange(len(ms)), rank % self.ways]
            # only cold ways are replaced; hot residents and overflow ranks
            # bypass the cache for this batch
            eligible = (rank < self.ways) & (self.freq[ms, mway] <= 1)
            e = np.nonzero(eligible)[0]
            ins_s, ins_w = ms[e], mway[e]
            ins_pos = m_idx[e]
            old = self.tags[ins_s, ins_w]
            dirty = (old >= 0) & self.modified[ins_s, ins_w]
            ev_s, ev_w = ins_s[dirty], ins_w[dirty]
            ev_ids = old[dirty]
            self.tags[ins_s, ins_w] = uids[ins_pos]
            self.freq[ins_s, ins_w] = 1
            self.modified[ins_s, ins_w] = False
            way[ins_pos] = ins_w
        dt = np.asarray(self.host_rows[:0]).dtype
        fetched = np.zeros((b, self.dim), dt)
        ins_vals = np.zeros((0, self.dim), dt)
        if len(m_idx):
            fetched_u = np.zeros((len(uids), self.dim), dt)
            fetched_u[m_idx] = np.asarray(self.host_rows[np.maximum(uids[m_idx], 0)])
            fetched = fetched_u[inv]
            ins_vals = fetched_u[ins_pos]
            self.uploaded += len(m_idx)
        return _Plan(ids_key=ids, s=s[inv], w=way[inv], use_cache=hit[inv] & valid,
                     upload=np.where(valid[:, None], fetched, 0).astype(dt, copy=False),
                     ins_s=ins_s, ins_w=ins_w, ins_vals=ins_vals,
                     evict_s=ev_s, evict_w=ev_w, evict_ids=ev_ids)

    def _writeback(self, s: np.ndarray, w: np.ndarray, ids: np.ndarray) -> None:
        """Copy dirty slots to their host rows: a synchronising read, which
        must come before anything overwrites the slots."""
        if not len(ids):
            return
        slot = torch.from_numpy(s * self.ways + w).to(self.device)
        self.host_rows[ids] = read_rows(self._flat, slot).cpu().numpy()
        self.written_back += len(ids)

    # -- public API ----------------------------------------------------------

    def gather(self, ids) -> torch.Tensor:
        """rows = store[ids] through the cache, on the cache's device; ids <
        0 or past the end give zero rows.  Takes a matching
        :meth:`prefetch` plan if one is pending."""
        ids_np = _host_ids(ids)
        plan = self._take_prefetched(ids_np)
        if plan is None:
            plan = self._plan(ids_np)
        return self._apply_plan(plan)

    def _apply_plan(self, plan: _Plan) -> torch.Tensor:
        self._writeback(plan.evict_s, plan.evict_w, plan.evict_ids)
        slot = np.where(plan.use_cache, plan.s * self.ways + plan.w, -1)
        out = read_rows(self._flat, torch.from_numpy(slot).to(self.device))
        out += torch.from_numpy(plan.upload).to(self.device)
        if len(plan.ins_s):
            ins = torch.from_numpy(plan.ins_s * self.ways + plan.ins_w).to(self.device)
            self._flat.index_put_((ins,), torch.from_numpy(plan.ins_vals).to(
                device=self.device, dtype=self.rows.dtype))
        return out

    def prefetch(self, ids) -> None:
        """Plan and fetch the rows of the next gather in a worker thread.
        The plan moves the metadata at once; a gather of other ids first
        applies it, so that metadata and device rows agree."""
        self._drain_prefetch()
        ids_np = _host_ids(ids)
        holder: List[Optional[_Plan]] = [None]

        def work():
            holder[0] = self._plan(ids_np)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._prefetched = (t, holder, ids_np)

    def _take_prefetched(self, ids_np) -> Optional[_Plan]:
        if self._prefetched is None:
            return None
        t, holder, key = self._prefetched
        self._prefetched = None
        t.join()
        if np.array_equal(key, ids_np):
            return holder[0]
        # other ids: finish the prefetched batch's inserts, then re-plan
        self._apply_plan(holder[0])
        return None

    def _drain_prefetch(self) -> None:
        """Apply a pending prefetched plan: its inserts would otherwise land
        on slots written after it was made."""
        if self._prefetched is not None:
            t, holder, _ = self._prefetched
            self._prefetched = None
            t.join()
            self._apply_plan(holder[0])

    def update(self, ids, new_rows: torch.Tensor) -> None:
        """Write trained rows: cached ids into their slots, marked modified
        (the host row stays stale until eviction or :meth:`flush`); the
        others straight to the host store."""
        self._drain_prefetch()
        ids = _host_ids(ids)
        valid = (ids >= 0) & (ids < self.num_rows)
        s = np.where(valid, self._set_of(np.maximum(ids, 0)), 0)
        eq = self.tags[s] == ids[:, None]
        hit = eq.any(1) & valid
        way = np.where(hit, eq.argmax(1), 0)
        h = np.nonzero(hit)[0]
        if len(h):
            sel = torch.from_numpy(h).to(new_rows.device)
            slot = torch.from_numpy(s[h] * self.ways + way[h]).to(self.device)
            self._flat.index_put_((slot,), new_rows[sel].to(self.rows.dtype))
        self.modified[s[hit], way[hit]] = True
        stale = np.nonzero(valid & ~hit)[0]
        if len(stale):
            vals = new_rows[torch.from_numpy(stale).to(new_rows.device)].cpu().numpy()
            self.host_rows[ids[stale]] = vals.astype(np.asarray(self.host_rows[:0]).dtype)

    def flush(self) -> None:
        """Write every modified slot back to the host store and clear the
        modified bits (before reading or saving the host table)."""
        self._drain_prefetch()
        ds, dw = np.nonzero(self.modified)
        self._writeback(ds, dw, self.tags[ds, dw])
        self.modified[:] = False

    def drop_all(self) -> None:
        """Flush, then invalidate every slot and reset the counts."""
        self.flush()
        self.tags[:] = -1
        self.freq[:] = 0
        self.hits = 0
        self.misses = 0

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0


def _host_ids(ids) -> np.ndarray:
    """The ids as a flat int64 numpy array (a device tensor is read back)."""
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids).astype(np.int64).ravel()


class CachedHostEmbedding:
    """A trainable embedding whose table ``host_table`` (N, dim) lives in
    host memory behind a :class:`HostManagedCache` on ``device`` (default:
    the card), for tables larger than the card.

    Training as ``DistEmbedding``: ``gather`` (or rows + ``make_tap``),
    backward, ``add_gradients``, ``apply_gradients``.  The optimizer's
    float32 state stays on the host (as the reference's separate state
    tensors) and streams to the device and back for the touched rows."""

    def __init__(self, host_table: np.ndarray, optimizer: str = "sgd",
                 hyper: Optional[dict] = None, capacity: Optional[int] = None,
                 cache_ratio: float = 0.2, ways: int = 8, dtype=None, device=None):
        self.host_table = host_table
        n, dim = host_table.shape
        self.num_embeddings = n
        self.dim = dim
        cap = capacity or max(int(n * cache_ratio), ways)
        self.cache = HostManagedCache(host_table, cap, ways=ways, dtype=dtype, device=device)
        self.device = self.cache.device
        self.optimizer = optimizer
        self.hyper = dict(hyper or {})
        self._update_fn = opt_mod.UPDATE_FNS[optimizer]
        self._state: Dict[str, np.ndarray] = {
            k: np.zeros((n, dim * w if w > 0 else 1), np.float32)
            for k, w in opt_mod.SPECS[optimizer].state_widths.items()}
        self._pending: List[Tuple[torch.Tensor, torch.Tensor]] = []

    # -- lookup --------------------------------------------------------------

    def gather(self, ids) -> torch.Tensor:
        return self.cache.gather(ids)

    def prefetch(self, ids) -> None:
        self.cache.prefetch(ids)

    def make_tap(self, batch_size: int) -> torch.Tensor:
        """A zero (batch_size, dim) tensor that requires grad: added to the
        gathered rows, its ``.grad`` is the rows' gradient."""
        return torch.zeros((batch_size, self.dim), dtype=self.cache.rows.dtype,
                           device=self.device, requires_grad=True)

    # -- training ------------------------------------------------------------

    def add_gradients(self, ids, grads) -> None:
        self._pending.append((torch.as_tensor(ids, device=self.device),
                              torch.as_tensor(grads, device=self.device).detach()))

    def apply_gradients(self, lr: float) -> None:
        """Dedup, the rows through the cache, the optimizer on the device,
        the new rows written into the cache as dirty; the state of the
        touched rows streamed from the host and back."""
        if not self._pending:
            return
        ids = torch.cat([p[0] for p in self._pending])
        grads = torch.cat([p[1] for p in self._pending])
        self._pending.clear()
        uids, ugrads = dedup_ids_grads(ids, grads)
        uids_np = uids.cpu().numpy().astype(np.int64)
        k = int((uids_np >= 0).sum())           # the unique ids lead, sorted
        uids_np = uids_np[:k]
        rows = self.cache.gather(uids_np)
        new_rows, new_state = self._update_fn(rows, ugrads[:k].to(rows.dtype),
                                              self._state_rows(uids_np), lr=lr, **self.hyper)
        self.cache.update(uids_np, new_rows)
        self._store_state(uids_np, new_state)

    def _state_rows(self, ids: np.ndarray) -> Dict[str, torch.Tensor]:
        """The optimizer state of rows ``ids``, streamed to the device."""
        return {name: torch.from_numpy(v[ids]).to(self.device)
                for name, v in self._state.items()}

    def _store_state(self, ids: np.ndarray, state: Dict[str, torch.Tensor]) -> None:
        """Stream the new state of rows ``ids`` back to the host."""
        for name, v in state.items():
            self._state[name][ids] = v.cpu().numpy()

    def flush(self) -> None:
        """Write every dirty cached row to the host table."""
        self.cache.flush()

    @property
    def hit_rate(self) -> float:
        return self.cache.hit_rate
