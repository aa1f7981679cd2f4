"""Device-side feature cache: set-associative LFU over a host row store.

Counterpart of ``cugraph_gnn_tpu/embedding/cache.py``: ``CachePolicy`` (the
reference's cache policy builders; on one card the placement kinds collapse
to a capacity) and ``DeviceLFUCache``, whose tags and LFU counters live on
the device beside its rows ``(sets, ways, F)``.  A lookup hashes each id to
a set, matches it against the set's tags on the device, and reads the hit
mask back to the host every batch to fetch the misses from the host store;
an insert evicts the coldest ways (counters aged once per touched set and
batch).  ``embedding/cached.py::HostManagedCache`` keeps the metadata on the
host instead and needs no read-back; this cache is ported as the JAX
package's own earlier design.

The JAX hash multiplies in uint32, wrapping; here the same value is computed
in int64 as ``((ids * 0x9E3779B1) & 0xFFFFFFFF) >> 8``, then ``% sets``.
Tags are int64.  Hit rows are read by the row-gather kernel
(``read_rows``: float tables) over the rows viewed as (sets * ways, F).

A set's valid misses are ranked in batch order, and ranks >= ``ways``
bypass the cache for that batch, as ``HostManagedCache`` does: every insert
of a batch has its own (set, way), so the row and tag writes are defined on
the card too.  The JAX cache ranks the -1 entries with the misses and wraps
the rank (``rank % ways``), which can name one slot twice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import read_rows

_GOLDEN = 0x9E3779B1


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    """kind: none | local_device | local_node | all_devices (all but "none"
    cache in the one card's memory); cache_ratio of the rows; ways per set."""

    kind: str = "local_device"
    cache_ratio: float = 0.2
    ways: int = 32

    def capacity_for(self, num_rows: int) -> int:
        if self.kind == "none":
            return 0
        return max(int(num_rows * self.cache_ratio), self.ways)


class DeviceLFUCache:
    """Set-associative LFU cache of a host row store ``host_rows`` (N, F)
    with tags and counters on ``device`` (default: the card)."""

    def __init__(self, host_rows: np.ndarray, capacity: int, ways: int = 8, dtype=None,
                 device=None):
        self.host_rows = np.asarray(host_rows)
        n, f = self.host_rows.shape
        self.num_rows = n
        self.ways = ways
        self.sets = max(capacity // ways, 1)
        self.device = resolve_device(device)
        dtype = dtype or torch.from_numpy(self.host_rows[:0]).dtype
        self.rows = torch.zeros((self.sets, ways, f), dtype=dtype, device=self.device)
        self.tags = torch.full((self.sets, ways), -1, dtype=torch.int64, device=self.device)
        self.freq = torch.zeros((self.sets, ways), dtype=torch.int32, device=self.device)
        self.hits = 0
        self.misses = 0

    # -- device-side pieces --------------------------------------------------

    def _set_of(self, ids: torch.Tensor) -> torch.Tensor:
        return (((ids * _GOLDEN) & 0xFFFFFFFF) >> 8) % self.sets

    def _lookup(self, ids: torch.Tensor):
        """(rows at the hits, zeros elsewhere; hit mask); bumps the hits'
        counters."""
        s = self._set_of(ids)
        set_tags = self.tags[s]                                   # (B, W)
        hit_way = torch.argmax((set_tags == ids[:, None]).to(torch.int32), dim=1)
        hit = (set_tags.gather(1, hit_way[:, None])[:, 0] == ids) & (ids >= 0)
        slot = torch.where(hit, s * self.ways + hit_way, -1)
        out = read_rows(self.rows.view(self.sets * self.ways, -1), slot)
        self.freq.index_put_((s, hit_way), hit.to(torch.int32), accumulate=True)
        return out, hit

    def _insert_slots(self, ids: torch.Tensor):
        """Age the sets the misses ``ids`` (>= 0; others -1) touch and
        choose their slots: a set's valid misses are ranked in batch order,
        and the rank-th takes the rank-th coldest way of its set if that way
        is cold (aged counter <= 1).  Ranks >= ``ways`` bypass the cache for
        this batch, so no two chosen slots of a batch are the same.
        Returns (eligible mask, their sets, their ways)."""
        s = self._set_of(ids)
        ok = ids >= 0
        s_safe = torch.where(ok, s, 0)
        # ids < 0 rank in a set of their own, past the real ones
        s_key = torch.where(ok, s, self.sets)
        order = torch.argsort(s_key, stable=True)
        s_sorted = s_key[order]
        first = torch.searchsorted(s_sorted, s_sorted, side="left")
        rank = torch.empty_like(order)
        rank[order] = torch.arange(s.numel(), device=s.device) - first
        # age each touched set once per batch
        dec = (ok & (rank == 0)).to(torch.int32)
        self.freq.index_add_(0, s_safe, -dec[:, None].expand(-1, self.ways))
        self.freq.clamp_(min=0)
        way_order = torch.argsort(self.freq[s_safe], dim=1, stable=True)
        in_set = ok & (rank < self.ways)
        way = way_order.gather(1, torch.where(in_set, rank, 0)[:, None])[:, 0]
        eligible = in_set & (self.freq[s_safe, way] <= 1)
        return eligible, s_safe[eligible], way[eligible]

    def _insert(self, ids: torch.Tensor, new_rows: torch.Tensor) -> None:
        """Insert the rows of the misses ``ids`` (others -1) into their
        slots (``_insert_slots``)."""
        eligible, es, ew = self._insert_slots(ids)
        self.rows[es, ew] = new_rows[eligible].to(self.rows.dtype)
        self.tags[es, ew] = ids[eligible]
        self.freq[es, ew] = 1

    # -- public API ----------------------------------------------------------

    def gather(self, ids) -> torch.Tensor:
        """rows = store[ids] through the cache, on the cache's device; ids <
        0 give zero rows.  Reads the hit mask back to the host."""
        ids = torch.as_tensor(ids, device=self.device).long()
        out, hit = self._lookup(ids)
        hit_np = hit.cpu().numpy()
        ids_np = ids.cpu().numpy()
        miss_mask = ~hit_np & (ids_np >= 0)
        self.hits += int(hit_np.sum())
        self.misses += int(miss_mask.sum())
        if miss_mask.any():
            fetched = np.where(miss_mask[:, None],
                               self.host_rows[np.clip(ids_np, 0, self.num_rows - 1)], 0)
            fetched = torch.from_numpy(fetched.astype(self.host_rows.dtype)).to(self.device)
            miss = torch.from_numpy(miss_mask).to(self.device)
            self._insert(torch.where(miss, ids, -1), fetched)
            out = torch.where(miss[:, None], fetched.to(out.dtype), out)
        return out

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    def drop_all(self) -> None:
        """Invalidate every slot and reset the counts."""
        self.tags.fill_(-1)
        self.freq.zero_()
        self.hits = 0
        self.misses = 0
