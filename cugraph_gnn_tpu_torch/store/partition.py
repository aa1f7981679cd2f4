"""Partition books: which rank owns a node row, at which local offset.

Counterpart of ``cugraph_gnn_tpu/store/partition.py`` (the port keeps its own
copy, as it imports nothing of the JAX package).  Rank ``r`` owns the
contiguous rows ``[offsets[r], offsets[r+1])`` and every rank allocates
``shard_size`` rows (the largest count), so the padded array has ``world *
shard_size`` rows.  Three constructors:

- ``even``: ``ceil(total / world)`` rows a rank (the reference's default);
- ``edge_balanced``: cuts where the CSR's cumulative edge count crosses
  multiples of E / W, so that every shard holds about the same number of
  edges (the distributed sampler's default book);
- ``from_counts``: given rows a rank (the reference's
  ``rank_entry_partition``).

The queries take torch tensors (on any device) or, in their ``_np`` forms,
numpy arrays: a division by ``shard_size`` for an even book, a search over
the offsets (side right, so an empty rank owns nothing) for the others.

:class:`RoundRobinBook` deals rows out in turn instead (owner = id % W,
local = id // W, the reference's round-robin shard): its rows are not
contiguous, so ``offsets`` is only the prefix of its per-rank counts, and
the padded layout puts id at ``owner * shard_size + local``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def even_shard_size(total: int, world_size: int) -> int:
    """Rows per rank of the even partition (ceil division)."""
    return -(-total // world_size)


@dataclasses.dataclass(frozen=True)
class PartitionBook:
    """Maps global row ids to (owner rank, local offset).

    total:      global rows (unpadded)
    world_size: ranks
    offsets:    (world_size + 1,) int64; rank r owns [offsets[r], offsets[r+1])
    shard_size: rows allocated on every rank (the largest count)
    """

    total: int
    world_size: int
    offsets: np.ndarray
    shard_size: int

    @staticmethod
    def even(total: int, world_size: int) -> "PartitionBook":
        size = even_shard_size(total, world_size)
        offsets = np.minimum(np.arange(world_size + 1, dtype=np.int64) * size, total)
        return PartitionBook(total=total, world_size=world_size, offsets=offsets,
                             shard_size=size)

    @staticmethod
    def edge_balanced(indptr, world_size: int) -> "PartitionBook":
        """Rows cut so that each shard holds ~E / W edges of the CSR
        ``indptr``: the cuts are the rows where the cumulative edge count
        first reaches each multiple of E / W (contiguous rows still, so every
        range-book query applies; a hub can leave a rank empty)."""
        indptr = np.asarray(indptr, dtype=np.int64)
        n = len(indptr) - 1
        targets = np.arange(1, world_size, dtype=np.int64) * int(indptr[-1]) // world_size
        cuts = np.searchsorted(indptr, targets, side="left")
        offsets = np.maximum.accumulate(np.concatenate([[0], cuts, [n]]).astype(np.int64))
        counts = offsets[1:] - offsets[:-1]
        return PartitionBook(total=n, world_size=world_size, offsets=offsets,
                             shard_size=int(counts.max()) if world_size else 0)

    @staticmethod
    def from_counts(counts: Sequence[int]) -> "PartitionBook":
        """counts[r] rows for rank r, in rank order."""
        counts = np.asarray(counts, dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return PartitionBook(total=int(offsets[-1]), world_size=len(counts),
                             offsets=offsets,
                             shard_size=int(counts.max()) if len(counts) else 0)

    @property
    def is_even(self) -> bool:
        expect = np.minimum(np.arange(self.world_size + 1, dtype=np.int64) * self.shard_size,
                            self.total)
        return bool(np.array_equal(self.offsets, expect))

    @property
    def counts(self) -> np.ndarray:
        return self.offsets[1:] - self.offsets[:-1]

    @property
    def padded_total(self) -> int:
        return self.world_size * self.shard_size

    def owner_of(self, ids: torch.Tensor) -> torch.Tensor:
        """Owner rank of each global id."""
        if self.is_even:
            return torch.div(ids, max(self.shard_size, 1), rounding_mode="floor")
        cuts = torch.as_tensor(self.offsets[1:-1], device=ids.device)
        return torch.searchsorted(cuts, ids.to(torch.int64), right=True).to(ids.dtype)

    def local_offset(self, ids: torch.Tensor, owner=None) -> torch.Tensor:
        """Offset of each global id within its owner's rows."""
        if owner is None:
            owner = self.owner_of(ids)
        if self.is_even:
            return ids - owner * self.shard_size
        starts = torch.as_tensor(self.offsets[:-1], device=ids.device)
        return ids - starts[owner.clamp(0, self.world_size - 1).long()].to(ids.dtype)

    def to_padded(self, ids: torch.Tensor, owner=None) -> torch.Tensor:
        """Global id -> its row in the padded (world * shard_size) layout."""
        if self.is_even:
            return ids
        if owner is None:
            owner = self.owner_of(ids)
        return owner * self.shard_size + self.local_offset(ids, owner)

    def owner_of_np(self, ids) -> np.ndarray:
        if self.is_even:
            return np.asarray(ids) // max(self.shard_size, 1)
        return np.searchsorted(self.offsets[1:-1], np.asarray(ids), side="right")

    def local_offset_np(self, ids) -> np.ndarray:
        ids = np.asarray(ids)
        return ids - self.offsets[:-1][self.owner_of_np(ids)]


@dataclasses.dataclass(frozen=True)
class RoundRobinBook:
    """Round-robin row assignment: owner = id % world, local = id // world.

    Has the ``PartitionBook`` surface that the exchanges use (``owner_of``,
    ``local_offset``, ``to_padded``, ``counts``, ``shard_size``,
    ``world_size`` and their ``_np`` forms); ``offsets`` is the prefix of
    ``counts``, not a range of global ids."""

    total: int
    world_size: int

    @property
    def shard_size(self) -> int:
        return even_shard_size(self.total, self.world_size)

    @property
    def padded_total(self) -> int:
        return self.world_size * self.shard_size

    @property
    def counts(self) -> np.ndarray:
        base, extra = divmod(self.total, self.world_size)
        return base + (np.arange(self.world_size) < extra).astype(np.int64)

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.counts)]).astype(np.int64)

    @property
    def is_even(self) -> bool:
        return False

    def owner_of(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.remainder(ids, self.world_size)

    def local_offset(self, ids: torch.Tensor, owner=None) -> torch.Tensor:
        return torch.div(ids, self.world_size, rounding_mode="floor")

    def to_padded(self, ids: torch.Tensor, owner=None) -> torch.Tensor:
        return self.owner_of(ids) * self.shard_size + self.local_offset(ids)

    def owner_of_np(self, ids) -> np.ndarray:
        return np.asarray(ids) % self.world_size

    def local_offset_np(self, ids) -> np.ndarray:
        return np.asarray(ids) // self.world_size
