"""Partition books: which rank owns a node row, at which local offset.

Counterpart of ``cugraph_gnn_tpu/store/partition.py`` (the port keeps its own
copy, as it imports nothing of the JAX package).  Rank ``r`` of an even book
owns rows ``[offsets[r], offsets[r+1])``, ``ceil(total / world)`` at most,
and every rank allocates ``shard_size`` rows, so the padded array has
``world * shard_size`` rows.  The queries take torch tensors (on any device)
or, in their ``_np`` forms, numpy arrays, and divide by ``shard_size``: the
even book is the only one.  Edge-balanced and custom books (offsets found by
search) and the round-robin book come with the modules that need them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def even_shard_size(total: int, world_size: int) -> int:
    """Rows per rank of the even partition (ceil division)."""
    return -(-total // world_size)


@dataclasses.dataclass(frozen=True)
class PartitionBook:
    """Maps global row ids to (owner rank, local offset); built by ``even``.

    total:      global rows (unpadded)
    world_size: ranks
    offsets:    (world_size + 1,) int64; rank r owns [offsets[r], offsets[r+1])
    shard_size: rows allocated on every rank
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

    @property
    def counts(self) -> np.ndarray:
        return self.offsets[1:] - self.offsets[:-1]

    @property
    def padded_total(self) -> int:
        return self.world_size * self.shard_size

    def owner_of(self, ids: torch.Tensor) -> torch.Tensor:
        """Owner rank of each global id."""
        return torch.div(ids, self.shard_size, rounding_mode="floor")

    def local_offset(self, ids: torch.Tensor, owner=None) -> torch.Tensor:
        """Offset of each global id within its owner's shard."""
        if owner is None:
            owner = self.owner_of(ids)
        return ids - owner * self.shard_size

    def owner_of_np(self, ids) -> np.ndarray:
        return np.asarray(ids) // self.shard_size

    def local_offset_np(self, ids) -> np.ndarray:
        ids = np.asarray(ids)
        return ids - self.offsets[:-1][self.owner_of_np(ids)]
