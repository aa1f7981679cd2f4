"""DistMatrix: a COO edge matrix stored as two row-partitioned arrays.

Counterpart of ``cugraph_gnn_tpu/store/dist_matrix.py`` (the reference's
``DistMatrix``): the edge list as two ``DistArray``s of one column, source
and destination, partitioned along the edge dimension.  Rank r holds the
edges of its book's rows; ``gather_edges`` reads any edges through the
distributed gather, every rank together.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch.parallel.mesh import Mesh
from cugraph_gnn_tpu_torch.store.dist_array import DistArray
from cugraph_gnn_tpu_torch.store.partition import PartitionBook


class DistMatrix:
    """Edge-partitioned COO matrix (src, dst)."""

    def __init__(self, src: DistArray, dst: DistArray):
        if src.book.total != dst.book.total:
            raise ValueError(f"{src.book.total} sources, {dst.book.total} destinations")
        self.src = src
        self.dst = dst

    @staticmethod
    def from_coo(src, dst, mesh: Mesh, book: Optional[PartitionBook] = None) -> "DistMatrix":
        """This rank's edges of a whole COO (host arrays or tensors)."""
        col = lambda a: torch.as_tensor(np.asarray(a)).reshape(-1, 1)
        return DistMatrix(DistArray.from_array(col(src), mesh, book=book),
                          DistArray.from_array(col(dst), mesh, book=book))

    @property
    def num_edges(self) -> int:
        return self.src.book.total

    @property
    def book(self) -> PartitionBook:
        return self.src.book

    def local_src(self, rank: int) -> torch.Tensor:
        """The sources of the edges that ``rank`` holds (this rank's only)."""
        return self.src.local_shard(rank)[:, 0]

    def local_dst(self, rank: int) -> torch.Tensor:
        return self.dst.local_shard(rank)[:, 0]

    def local_coo(self, rank: int):
        return self.local_src(rank), self.local_dst(rank)

    def gather_edges(self, edge_ids):
        """(src, dst) of global ``edge_ids`` (this rank's query), every rank
        together; -1 ids give 0."""
        return self.src.gather(edge_ids)[:, 0], self.dst.gather(edge_ids)[:, 0]

    def to_global(self):
        """The whole (src, dst), on the host; every rank together."""
        return self.src.to_global()[:, 0], self.dst.to_global()[:, 0]
