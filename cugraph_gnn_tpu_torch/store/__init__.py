"""Row partitioning and the distributed gather and scatter over it."""

from cugraph_gnn_tpu_torch.store.dist_array import DistArray, alltoallv
from cugraph_gnn_tpu_torch.store.dist_matrix import DistMatrix
from cugraph_gnn_tpu_torch.store.hierarchical import HierarchicalDistArray
from cugraph_gnn_tpu_torch.store.partition import (
    PartitionBook,
    RoundRobinBook,
    even_shard_size,
)

__all__ = [
    "DistArray",
    "DistMatrix",
    "HierarchicalDistArray",
    "PartitionBook",
    "RoundRobinBook",
    "alltoallv",
    "even_shard_size",
]
