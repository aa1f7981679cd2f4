from cugraph_gnn_tpu_torch.embedding.cached import (
    CachedHostEmbedding,
    HostManagedCache,
)
from cugraph_gnn_tpu_torch.embedding.embedding import (
    DistEmbedding,
    EmbeddingOptimizer,
    dedup_ids_grads,
)
from cugraph_gnn_tpu_torch.embedding.optimizers import SPECS, UPDATE_FNS

__all__ = [
    "CachedHostEmbedding",
    "DistEmbedding",
    "EmbeddingOptimizer",
    "HostManagedCache",
    "SPECS",
    "UPDATE_FNS",
    "dedup_ids_grads",
]
