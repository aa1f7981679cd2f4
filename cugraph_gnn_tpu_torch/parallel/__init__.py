"""The process-group meshes that row-sharded arrays live on.

``row_sharding`` and ``replicated`` of the JAX package are
``jax.sharding.NamedSharding``s, which have no torch counterpart: a rank
holds its own rows."""

from cugraph_gnn_tpu_torch.parallel.mesh import (
    STORE_AXIS,
    HierarchicalMesh,
    Mesh,
    axis_size,
    create_hierarchical_mesh,
    create_store_mesh,
    split_mesh,
)

__all__ = [
    "STORE_AXIS",
    "HierarchicalMesh",
    "Mesh",
    "axis_size",
    "create_hierarchical_mesh",
    "create_store_mesh",
    "split_mesh",
]
