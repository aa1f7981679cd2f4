"""Multi-hop neighbor sampling: homogeneous, hetero, disjoint, distributed
and negative.  Exports what the JAX package's ``sampler`` exports."""

from cugraph_gnn_tpu_torch.sampler.disjoint import (
    DisjointBatch,
    DisjointNeighborSampler,
    to_coo_disjoint,
)
from cugraph_gnn_tpu_torch.sampler.dist_sampler import DistGraph, DistNeighborSampler
from cugraph_gnn_tpu_torch.sampler.hetero import HeteroMultihopBatch, HeteroNeighborSampler
from cugraph_gnn_tpu_torch.sampler.heuristics import (
    auto_max_unique_per_hop,
    resolve_max_unique_per_hop,
)
from cugraph_gnn_tpu_torch.sampler.hetero_dist import (
    HeteroDistGraph,
    HeteroDistNeighborSampler,
)
from cugraph_gnn_tpu_torch.sampler.negative import NegativeSampling, sample_negative_edges
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import (
    NeighborSampler,
    level_capacities,
    multihop_uniform,
    uniform_sample_np,
)
from cugraph_gnn_tpu_torch.sampler.output import (
    COOSample,
    CSCSample,
    HopBlock,
    MultihopBatch,
    to_coo,
    to_csc,
)

__all__ = [
    "COOSample",
    "CSCSample",
    "DisjointBatch",
    "DisjointNeighborSampler",
    "DistGraph",
    "DistNeighborSampler",
    "HeteroDistGraph",
    "HeteroDistNeighborSampler",
    "HeteroMultihopBatch",
    "HeteroNeighborSampler",
    "HopBlock",
    "MultihopBatch",
    "auto_max_unique_per_hop",
    "NegativeSampling",
    "NeighborSampler",
    "level_capacities",
    "multihop_uniform",
    "sample_negative_edges",
    "to_coo",
    "to_coo_disjoint",
    "resolve_max_unique_per_hop",
    "to_csc",
    "uniform_sample_np",
]
