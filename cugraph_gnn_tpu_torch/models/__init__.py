"""GNN layers and models (torch.nn).  Exports what the JAX package's
``models`` exports."""

from cugraph_gnn_tpu_torch.models.builder import create_gnn_model, model_from_args
from cugraph_gnn_tpu_torch.models.conv import (
    GATConv,
    GCNConv,
    GINConv,
    RGCNConv,
    SAGEConv,
)
from cugraph_gnn_tpu_torch.models.zoo import (
    GAT,
    GCN,
    GIN,
    RGCN,
    GraphSAGE,
    MultihopModel,
)

__all__ = [
    "GAT",
    "GCN",
    "GIN",
    "GATConv",
    "GCNConv",
    "GINConv",
    "GraphSAGE",
    "MultihopModel",
    "RGCN",
    "RGCNConv",
    "SAGEConv",
    "create_gnn_model",
    "model_from_args",
]
