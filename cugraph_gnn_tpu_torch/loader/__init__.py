from cugraph_gnn_tpu_torch.loader.dist_loader import (
    DistLinkNeighborLoader,
    DistNeighborLoader,
    auto_mesh,
)
from cugraph_gnn_tpu_torch.loader.link_loader import LinkBatch, LinkLoader, LinkNeighborLoader
from cugraph_gnn_tpu_torch.loader.node_loader import NeighborLoader, NodeBatch, NodeLoader

__all__ = ["DistLinkNeighborLoader", "DistNeighborLoader", "LinkBatch", "LinkLoader",
           "LinkNeighborLoader", "NeighborLoader", "NodeBatch", "NodeLoader", "auto_mesh"]
