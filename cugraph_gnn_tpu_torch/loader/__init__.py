from cugraph_gnn_tpu_torch.loader.node_loader import NeighborLoader, NodeBatch, NodeLoader

__all__ = ["NeighborLoader", "NodeBatch", "NodeLoader"]
