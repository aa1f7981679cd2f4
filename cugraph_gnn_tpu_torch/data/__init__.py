from cugraph_gnn_tpu_torch.data.feature_store import FeatureStore
from cugraph_gnn_tpu_torch.data.graph_store import GraphStore, SamplingGraph

__all__ = ["FeatureStore", "GraphStore", "SamplingGraph"]
