"""Utilities: datasets, argparse groups, logging, batching, profiling,
checkpoints and process-group start-up.  Exports what the JAX package's
``utils`` exports."""

from cugraph_gnn_tpu_torch.utils.datasets import Graph, load_karate, random_graph, symmetrize
from cugraph_gnn_tpu_torch.utils import profiling

__all__ = ["Graph", "load_karate", "random_graph", "symmetrize", "profiling"]
