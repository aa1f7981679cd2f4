"""Graph ops: row gather and scatter, neighbor sampling, SpMM and SDDMM,
append-unique, reordering and the full-batch graphs.  Exports what the JAX
package's ``ops`` exports; the kernels behind them are under ``kernels/``."""

from cugraph_gnn_tpu_torch.ops.csr import (
    CSR,
    coo_to_csr,
    coo_to_csr_np,
    csr_add_self_loop,
    edge_mask_valid,
)
from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph, RelationalFullBatch
from cugraph_gnn_tpu_torch.ops.gather import local_gather, local_scatter, local_scatter_add
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
    SlabGraph,
    build_slab_graph,
    slab_spmm,
)
from cugraph_gnn_tpu_torch.ops.reorder import ReorderedGraph, bandwidth_stats, reorder_csr
from cugraph_gnn_tpu_torch.ops.sample import (
    SampleOutput,
    masked_uniform_sample,
    uniform_sample,
    weighted_sample,
)
from cugraph_gnn_tpu_torch.ops.sddmm import (
    coo_edge_softmax,
    coo_sddmm,
    fanout_attention_softmax,
    fanout_sddmm,
)
from cugraph_gnn_tpu_torch.ops.spmm import (
    EllBuckets,
    csr_spmm,
    ell_spmm,
    fanout_aggregate,
    segment_spmm,
)
from cugraph_gnn_tpu_torch.ops.unique import AppendUniqueOutput, append_unique



def __getattr__(name):
    # DistFullBatchGraph is imported at first use: its module imports
    # store.dist_array, which imports ops.kernels, so importing it here
    # would make ``import cugraph_gnn_tpu_torch.store`` circular
    if name == "DistFullBatchGraph":
        from cugraph_gnn_tpu_torch.ops.dist_full_batch import DistFullBatchGraph

        return DistFullBatchGraph
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CSR",
    "DistFullBatchGraph",
    "FullBatchGraph",
    "RelationalFullBatch",
    "ReorderedGraph",
    "SlabGraph",
    "bandwidth_stats",
    "build_slab_graph",
    "reorder_csr",
    "slab_spmm",
    "EllBuckets",
    "ell_spmm",
    "SampleOutput",
    "AppendUniqueOutput",
    "append_unique",
    "coo_to_csr",
    "coo_to_csr_np",
    "csr_add_self_loop",
    "csr_spmm",
    "coo_sddmm",
    "coo_edge_softmax",
    "edge_mask_valid",
    "fanout_aggregate",
    "fanout_attention_softmax",
    "fanout_sddmm",
    "local_gather",
    "local_scatter",
    "local_scatter_add",
    "masked_uniform_sample",
    "segment_spmm",
    "uniform_sample",
    "weighted_sample",
]
