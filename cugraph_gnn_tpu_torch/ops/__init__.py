"""Graph ops: row gather, neighbor sampling, fixed-fanout aggregation, CSR
utilities."""

from cugraph_gnn_tpu_torch.ops.csr import (
    CSR,
    coo_to_csr,
    coo_to_csr_np,
    csr_add_self_loop,
    edge_mask_valid,
)

__all__ = ["CSR", "coo_to_csr", "coo_to_csr_np", "csr_add_self_loop", "edge_mask_valid"]
