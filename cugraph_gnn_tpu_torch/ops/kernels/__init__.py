"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Counterparts of the Pallas TPU kernels in ``cugraph_gnn_tpu/ops/pallas/``.
"""
