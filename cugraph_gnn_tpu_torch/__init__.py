"""PyTorch and CUDA port of cugraph_gnn_tpu for one NVIDIA H100.

The package mirrors the JAX package's layout (``ops/``, ``sampler/``,
``models/``) so that each module's counterpart is found by its path.  The
kernels that the JAX package writes in Pallas for the TPU are CUDA sources
under ``csrc/``, built with nvcc at first use (``_build.py``); each has a plain
PyTorch version beside its wrapper, which the wrapper runs for CPU tensors.

Entry points run on the card unless the caller passes ``device="cpu"``, and
raise when there is no card: the port never falls back to the CPU unasked.
"""

from cugraph_gnn_tpu_torch.version import __version__

__all__ = ["__version__"]
