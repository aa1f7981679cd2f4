"""Fused uniform neighbor sampler: a CUDA kernel for Hopper.

Replaces ``cugraph_gnn_tpu/ops/pallas/sample_kernel.py::window_select_neighbors``
(the neighbor-id read, for rows of degree <= 128) and fuses in
``ops/sample.py::floyd_positions``: one launch maps (seed, u) to the
neighbors, edge ids and counts, at any degree.  Source:
``csrc/uniform_sample.cu``, whose header says what bounds it on the H100
(~176 bytes a seed counted at 4 bytes a read, but the random reads move
32-byte sectors and wait on each other) and what the design does about it:
a group of k lanes a seed (k <= 32), so that the uniforms and the output rows
move as contiguous spans and small batches still fill the card; one thread a
seed beyond k = 32.

``fused_uniform_sample`` runs the kernel for CUDA tensors and the plain
version, ``fused_uniform_sample_ref``, for CPU tensors;
``fused_uniform_sample.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from cugraph_gnn_tpu_torch import _build
from cugraph_gnn_tpu_torch.ops.sample import SampleOutput, empty_output, floyd_positions

# indptr, n_nodes, indices, seeds, u, neighbors, edge_ids, num_sampled,
# num_seeds, k, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]


def fused_uniform_sample_ref(indptr, indices, seeds, u, fanout: int) -> SampleOutput:
    """Plain PyTorch version of :func:`fused_uniform_sample`."""
    if indices.shape[0] == 0:
        return empty_output(seeds.shape[0], fanout, seeds.device)
    n = indptr.shape[0] - 1
    valid = seeds >= 0
    safe = seeds.long().clamp(min=0)
    start = indptr[safe.clamp(max=n)]
    deg = indptr[(safe + 1).clamp(max=n)] - start
    pos = floyd_positions(u, deg, fanout)
    keep = (pos >= 0) & valid[:, None]
    edge_ids = torch.where(keep, start[:, None] + pos, -1)
    neighbors = torch.where(keep, indices[edge_ids.clamp(min=0).long()], -1)
    num = torch.where(valid, torch.clamp(deg, max=fanout), 0)
    return SampleOutput(neighbors.to(torch.int32), edge_ids.to(torch.int32),
                        num.to(torch.int32))


def fused_uniform_sample(indptr, indices, seeds, u, fanout: int) -> SampleOutput:
    """One-hop uniform sampling without replacement, Floyd positions and
    neighbor-id read fused.

    indptr (N+1,), indices (E,), seeds (S,) int32 (-1 = padding); u (S,
    fanout) float32 uniforms.  Returns a SampleOutput of int32 tensors.  CUDA
    tensors launch the kernel on the current stream without synchronising;
    CPU tensors run :func:`fused_uniform_sample_ref`.
    """
    tensors = {"indptr": indptr, "indices": indices, "seeds": seeds}
    for name, t in tensors.items():
        if t.dim() != 1 or t.dtype != torch.int32:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
    if fanout < 0:
        raise ValueError(f"fanout must be >= 0, got {fanout}")
    if u.dtype != torch.float32 or tuple(u.shape) != (seeds.shape[0], fanout):
        raise TypeError(f"u must be float32 of shape {(seeds.shape[0], fanout)}, "
                        f"got {u.dtype} {tuple(u.shape)}")
    if indptr.shape[0] < 1:
        raise ValueError("indptr needs at least one entry")
    if any(t.device != seeds.device for t in (indptr, indices, u)):
        raise ValueError("indptr, indices, seeds and u must share a device")
    if seeds.device.type == "cpu":
        return fused_uniform_sample_ref(indptr, indices, seeds, u, fanout)
    if seeds.device.type != "cuda":
        raise ValueError(f"no kernel for device {seeds.device}")
    if not all(t.is_contiguous() for t in (indptr, indices, seeds, u)):
        raise ValueError("indptr, indices, seeds and u must be contiguous")
    s = seeds.shape[0]
    if indices.shape[0] == 0:
        return empty_output(s, fanout, seeds.device)
    out = SampleOutput(
        torch.empty((s, fanout), dtype=torch.int32, device=seeds.device),
        torch.empty((s, fanout), dtype=torch.int32, device=seeds.device),
        torch.empty((s,), dtype=torch.int32, device=seeds.device))
    if s == 0:
        return out
    fn = _build.function("uniform_sample", _ARGTYPES)
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(indptr.data_ptr(), indptr.shape[0] - 1, indices.data_ptr(),
                    seeds.data_ptr(), u.data_ptr(), out.neighbors.data_ptr(),
                    out.edge_ids.data_ptr(), out.num_sampled.data_ptr(), s,
                    fanout, stream)
    _build.check(status, "uniform_sample")
    fused_uniform_sample.launches += 1
    return out


fused_uniform_sample.launches = 0
