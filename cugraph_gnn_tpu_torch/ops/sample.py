"""Uniform neighbor sampling without replacement (Floyd's algorithm).

Counterpart of ``cugraph_gnn_tpu/ops/sample.py`` (uniform sampling only; the
weighted and temporal samplers come with a later slice).  Outputs keep the
fixed-fanout layout: ``(S, k)`` int32 blocks padded with -1.

The JAX version draws its uniforms inside ``uniform_sample``; here they are an
optional input ``u``, so that a test can replay the JAX draws exactly.  The
TPU line-window gather (``ops/window_gather.py``) is not ported: the CUDA
kernel in ``ops/kernels/sample_kernel.py`` reads the neighbor ids directly and
gives the same neighbors, edge ids and counts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device


class SampleOutput(NamedTuple):
    """One-hop sample in fixed-fanout layout.

    neighbors: (S, k) int32 neighbor node ids, -1 padded.
    edge_ids:  (S, k) int32 positions in the CSR ``indices`` array, -1 padded.
    num_sampled: (S,) int32 valid count per seed, min(degree, k).
    """

    neighbors: torch.Tensor
    edge_ids: torch.Tensor
    num_sampled: torch.Tensor


def floyd_positions(u, degrees, fanout: int):
    """Select ``fanout`` distinct positions in [0, degree) per row.

    u: (S, fanout) float32 uniforms in [0, 1).  degrees: (S,) int.
    Returns (S, fanout) int32 positions, -1 where i >= degree.

    For i in 0..k-1 with m = d-k+i, draw t = floor(u_i * (m+1)) clipped to
    [0, m]; take m if t is already taken, else t.  Rows with d <= k take every
    position in order.
    """
    s, k = u.shape[0], fanout
    d = degrees.to(torch.int32)
    sel = torch.full((s, k), -1, dtype=torch.int32, device=u.device)
    for i in range(k):
        m = d - k + i
        t = torch.floor(u[:, i] * (m + 1).to(u.dtype)).to(torch.int32)
        t = torch.minimum(t.clamp(min=0), m.clamp(min=0))
        dup = (sel == t[:, None]).any(dim=1)
        sel[:, i] = torch.where(dup, m, t)
    iota = torch.arange(k, dtype=torch.int32, device=u.device).expand(s, k)
    small = torch.where(iota < d[:, None], iota, -1)
    return torch.where((d <= k)[:, None], small, sel)


def floyd_positions_np(u, degrees, fanout: int):
    """Host reference for :func:`floyd_positions` (same draws, plain loops)."""
    u = np.asarray(u)
    degrees = np.asarray(degrees)
    s, k = u.shape[0], fanout
    out = np.full((s, k), -1, dtype=np.int32)
    for r in range(s):
        d = int(degrees[r])
        if d <= k:
            out[r, :d] = np.arange(d)
            continue
        sel = []
        for i in range(k):
            m = d - k + i
            t = min(int(u[r, i] * (m + 1)), m)
            sel.append(m if t in sel else t)
        out[r] = sel
    return out


def uniform_sample(indptr, indices, seeds, fanout: int, *, u=None,
                   generator=None, device=None) -> SampleOutput:
    """One-hop uniform neighbor sampling without replacement.

    indptr (N+1,), indices (E,), seeds (S,): int32 tensors or arrays; a seed
    of -1 is padding and gives -1 / -1 / 0.  u: optional (S, fanout) float32
    uniforms; drawn with ``torch.rand(generator=generator)`` when None.
    Runs on ``device`` (default: the card), through the fused CUDA sampler
    there.
    """
    # the kernel module builds on floyd_positions above
    from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import fused_uniform_sample

    dev = resolve_device(device)
    indptr = torch.as_tensor(indptr, dtype=torch.int32, device=dev)
    indices = torch.as_tensor(indices, dtype=torch.int32, device=dev)
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=dev)
    if u is None:
        u = torch.rand((seeds.shape[0], fanout), generator=generator,
                       device=dev)
    else:
        u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    return fused_uniform_sample(indptr, indices, seeds, u, fanout)
