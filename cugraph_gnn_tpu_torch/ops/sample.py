"""Neighbor sampling without replacement: uniform (Floyd's algorithm), and
weighted (Gumbel top-k) or time-masked (bottom-k of uniform keys) over a
neighborhood.

Counterpart of ``cugraph_gnn_tpu/ops/sample.py``.  Outputs keep the
fixed-fanout layout: ``(S, k)`` int32 blocks padded with -1.

The JAX version draws its uniforms inside ``uniform_sample``; here they are an
optional input ``u``, so that a test can replay the JAX draws exactly.  The
TPU line-window gather (``ops/window_gather.py``) is not ported: the CUDA
kernel in ``ops/kernels/sample_kernel.py`` reads the neighbor ids directly and
gives the same neighbors, edge ids and counts.

The key-based samplers score every edge with a counter-based hash of its id
(:func:`edge_uniform`) under two 32-bit key words, the JAX key's last two
words; here the words are an optional input ``hash_key``, as ``u`` is.  JAX
streams each neighborhood in chunks through a running ``lax.top_k``, which
keeps the k best scores with the lower position first among equal ones.  The
port scores the hop's edges in one flat pass and takes each row's k best by
one stable sort of ``(row, score descending)`` keys: the same positions in
the same order, with the loop bound by the hop's own edges (one host read of
their count per hop) instead of ``max_degree`` for every seed.
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


def empty_output(num_seeds: int, fanout: int, device) -> SampleOutput:
    """Output for a graph with no edges (JAX ``_empty_output``)."""
    return SampleOutput(
        torch.full((num_seeds, fanout), -1, dtype=torch.int32, device=device),
        torch.full((num_seeds, fanout), -1, dtype=torch.int32, device=device),
        torch.zeros((num_seeds,), dtype=torch.int32, device=device))


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


# ---------------------------------------------------------------------------
# Key-based sampling (weighted / temporal)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_TINY = 1.1754944e-38       # the smallest normal float32
_FLAT_EDGES = 1 << 27       # edges scored in one pass; more split the seeds


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant c,
    by c's 16-bit halves, so that no intermediate reaches 2**49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def threefry_hash(x, k0, k1):
    """The JAX package's ``_threefry_hash`` of uint32 ``x`` under the key words
    (k0, k1), computed in int64: the uint32 wrap is a mask after every step.
    x: int tensor of values in [0, 2**32); k0, k1: int64 tensors that
    broadcast against it.  Returns int64 values in [0, 2**32)."""
    x = x.to(torch.int64) & _MASK32
    x = _mul32(x ^ k0, 0x9E3779B1)
    x = _mul32(x ^ (x >> 16), 0x85EBCA77)
    x = x ^ k1
    x = _mul32(x ^ (x >> 13), 0xC2B2AE3D)
    return x ^ (x >> 16)


def edge_uniform(edge_ids, k0, k1):
    """Counter-based per-edge uniforms in [0, 1) on a 2**-24 grid: the top 24
    bits of :func:`threefry_hash`.  Deterministic in (key, edge id), so a
    layout or chunking never changes them."""
    bits = threefry_hash(edge_ids, k0, k1)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def edge_uniform_np(hash_key, edge_ids):
    """NumPy mirror of :func:`edge_uniform` for host references; hash_key =
    (k0, k1)."""
    k0, k1 = (np.uint32(k) for k in np.asarray(hash_key).astype(np.int64))
    x = np.asarray(edge_ids).astype(np.uint32)
    with np.errstate(over="ignore"):
        x = (x ^ k0) * np.uint32(0x9E3779B1)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA77)
        x = x ^ k1
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE3D)
        x = x ^ (x >> np.uint32(16))
    return (x >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))


def gumbel_from_uniform(u):
    """Standard Gumbel noise -log(-log(u)), u clamped away from 0."""
    return -torch.log(-torch.log(torch.clamp(u, min=_TINY)))


def _edge_uniforms(hash_key, num_seeds: int, generator, device):
    """(edge ids, rows) -> :func:`edge_uniform` under the key words: one pair
    (k0, k1), or (S, 2), one pair per seed (row); drawn from ``generator``
    when ``hash_key`` is None."""
    if hash_key is None:
        k = torch.randint(0, 1 << 32, (2,), generator=generator, device=device,
                          dtype=torch.int64)
    elif isinstance(hash_key, torch.Tensor):
        k = hash_key.to(device=device, dtype=torch.int64) & _MASK32
    else:
        k = torch.as_tensor(np.asarray(hash_key).astype(np.int64) & _MASK32,
                            device=device)
    if k.shape not in ((2,), (num_seeds, 2)):
        raise ValueError(f"hash_key must have shape (2,) or ({num_seeds}, 2), "
                         f"got {tuple(k.shape)}")
    if k.dim() == 1:
        return lambda eids, rows: edge_uniform(eids, k[0], k[1])
    return lambda eids, rows: edge_uniform(eids, k[rows, 0], k[rows, 1])


def _candidates(time_filter, edge_times, seed_time, device):
    """(edge ids, rows) -> whether an edge may be taken: ``time_filter`` of
    its id, or its time no newer than its seed's; None when neither."""
    if time_filter is not None:
        return lambda eids, rows: time_filter(eids)
    if edge_times is None or seed_time is None:
        return None
    edge_times = torch.as_tensor(edge_times, device=device)
    seed_time = torch.as_tensor(seed_time, device=device)
    return lambda eids, rows: edge_times[eids] <= seed_time[rows]


def _descending_key(scores):
    """int64 keys in [0, 2**32) whose ascending order is the float32 scores'
    descending order (-0.0 counted as +0.0; -inf last)."""
    bits = (scores + 0.0).view(torch.int32).to(torch.int64) & _MASK32
    asc = torch.where(bits >= 1 << 31, bits ^ _MASK32, bits | (1 << 31))
    return _MASK32 - asc


def _keyed_topk(score_fn, start, deg, fanout: int):
    """Per row, the positions of the ``fanout`` largest finite scores of its
    ``deg`` edges, in descending score and, among equal scores, ascending
    position (``lax.top_k``'s order); -1 past them.

    score_fn(edge_ids, rows) -> (T,) float32 scores of the flat edges, -inf
    for an edge that may not be taken.  Returns (S, fanout) int32 positions.
    """
    s, dev = start.shape[0], start.device
    out = torch.full((s, fanout), -1, dtype=torch.int32, device=dev)
    cum = torch.cumsum(deg, 0)
    total = int(cum[-1]) if s else 0          # the hop's one host read
    if total == 0 or fanout == 0:
        return out
    bounds = [0, s]
    if total > _FLAT_EDGES:                   # bound one pass's memory
        cum_h = cum.cpu().numpy()
        bounds = [0]
        while bounds[-1] < s:
            before = cum_h[bounds[-1] - 1] if bounds[-1] else 0
            nxt = int(np.searchsorted(cum_h, before + _FLAT_EDGES, side="right"))
            bounds.append(min(max(nxt, bounds[-1] + 1), s))
    slots = torch.arange(fanout, device=dev)
    for a, b in zip(bounds[:-1], bounds[1:]):
        d = deg[a:b]
        n = total if b - a == s else int(d.sum())
        if n == 0:
            continue
        seg = torch.cumsum(d, 0) - d          # each row's first flat edge
        rows = torch.repeat_interleave(torch.arange(b - a, device=dev), d, output_size=n)
        pos = torch.arange(n, device=dev) - seg[rows]
        scores = score_fn(start[a:b][rows] + pos, rows + a)
        # one stable sort by (row, score descending): ties keep position order
        order = torch.sort((rows << 32) | _descending_key(scores), stable=True).indices
        sel = order[(seg[:, None] + slots).clamp(max=n - 1)]
        ok = (slots < d[:, None]) & (scores[sel] > float("-inf"))
        out[a:b] = torch.where(ok, sel - seg[:, None], -1).to(torch.int32)
    return out


def _key_sample(indptr, indices, seeds, fanout, score_fn, max_degree, chunk, dev):
    """The shared body of the key-based samplers: rows, top-k, neighbor read."""
    if indices.shape[0] == 0:
        return empty_output(seeds.shape[0], fanout, dev)
    n = indptr.shape[0] - 1
    valid = seeds >= 0
    safe = seeds.long().clamp(0, n)
    start = indptr[safe].long()
    deg = indptr[(safe + 1).clamp(max=n)].long() - start
    # JAX scans ceil(max_degree / chunk) chunks: positions past them are
    # never seen
    limit = max(-(-int(max_degree) // chunk), 1) * chunk
    deg = torch.where(valid, deg.clamp(max=limit), 0)
    pos = _keyed_topk(score_fn, start, deg, fanout)
    keep = pos >= 0
    edge_ids = torch.where(keep, start[:, None] + pos, -1)
    neighbors = torch.where(keep, indices[edge_ids.clamp(min=0)].to(torch.int64), -1)
    return SampleOutput(neighbors.to(torch.int32), edge_ids.to(torch.int32),
                        keep.sum(dim=1, dtype=torch.int32))


def _graph_tensors(indptr, indices, seeds, dev):
    return tuple(torch.as_tensor(t, dtype=torch.int32, device=dev)
                 for t in (indptr, indices, seeds))


def weighted_sample(indptr, indices, weights, seeds, fanout: int, *, max_degree: int,
                    hash_key=None, generator=None, time_filter=None, chunk: int = 256,
                    edge_times=None, seed_time=None, device=None) -> SampleOutput:
    """Weighted (biased) sampling without replacement by Gumbel top-k: each
    edge scores log(w) + Gumbel noise from :func:`edge_uniform`, an edge of
    weight <= 0 never.  Selection probabilities are those of weighted
    reservoir sampling (A-ExpJ).

    seeds (S,) int32, -1 = padding (-1 / -1 / 0).  hash_key: the key words
    (k0, k1), or (S, 2) per seed; drawn from ``generator`` when None.
    max_degree, chunk: only positions below ceil(max_degree / chunk) * chunk
    of a row are candidates, as in JAX.  time_filter: optional elementwise
    callable (edge ids) -> bool; or edge_times with seed_time (S,): an edge is
    a candidate only when its time is <= its seed's.  Runs on ``device``
    (default: the card).
    """
    dev = resolve_device(device)
    indptr, indices, seeds = _graph_tensors(indptr, indices, seeds, dev)
    weights = torch.as_tensor(weights, device=dev)
    uniform = _edge_uniforms(hash_key, seeds.shape[0], generator, dev)
    mask = _candidates(time_filter, edge_times, seed_time, dev)

    def score_fn(eids, rows):
        g = gumbel_from_uniform(uniform(eids, rows))
        w = weights[eids].to(torch.float32)
        score = torch.where(w > 0, torch.log(torch.clamp(w, min=1e-38)) + g,
                            float("-inf"))
        return score if mask is None else torch.where(mask(eids, rows), score,
                                                      float("-inf"))

    return _key_sample(indptr, indices, seeds, fanout, score_fn, max_degree, chunk, dev)


def masked_uniform_sample(indptr, indices, seeds, fanout: int, *, max_degree: int,
                          hash_key=None, generator=None, time_filter=None,
                          chunk: int = 256, edge_times=None, seed_time=None,
                          device=None) -> SampleOutput:
    """Uniform sampling without replacement restricted to the edges that pass
    ``time_filter``, or whose ``edge_times`` are <= their seed's
    ``seed_time`` (temporal sampling): the k smallest :func:`edge_uniform`
    keys among the candidates.  Arguments as :func:`weighted_sample`."""
    dev = resolve_device(device)
    mask = _candidates(time_filter, edge_times, seed_time, dev)
    if mask is None:
        raise ValueError("need time_filter or (edge_times, seed_time)")
    indptr, indices, seeds = _graph_tensors(indptr, indices, seeds, dev)
    uniform = _edge_uniforms(hash_key, seeds.shape[0], generator, dev)

    def score_fn(eids, rows):
        return torch.where(mask(eids, rows), -uniform(eids, rows), float("-inf"))

    return _key_sample(indptr, indices, seeds, fanout, score_fn, max_degree, chunk, dev)
