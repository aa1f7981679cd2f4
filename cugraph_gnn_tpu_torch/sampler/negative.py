"""Negative edge sampling for link prediction.

Counterpart of ``cugraph_gnn_tpu/sampler/negative.py``: ``binary`` mode draws
extra (src, dst) corruption pairs, ``triplet`` mode corrupted destinations
for given sources; draws are uniform over the node range or proportional to
``src_weight`` / ``dst_weight``.  Optional rejection of true edges re-draws a
colliding destination once and marks a pair that still collides (-1, -1);
optional temporal rejection re-draws a destination newer than its seed time
up to ``time_retries`` times and marks the survivors -1.

The draws come from a ``torch.Generator``: ``torch.randint`` for uniform
draws, ``torch.multinomial(replacement=True)`` for weighted ones (the
distribution of ``jax.random.categorical`` over log-weights).  They can also
be passed in (``NegativeDraws``), so that tests replay the JAX draws.

The true-edge table is one sorted int64 key per edge, ``src * 2**32 + dst``,
searched with ``torch.searchsorted``; the JAX package keeps two int32
columns and runs a lexicographic binary search (the TPU has no native
int64).  Both find the same pairs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device

_KEY_SHIFT = 32


class NegativeSampling(NamedTuple):
    """PyG-compatible configuration: ``mode`` 'binary' | 'triplet', negatives
    per positive, optional per-node draw weights."""

    mode: str = "binary"
    amount: float = 1.0
    src_weight: Optional[torch.Tensor] = None
    dst_weight: Optional[torch.Tensor] = None


class NegativeDraws(NamedTuple):
    """The candidates of one ``sample_negative_edges`` call, (count,) int32
    each: initial sources (unused when sources are pinned), initial
    destinations, the true-edge rejection's re-draw, and the temporal
    re-draws (time_retries, count)."""

    src: Optional[torch.Tensor]
    dst: torch.Tensor
    dst2: Optional[torch.Tensor] = None
    time_redraws: Optional[torch.Tensor] = None


def _weighted_choice(n, shape, weight, generator, device) -> torch.Tensor:
    if weight is None:
        return torch.randint(0, n, shape, generator=generator, device=device,
                             dtype=torch.int32)
    w = torch.as_tensor(weight, dtype=torch.float32, device=device).clamp(min=1e-30)
    count = int(np.prod(shape))
    if count == 0:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    out = torch.multinomial(w, count, replacement=True, generator=generator)
    return out.reshape(shape).to(torch.int32)


def draw_candidates(num_src: int, num_dst: int, count: int, config: NegativeSampling, *,
                    pinned_src: bool = False, rejection: bool = False,
                    time_retries: int = 0, generator=None, device=None) -> NegativeDraws:
    """Draw what one ``sample_negative_edges`` call consumes from
    ``generator`` on ``device`` (default: the card): sources unless pinned,
    destinations, the rejection's re-draw when ``rejection``, and
    ``time_retries`` rows of temporal re-draws."""
    dev = resolve_device(device)
    src = None if pinned_src else _weighted_choice(num_src, (count,), config.src_weight,
                                                   generator, dev)
    dst = _weighted_choice(num_dst, (count,), config.dst_weight, generator, dev)
    redraws = (_weighted_choice(num_dst, (time_retries, count), config.dst_weight,
                                generator, dev) if time_retries else None)
    dst2 = (_weighted_choice(num_dst, (count,), config.dst_weight, generator, dev)
            if rejection else None)
    return NegativeDraws(src, dst, dst2, redraws)


def _pack(src, dst) -> torch.Tensor:
    return (src.to(torch.int64) << _KEY_SHIFT) + dst.to(torch.int64)


def make_edge_key_sorted(src, dst, num_dst: int = 0, *, device=None) -> torch.Tensor:
    """The true edges' sorted int64 keys ``src * 2**32 + dst``, (E,), on
    ``device`` (default: the card).  ``num_dst`` is kept for the JAX
    signature; every int32 pair packs exactly."""
    key = np.sort((np.asarray(src).astype(np.int64) << _KEY_SHIFT)
                  + np.asarray(dst).astype(np.int64))
    return torch.as_tensor(key, device=resolve_device(device))


def edge_key_pairs(keys: torch.Tensor):
    """The (src, dst) int32 columns of packed keys (the JAX table's form)."""
    return ((keys >> _KEY_SHIFT).to(torch.int32),
            (keys & 0xFFFFFFFF).to(torch.int32))


def is_edge(edge_key_sorted: torch.Tensor, s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Whether each (s, d) is a true edge; never for s < 0 or d < 0."""
    key = _pack(s, d.clamp(min=0))
    pos = torch.searchsorted(edge_key_sorted, key).clamp(max=edge_key_sorted.numel() - 1)
    return (edge_key_sorted[pos] == key) & (s >= 0) & (d >= 0)


def sample_negative_edges(num_src: int, num_dst: int, count: int,
                          config: NegativeSampling,
                          edge_key_sorted: Optional[torch.Tensor] = None,
                          node_time=None, seed_time=None, time_retries: int = 10,
                          src=None, *, draws: Optional[NegativeDraws] = None,
                          generator=None, device=None):
    """``count`` negative (src, dst) int32 pairs on ``device`` (default: the
    card).

    edge_key_sorted: optional true-edge table (``make_edge_key_sorted``); a
    pair that is a true edge gets its destination re-drawn once, and is
    marked (-1, -1) if it still is one.  node_time / seed_time: a
    destination d of a pair with seed time t must have node_time[d] <= t;
    violators are re-drawn ``time_retries`` times and then marked -1 (the
    source too).  src: optional pinned sources (triplet mode); the
    rejection tests the actual pairs.  draws: the candidates, else drawn
    from ``generator`` (``draw_candidates``).
    """
    dev = resolve_device(device)
    temporal = node_time is not None and seed_time is not None
    if edge_key_sorted is not None and edge_key_sorted.numel() == 0:
        edge_key_sorted = None   # an empty table: no rejection
    if draws is None:
        draws = draw_candidates(num_src, num_dst, count, config, pinned_src=src is not None,
                                rejection=edge_key_sorted is not None,
                                time_retries=time_retries if temporal else 0,
                                generator=generator, device=dev)
    src = draws.src if src is None else src
    src = torch.as_tensor(src, device=dev).to(torch.int32)
    dst = torch.as_tensor(draws.dst, device=dev).to(torch.int32)
    if temporal:
        node_time = torch.as_tensor(node_time, device=dev)
        seed_time = torch.as_tensor(seed_time, device=dev).broadcast_to((count,))
        redraws = torch.as_tensor(draws.time_redraws, device=dev).to(torch.int32)
        for r in range(time_retries):
            bad = node_time[dst.long()] > seed_time
            dst = torch.where(bad, redraws[r], dst)
        dst = torch.where(node_time[dst.long()] > seed_time, -1, dst)
        src = torch.where(dst < 0, -1, src)
    if edge_key_sorted is not None:
        hit = is_edge(edge_key_sorted, src, dst)
        dst2 = torch.as_tensor(draws.dst2, device=dev).to(torch.int32)
        if temporal:
            hit = hit & (node_time[dst2.long()] <= seed_time)
        dst = torch.where(hit, dst2, dst)
        still = is_edge(edge_key_sorted, src, dst)
        src = torch.where(still, -1, src)
        dst = torch.where(still, -1, dst)
    return src, dst


def neg_cat(pos, neg, batch_size: int):
    """[pos batch 0 | neg batch 0 | pos batch 1 | neg batch 1 | ...] with
    ``batch_size`` positives a batch and the negatives split evenly over the
    batches (earlier batches take the extra element of an uneven split)."""
    pos = torch.as_tensor(pos)
    neg = torch.as_tensor(neg, device=pos.device)
    n_pos = pos.shape[0]
    n_batches = -(-n_pos // batch_size) if batch_size else 1
    if n_batches <= 1:
        return torch.cat([pos, neg])
    parts = zip(torch.tensor_split(pos, n_batches), torch.tensor_split(neg, n_batches))
    return torch.cat([x for pn in parts for x in pn])
