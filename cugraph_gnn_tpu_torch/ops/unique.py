"""Sort-based append-unique renumbering with static shapes.

Counterpart of ``cugraph_gnn_tpu/ops/unique.py``: given target (seed) nodes
and raw neighbor nodes, a unique node list whose first ``len(targets)``
entries are the targets in order, followed by the new neighbors sorted
ascending, and for every raw neighbor its position in that list.

Every output has a size fixed by the inputs' and ``max_unique``: the unique
values are found by a sort, a first-occurrence mask and a ``cumsum`` into a
buffer of ``max_unique - len(targets)`` slots, never by ``torch.unique`` or a
``nonzero`` without a size, so that a batch never waits on the host.  Unused
slots hold -1 and the count is returned beside them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_FILL = 2**31 - 1   # sorts after every node id


class AppendUniqueOutput(NamedTuple):
    unique_nodes: torch.Tensor   # (max_unique,) int32, -1 padded
    num_unique: torch.Tensor     # () int32, valid prefix length
    neighbor_map: torch.Tensor   # raw neighbors -> index into unique_nodes


def _unique_sorted(values: torch.Tensor, size: int) -> torch.Tensor:
    """The ``size`` smallest distinct entries of ``values`` in ascending
    order, padded with ``_FILL`` (``jnp.unique(size=, fill_value=)``)."""
    out = torch.full((size + 1,), _FILL, dtype=torch.int32, device=values.device)
    v = torch.sort(values).values
    first = torch.ones_like(v, dtype=torch.bool)
    first[1:] = v[1:] != v[:-1]
    pos = torch.cumsum(first, 0) - 1
    # later occurrences and values past the budget go to the spare slot
    dest = torch.where(first & (pos < size), pos, size)
    out.scatter_(0, dest, v)
    return out[:size]


def append_unique(targets, neighbors, *, max_unique: int) -> AppendUniqueOutput:
    """targets: (T,) unique node ids; neighbors: (R,) ids, -1 padding and
    duplicates allowed.  max_unique: the static output size (T + R is
    always enough; a smaller budget drops the largest new ids).

    Returns the unique list [targets..., new neighbors ascending...] cut to
    ``max_unique`` and, for every raw neighbor, its position in that list
    (-1 for padding and for new ids past the budget).
    """
    t = targets.shape[0]
    targets = targets.to(torch.int32)
    neighbors = neighbors.to(torch.int32)

    # each value's index among the targets, -1 when it is none of them
    t_sorted, t_rank = torch.sort(targets, stable=True)
    is_pad = neighbors < 0
    if t:
        pos = torch.searchsorted(t_sorted, neighbors).clamp(0, t - 1)
        tgt_idx = torch.where(t_sorted[pos] == neighbors, t_rank[pos], -1)
    else:
        tgt_idx = torch.full_like(neighbors, -1)
    is_new = (tgt_idx < 0) & ~is_pad

    budget = max(max_unique - t, 1)
    uniq = _unique_sorted(torch.where(is_new, neighbors, _FILL), budget)
    valid_new = uniq != _FILL
    num_new = valid_new.sum(dtype=torch.int32)
    uniq_clean = torch.where(valid_new, uniq, -1)

    unique_nodes = torch.cat([targets, uniq_clean])[:max_unique]
    num_unique = (t + num_new).to(torch.int32)

    new_pos = torch.searchsorted(uniq, neighbors).clamp(0, budget - 1)
    new_ok = (uniq[new_pos] == neighbors) & is_new
    neighbor_map = torch.where(
        is_pad, -1, torch.where(tgt_idx >= 0, tgt_idx,
                                torch.where(new_ok, t + new_pos, -1)))
    return AppendUniqueOutput(unique_nodes, num_unique,
                              neighbor_map.to(torch.int32))


def append_unique_rows(targets, neighbors, *, max_unique: int) -> AppendUniqueOutput:
    """:func:`append_unique` for every row at once: targets (B, T) (-1 pads
    allowed: they match nothing), neighbors (B, R).  Row b's output is
    ``append_unique(targets[b], neighbors[b], max_unique=max_unique)``:
    unique_nodes (B, max_unique), num_unique (B,), neighbor_map (B, R) with
    positions inside the row.

    Each value is keyed ``row * 2**32 + node`` (int64), so one sort, one
    first-occurrence mask and one scatter serve every row, each in its own
    namespace: no loop over rows.
    """
    b, t = targets.shape
    r = neighbors.shape[1]
    dev = targets.device
    tg = targets.to(torch.int64)
    nb = neighbors.to(torch.int64)
    row_n = torch.arange(b, device=dev)[:, None] << 32
    key_n = row_n | nb.clamp(min=0)                        # (B, R)
    is_pad = nb < 0

    # each neighbor's index among its row's targets, -1 when none
    key_t = torch.where(tg >= 0, (torch.arange(b, device=dev)[:, None] << 32) | tg, -1)
    t_sorted, t_rank = torch.sort(key_t.reshape(-1), stable=True)
    if t:
        pos = torch.searchsorted(t_sorted, key_n.reshape(-1)).clamp(max=b * t - 1)
        hit = (t_sorted[pos] == key_n.reshape(-1)).view(b, r) & ~is_pad
        tgt_idx = torch.where(hit, (t_rank[pos] % t).view(b, r), -1)
    else:
        hit = torch.zeros_like(is_pad)
        tgt_idx = torch.full_like(nb, -1)
    is_new = ~hit & ~is_pad

    # the new values of each row, ascending, cut to the row's budget; a row's
    # free slots hold its own fill key, so the flat buffer stays sorted
    budget = max(max_unique - t, 1)
    fill = row_n | _FILL
    v = torch.sort(torch.where(is_new, key_n, fill).reshape(-1)).values
    first = torch.ones_like(v, dtype=torch.bool)
    first[1:] = v[1:] != v[:-1]
    first &= (v & 0xFFFFFFFF) != _FILL
    row_v = v >> 32
    per_row = torch.zeros(b, dtype=torch.int64, device=dev).index_add_(0, row_v, first.long())
    rank = torch.cumsum(first, 0) - 1 - (torch.cumsum(per_row, 0) - per_row)[row_v]
    dest = torch.where(first & (rank < budget), row_v * budget + rank, b * budget)
    flat = torch.cat([fill.expand(b, budget).reshape(-1), v.new_zeros(1)])
    flat.scatter_(0, dest, v)
    flat = flat[:b * budget]
    uniq = flat.view(b, budget)
    valid_new = (uniq & 0xFFFFFFFF) != _FILL
    uniq_clean = torch.where(valid_new, uniq & 0xFFFFFFFF, -1).to(torch.int32)
    unique_nodes = torch.cat([targets.to(torch.int32), uniq_clean], dim=1)[:, :max_unique]
    num_unique = (t + valid_new.sum(dim=1)).to(torch.int32)

    new_pos = torch.searchsorted(flat, key_n.reshape(-1)).view(b, r)
    new_ok = (flat[new_pos.clamp(max=b * budget - 1)] == key_n) & is_new
    local = new_pos - torch.arange(b, device=dev)[:, None] * budget
    neighbor_map = torch.where(tgt_idx >= 0, tgt_idx, torch.where(new_ok, t + local, -1))
    return AppendUniqueOutput(unique_nodes, num_unique, neighbor_map.to(torch.int32))


def append_unique_np(targets, neighbors):
    """Host reference (ragged, exact): the unique list and the map of the
    non-padding neighbors, as int64 arrays."""
    targets = np.asarray(targets)
    neighbors = np.asarray(neighbors)
    neighbors = neighbors[neighbors >= 0]
    extra = np.unique(neighbors[~np.isin(neighbors, targets)])
    unique_nodes = np.concatenate([targets, np.sort(extra)]).astype(np.int64)
    lookup = {int(v): i for i, v in enumerate(unique_nodes)}
    neighbor_map = np.array([lookup[int(v)] for v in neighbors], dtype=np.int64)
    return unique_nodes, neighbor_map
