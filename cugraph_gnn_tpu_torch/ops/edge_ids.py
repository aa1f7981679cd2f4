"""64-bit global edge ids as int32 (hi, lo) planes.

Counterpart of ``cugraph_gnn_tpu/ops/edge_ids.py``.  A global edge id is
``hi * 2**30 + lo`` with ``lo`` in [0, 2**30); a pad is (0, -1).  Each shard
keeps its edge positions below 2**30 and splits its int64 base on the host;
``combine_local`` adds base and position with one explicit carry, so every
intermediate stays inside int32.  The card has native int64, but the planes
are kept so that sampled batches carry the same two int32 tensors as the JAX
package's (``sampler/output.py``: ``edge_ids`` and ``edge_hi``).
"""

from __future__ import annotations

import numpy as np
import torch

EDGE_LO_BITS = 30
EDGE_LO_MOD = 1 << EDGE_LO_BITS  # 2**30
EDGE_LO_MASK = EDGE_LO_MOD - 1
# per-shard local edge positions must stay below the lo modulus
MAX_LOCAL_EDGES = EDGE_LO_MOD


def split_bases_np(bases) -> np.ndarray:
    """Host: int64 shard bases -> (W, 2) int32 [hi, lo] planes."""
    bases = np.asarray(bases, dtype=np.int64)
    hi = (bases >> EDGE_LO_BITS).astype(np.int32)
    lo = (bases & EDGE_LO_MASK).astype(np.int32)
    return np.stack([hi, lo], axis=1)


def combine_local(local_eid, base_hi, base_lo):
    """Shard-local edge position + split base -> (hi, lo) int32 tensors.

    local_eid: int32 tensor in [0, 2**30), negative = pad.  base_hi /
    base_lo: this shard's split base (ints or 0-d tensors).  Pads come out
    as (0, -1).
    """
    local_eid = torch.as_tensor(local_eid, dtype=torch.int32)
    valid = local_eid >= 0
    lo = torch.where(valid, local_eid, 0) + int(base_lo)
    hi = int(base_hi) + (lo >> EDGE_LO_BITS)
    lo = lo & EDGE_LO_MASK
    return (torch.where(valid, hi, 0).to(torch.int32),
            torch.where(valid, lo, -1).to(torch.int32))


def to_int64_np(hi, lo) -> np.ndarray:
    """Host: (hi, lo) planes -> int64 global edge ids (-1 pad kept)."""
    hi = np.asarray(hi, dtype=np.int64)
    lo = np.asarray(lo, dtype=np.int64)
    out = hi * EDGE_LO_MOD + lo
    return np.where(lo < 0, np.int64(-1), out)


def from_int64_np(gids) -> tuple:
    """Host: int64 global edge ids -> (hi, lo) int32 planes (-1 pad kept
    as (0, -1))."""
    gids = np.asarray(gids, dtype=np.int64)
    valid = gids >= 0
    hi = np.where(valid, gids >> EDGE_LO_BITS, 0).astype(np.int32)
    lo = np.where(valid, gids & EDGE_LO_MASK, -1).astype(np.int32)
    return hi, lo
