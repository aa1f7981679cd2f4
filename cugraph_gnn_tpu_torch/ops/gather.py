"""Row gather/scatter over feature matrices, in plain PyTorch.

Counterpart of ``cugraph_gnn_tpu/ops/gather.py``.  The hand-written CUDA row
gather that the training path runs is ``ops/kernels/gather_kernel.py``; these
functions are its plain version and the general-purpose forms.
"""

from __future__ import annotations

import torch


def local_gather(table, ids, *, out_dtype=None, fill=0):
    """out[i] = table[ids[i]] converted to ``out_dtype``; ids < 0 give a
    ``fill`` row.  Ids past the last row read the last row, as XLA's gather
    clamps them."""
    valid = ids >= 0
    rows = table[ids.clamp(0, table.shape[0] - 1).long()]
    if out_dtype is not None and rows.dtype != out_dtype:
        rows = rows.to(out_dtype)
    return torch.where(valid[..., None], rows,
                       torch.tensor(fill, dtype=rows.dtype, device=rows.device))


def local_scatter(table, ids, rows):
    """A copy of ``table`` with table[ids[i]] = rows[i]; negative ids skipped.
    Which of several rows written to one id wins is unspecified."""
    n = table.shape[0]
    # invalid ids write a spare row past the end, never a real one
    safe = torch.where(ids >= 0, ids, n).long()
    out = torch.cat([table, table.new_zeros((1, *table.shape[1:]))])
    out.index_copy_(0, safe, rows.to(table.dtype))
    return out[:n]


def local_scatter_add(table, ids, rows):
    """A copy of ``table`` with table[ids[i]] += rows[i]; negative ids
    skipped."""
    valid = ids >= 0
    rows = torch.where(valid[..., None], rows.to(table.dtype), 0)
    return table.index_add(0, torch.where(valid, ids, 0).long(), rows)
