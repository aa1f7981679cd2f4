"""SpMM: sparse (graph) x dense (features) aggregation, in plain PyTorch.

Counterpart of ``cugraph_gnn_tpu/ops/spmm.py``:

1. ``fanout_aggregate`` over the sampler's fixed-fanout blocks (the sampled
   training path);
2. ``segment_spmm``, ``EllBuckets``/``ell_spmm`` and ``csr_spmm`` over whole
   graphs, which the JAX package leaves to XLA.  ``FullBatchGraph`` takes
   them only off the slab path (a graph whose band fraction is below its
   ``min_band_fraction``, or ``reduce='max'``); the slab path's kernels are
   in ``ops/kernels/``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device


def fanout_aggregate(x_neigh, mask, reduce: str = "mean"):
    """Aggregate neighbor features over the fanout axis.

    x_neigh: (S, k, F) gathered neighbor features (padded rows arbitrary).
    mask:    (S, k) bool validity.
    reduce:  'sum' | 'mean' | 'max'; a row with no valid neighbor gives 0.
    Returns (S, F).
    """
    m = mask[..., None]
    if reduce == "sum":
        return torch.where(m, x_neigh, 0).sum(dim=1)
    if reduce == "mean":
        s = torch.where(m, x_neigh, 0).sum(dim=1)
        n = mask.sum(dim=1, keepdim=True).clamp(min=1)
        return s / n.to(s.dtype)
    if reduce == "max":
        neg = torch.finfo(x_neigh.dtype).min
        r = torch.where(m, x_neigh, neg).amax(dim=1)
        return torch.where(mask.any(dim=1, keepdim=True), r, 0)
    raise ValueError(f"unknown reduce {reduce!r}")


def segment_spmm(x, src, dst, num_out: int, reduce: str = "mean",
                 edge_weight: Optional[torch.Tensor] = None):
    """out[d] = reduce over edges e with dst[e] = d of w_e * x[src[e]].

    -1 entries in ``src``/``dst`` are padding and ignored; a row with no
    edge gives 0.  Differentiable in ``x``.  (The JAX version's
    ``indices_are_sorted`` hint has no use for a PyTorch scatter.)
    """
    valid = (src >= 0) & (dst >= 0)
    s = torch.where(valid, src, 0).long()
    d = torch.where(valid, dst, num_out).long()  # pad -> an overflow row
    msgs = x[s]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None].to(msgs.dtype)
    f = x.shape[1]
    if reduce in ("sum", "mean"):
        msgs = torch.where(valid[:, None], msgs, 0)
        out = msgs.new_zeros((num_out + 1, f)).index_add(0, d, msgs)[:num_out]
        if reduce == "mean":
            ones = valid.to(x.dtype)
            cnt = ones.new_zeros(num_out + 1).index_add(0, d, ones)[:num_out]
            out = out / cnt.clamp(min=1)[:, None]
        return out
    if reduce == "max":
        msgs = torch.where(valid[:, None], msgs, torch.finfo(x.dtype).min)
        out = msgs.new_full((num_out + 1, f), -torch.inf).scatter_reduce(
            0, d[:, None].expand(-1, f), msgs, "amax")[:num_out]
        return torch.where(torch.isfinite(out), out, 0)
    raise ValueError(f"unknown reduce {reduce!r}")


class EllBuckets:
    """Host-side preprocessing for :func:`ell_spmm`.

    Rows are partitioned into degree buckets; each bucket stores a dense
    (rows_b, K_b) neighbor matrix (-1 padded).  Rows with degree <= max_k
    give one partial each, reassembled by one row gather (``gather_pos``);
    heavier rows split into ceil(deg / max_k) chunks combined by a small
    scatter.  The arrays equal the JAX package's; they live on ``device``
    (default: the card).
    """

    def __init__(self, indptr, indices, max_k: int = 64, device=None):
        dev = resolve_device(device)
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        n = len(indptr) - 1
        deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
        self.num_rows = n
        self.degrees = torch.as_tensor(np.maximum(deg, 1).astype(np.float32),
                                       device=dev)
        ks = sorted({*range(4, 33, 4), 2, 1, 48, 64, 128, 256})
        ks = [k for k in ks if k <= max_k]
        if not ks or ks[-1] != max_k:
            ks.append(max_k)

        def dense_rows(starts, counts, k):
            """(len(starts), k) neighbor block with -1 pad."""
            offs = starts[:, None] + np.arange(k)[None, :]
            ok = np.arange(k)[None, :] < counts[:, None]
            return np.where(
                ok, indices[np.minimum(offs, len(indices) - 1)], -1
            ).astype(np.int32)

        self.buckets = []
        gather_pos = np.full(n, -1, np.int64)
        pos = 0
        single = deg <= max_k
        for bi, k in enumerate(ks):
            lo = 0 if bi == 0 else ks[bi - 1]
            sel = np.nonzero(single & (deg > lo) & (deg <= k))[0]
            if len(sel) == 0:
                continue
            neigh = dense_rows(indptr[sel].astype(np.int64), deg[sel], k)
            gather_pos[sel] = pos + np.arange(len(sel))
            pos += len(sel)
            self.buckets.append(torch.as_tensor(neigh, device=dev))
        self.gather_pos = torch.as_tensor(gather_pos.astype(np.int32), device=dev)

        heavy = np.nonzero(deg > max_k)[0]
        if len(heavy):
            n_chunks = -(-deg[heavy] // max_k)
            rows = np.repeat(heavy, n_chunks).astype(np.int64)
            ci = np.concatenate([np.arange(c) for c in n_chunks])
            starts = indptr[rows].astype(np.int64) + ci * max_k
            counts = np.minimum(deg[rows] - ci * max_k, max_k)
            self.heavy_neigh = torch.as_tensor(dense_rows(starts, counts, max_k),
                                               device=dev)
            self.heavy_rows = torch.as_tensor(rows, device=dev)
        else:
            self.heavy_neigh = None
            self.heavy_rows = None


def ell_spmm(buckets: EllBuckets, x, reduce: str = "sum"):
    """out[r] = reduce over CSR row r of x[cols], via degree buckets
    ('sum' | 'mean' | 'max'; a row with no edge gives 0).  Each bucket
    reduces a (R, K, F) gather.  (The JAX version accumulates buckets of
    width <= 4 column by column, an XLA fusion choice; the result is the
    same.)  Differentiable in ``x``."""
    if reduce not in ("sum", "mean", "max"):
        raise ValueError(f"unknown reduce {reduce!r}")
    f = x.shape[1]
    neg = torch.finfo(x.dtype).min
    fill = neg if reduce == "max" else 0

    def bucket_partial(neigh):
        mask = (neigh >= 0)[..., None]
        xn = x[neigh.clamp(min=0).long()]
        if reduce == "max":
            return torch.where(mask, xn, neg).amax(dim=1)
        return torch.where(mask, xn, 0).sum(dim=1)

    parts = [bucket_partial(nb) for nb in buckets.buckets]
    cat = torch.cat(parts) if parts else x.new_zeros((1, f))
    gp = buckets.gather_pos
    out = torch.where((gp >= 0)[:, None], cat[gp.clamp(min=0).long()], fill)
    if buckets.heavy_neigh is not None:
        hp = bucket_partial(buckets.heavy_neigh)
        if reduce == "max":
            out = out.index_reduce(0, buckets.heavy_rows, hp, "amax")
        else:
            out = out.index_add(0, buckets.heavy_rows, hp)
    if reduce == "mean":
        out = out / buckets.degrees[:, None]
    if reduce == "max":
        out = torch.where(out == neg, 0, out)
    return out


def csr_spmm(indptr, indices, x, reduce: str = "mean",
             edge_weight: Optional[torch.Tensor] = None):
    """out[r] = reduce over CSR row r of w * x[indices]: the CSR expanded to
    destination-sorted COO, then :func:`segment_spmm`."""
    n = indptr.shape[0] - 1
    e = indices.shape[0]
    row_of_edge = (torch.searchsorted(
        indptr, torch.arange(e, dtype=indptr.dtype, device=indptr.device),
        right=True) - 1).to(torch.int32)
    return segment_spmm(x, indices, row_of_edge, n, reduce=reduce,
                        edge_weight=edge_weight)
