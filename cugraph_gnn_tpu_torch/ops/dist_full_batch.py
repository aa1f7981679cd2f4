"""Row-sharded full-batch message passing over ``torch.distributed``.

Counterpart of ``cugraph_gnn_tpu/ops/dist_full_batch.py``.  After the banded
split of the slab path (``ops/kernels/slab_kernel.py``: |col - row| <= R), a
rank owning rows [w*rs, (w+1)*rs) reads only x rows [w*rs - R, (w+1)*rs + R)
for its band edges, so each rank gets ONE R-row halo from each neighbour
(``_halo_exchange``: ``batch_isend_irecv`` with ranks w - 1 and w + 1; the end
ranks get zeros) and runs the single-graph kernels on its rows with a column
offset of R (the ``*_shard`` wrappers).  The fallback edges (off-band,
duplicate, past ``max_k``) are bucketed on the host by destination rank (or,
when those counts are skewed, in even chunks with global destination ids,
``_plan_fallback``).  Bucketed, the SpMM's are planned once per graph and
orientation (``plan_fallback_table``): each rank's fallback sources become
rows of its table X = [previous rank's last R rows | its own rows | next
rank's first R rows | the U remote rows they need, one each, grouped by
owner], a CSR by local row into X in a fixed order; the remote rows' route
is exchanged once (``store/dist_array.py::gather_plan``).  A call then
exchanges the halos and the remote rows (one all-to-all of rows, nothing
read back to the host) and runs the whole function, band, fallback, 'mean'
and cast, in one launch (``slab_spmm_shard``), as on one card.  In the
balanced plan the band kernel runs alone and the fallback rows, fetched by
the store's distributed gather, return to their owners by a distributed
scatter-add.  The attention plans its fallback edges the same way, once per
graph, into two tables: by destination into table A of x (the forward and
the backward's destination pass; each remote row packed with its
alpha_src) and by source into table B of g (the backward's source pass;
each remote row packed with its stats).  A forward call is the halo
exchange, at world > 1 one all-to-all of table A's remote rows, and one
launch over the band and the fallback in one softmax; a backward call the
halo exchange of g and the stats, one all-to-all of table B's remote rows
and one call of the shard backward, which sums each gradient, dalpha_dst
too, on its owner (the JAX package instead gathers the fallback rows, merges
them by log-sum-exp and returns dalpha_dst by a scatter-add).  Every sum
has a fixed order, so two runs of a step agree bit for bit.

Gradients: d/dx (A x) = A^T g, and the transpose of a banded graph is banded
with the same bandwidth, so ``spmm``'s backward is the same sharded routine
over the transposed structures.  The attention's backward reuses the
forward's table A (its halos, remote rows and alpha_src, kept in the
autograd context), halo-exchanges g and the per-node stats (alpha_dst, m,
s, t), and reads, per rank, the band edges by source with halo-extended
destination rows (the pair's ``t_ell`` rows, or a slice of its band CSR by
source), so dx, dalpha_dst and dalpha_src come out for the rank's own rows
and no reverse halo is needed.  The JAX package's one-pass backward instead sums
margin planes and returns them with ``_halo_reduce``: the same function.
Collectives in a backward run in the same order on every rank because every
rank runs the same autograd graph.

Every rank builds the whole graph's host structures and keeps its own rows
on its device.  Node arrays are this rank's rs rows (:meth:`shard`); the
model's parameters are replicated (``train_full.dist_full_batch_step``).
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG
from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import (
    PackedRows,
    ShardTable,
    pack_rows,
    slab_attention_spmm_mh_shard,
    slab_attention_spmm_shard,
)
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
    SlabGraph,
    build_slab_graph,
    ell_lengths,
    slab_spmm_band_shard,
    slab_spmm_shard,
)
from cugraph_gnn_tpu_torch.ops.reorder import reorder_csr
from cugraph_gnn_tpu_torch.parallel.mesh import Mesh
from cugraph_gnn_tpu_torch.store.dist_array import (
    GatherPlan,
    ScatterAddPlan,
    _dist_gather_planned,
    _dist_gather_shard,
    _dist_scatter_add,
    alltoallv,
    gather_plan,
    put_global,
    scatter_add_plan,
)
from cugraph_gnn_tpu_torch.store.partition import PartitionBook


def _bucket_fallback(fb_src, fb_dst, rows_per_shard: int, world: int,
                     bucket_by: str = "dst", localize: str = "dst", fb_w=None):
    """Host-side: group fallback edges by ``bucket_by`` ('dst' or 'src')
    shard, pad every shard to the max count (a multiple of 128), and
    localize the ``localize`` side's ids to shard-relative offsets (the
    other side stays global for the exchange).  Returns (W * cap,) src / dst
    arrays, -1 padded (plus a 0-padded weight array when ``fb_w`` is given);
    all shape (0,) when the graph has no fallback edges.  The JAX package's
    arrays, bit for bit."""
    fb_src = np.asarray(fb_src)
    fb_dst = np.asarray(fb_dst)
    valid = (fb_src >= 0) & (fb_dst >= 0)
    fb_src, fb_dst = fb_src[valid], fb_dst[valid]
    if fb_w is not None:
        fb_w = np.asarray(fb_w, np.float32)[valid]
    if not len(fb_src):
        out = (np.zeros(0, np.int32),) * 2
        return out + (np.zeros(0, np.float32),) if fb_w is not None else out
    shard = (fb_dst if bucket_by == "dst" else fb_src) // rows_per_shard
    cap = int(np.bincount(shard, minlength=world).max(initial=0))
    cap = max(-(-cap // 128) * 128, 128)
    src_p = np.full((world, cap), -1, np.int32)
    dst_p = np.full((world, cap), -1, np.int32)
    w_p = np.zeros((world, cap), np.float32)
    for w in range(world):
        sel = shard == w
        k = int(sel.sum())
        src_p[w, :k] = fb_src[sel] - (w * rows_per_shard if localize == "src" else 0)
        dst_p[w, :k] = fb_dst[sel] - (w * rows_per_shard if localize == "dst" else 0)
        if fb_w is not None:
            w_p[w, :k] = fb_w[sel]
    if fb_w is not None:
        return src_p.reshape(-1), dst_p.reshape(-1), w_p.reshape(-1)
    return src_p.reshape(-1), dst_p.reshape(-1)


def _plan_fallback(fb_src, fb_dst, rows_per_shard: int, world: int, fb_w=None,
                   balance_threshold: float = 2.0):
    """Fallback-edge placement for the SpMM with bounded memory: bucketed
    by destination shard (local reduce, no extra exchange) while the
    per-shard counts are even (max <= ``balance_threshold`` x mean); on
    hub-concentrated fallbacks, where that padding would cost O(W * max),
    W equal chunks with GLOBAL destination ids, returned to their owners by
    one distributed scatter-add.  Returns (src, dst[, w], balanced), the
    JAX package's arrays."""
    s = np.asarray(fb_src)
    d = np.asarray(fb_dst)
    valid = (s >= 0) & (d >= 0)
    s, d = s[valid], d[valid]
    w = None if fb_w is None else np.asarray(fb_w, np.float32)[valid]
    e = len(s)
    if e:
        counts = np.bincount(d // rows_per_shard, minlength=world)
        balanced = counts.max() > balance_threshold * max(e / world, 1.0)
    else:
        balanced = False
    if not balanced:
        return _bucket_fallback(fb_src, fb_dst, rows_per_shard, world, fb_w=fb_w) + (False,)
    chunk = -(-e // world)
    cap = max(-(-chunk // 128) * 128, 128)
    src_p = np.full((world, cap), -1, np.int32)
    dst_p = np.full((world, cap), -1, np.int32)
    w_p = np.zeros((world, cap), np.float32)
    for i in range(world):
        lo, hi = i * chunk, min((i + 1) * chunk, e)
        k = max(hi - lo, 0)
        src_p[i, :k] = s[lo:hi]
        dst_p[i, :k] = d[lo:hi]
        if w is not None:
            w_p[i, :k] = w[lo:hi]
    if fb_w is not None:
        return src_p.reshape(-1), dst_p.reshape(-1), w_p.reshape(-1), True
    return src_p.reshape(-1), dst_p.reshape(-1), True


def _p2p(mesh: Mesh, sends, recvs) -> None:
    """Post sends [(tensor, rank)] and receives [(buffer, rank)] as one
    batch and wait for all of them."""
    ops = ([dist.P2POp(dist.isend, t, mesh.global_rank(r), mesh.group) for t, r in sends]
           + [dist.P2POp(dist.irecv, t, mesh.global_rank(r), mesh.group) for t, r in recvs])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _halo_pairs(tensors, r_blk: int, mesh: Mesh):
    """[(previous rank's last R rows, next rank's first R rows)] of each of
    ``tensors`` (this rank's rows), in one batch of sends and receives; the
    end ranks get zeros for the missing side."""
    w, world = mesh.rank, mesh.world
    pairs, sends, recvs = [], [], []
    for x_local in tensors:
        prev = x_local.new_zeros((r_blk,) + tuple(x_local.shape[1:]))
        nxt = torch.zeros_like(prev)
        if w + 1 < world:
            sends.append((x_local[-r_blk:].contiguous(), w + 1))
            recvs.append((nxt, w + 1))
        if w > 0:
            sends.append((x_local[:r_blk].contiguous(), w - 1))
            recvs.append((prev, w - 1))
        pairs.append((prev, nxt))
    _p2p(mesh, sends, recvs)
    return pairs


def _halo_pair(x_local: torch.Tensor, r_blk: int, mesh: Mesh):
    """(previous rank's last R rows, next rank's first R rows) of x."""
    return _halo_pairs([x_local], r_blk, mesh)[0]


def _halo_exchange(x_local: torch.Tensor, r_blk: int, mesh: Mesh) -> torch.Tensor:
    """x_ext = [previous rank's last R rows | x_local | next rank's first R
    rows]; the end ranks get zeros for the missing side."""
    prev, nxt = _halo_pair(x_local, r_blk, mesh)
    return torch.cat([prev, x_local, nxt])


def _halo_reduce(c_ext: torch.Tensor, r_blk: int, mesh: Mesh) -> torch.Tensor:
    """Inverse of :func:`_halo_exchange` for accumulation: ``c_ext`` (rs +
    2R, ...) holds [contributions to the previous rank's last R rows | own
    rows | contributions to the next rank's first R rows]; the margins go to
    their owners and are added to their edge rows.  The end ranks' outer
    margins are dropped (the graph has no rows there)."""
    w, world = mesh.rank, mesh.world
    from_next = c_ext.new_zeros((r_blk,) + tuple(c_ext.shape[1:]))
    from_prev = torch.zeros_like(from_next)
    sends, recvs = [], []
    if w > 0:
        sends.append((c_ext[:r_blk].contiguous(), w - 1))
        recvs.append((from_prev, w - 1))
    if w + 1 < world:
        sends.append((c_ext[-r_blk:].contiguous(), w + 1))
        recvs.append((from_next, w + 1))
    _p2p(mesh, sends, recvs)
    body = c_ext[r_blk:c_ext.shape[0] - r_blk].clone()
    body[-r_blk:] += from_next
    body[:r_blk] += from_prev
    return body


def halo_rows(x: torch.Tensor, w: int, rs: int, r_blk: int) -> torch.Tensor:
    """Rows [w*rs - R, (w+1)*rs + R) of a whole (padded) node array, zeros
    outside it: what rank w's :func:`_halo_exchange` of ``x``'s rows gives."""
    lo, hi = w * rs - r_blk, (w + 1) * rs + r_blk
    out = x.new_zeros((hi - lo,) + tuple(x.shape[1:]))
    a, b = max(lo, 0), min(hi, x.shape[0])
    if b > a:
        out[a - lo:b - lo] = x[a:b]
    return out


def halo_table(a: torch.Tensor, head: torch.Tensor, w: int, rs: int, r_blk: int,
               tail) -> ShardTable:
    """Rank w's table of a whole (padded) node array ``a``, as its halo
    exchange and the planned exchange of its remote rows ``tail`` (global
    rows) build it, each remote row packed with its row of ``head`` (one
    row a node, float32 scalars)."""
    ext = halo_rows(a, w, rs, r_blk)
    tail = torch.as_tensor(tail, dtype=torch.int64, device=a.device)
    return ShardTable(a[w * rs:(w + 1) * rs], ext[:r_blk], ext[-r_blk:],
                      pack_rows(head.reshape(head.shape[0], -1)[tail], a[tail]))


def _padded(a: np.ndarray, rows: int, fill) -> np.ndarray:
    if a.shape[0] >= rows:
        return a[:rows]
    pad = np.full((rows - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad])


def shard_slab(ell: np.ndarray, ell_w: Optional[np.ndarray], w: int, rs: int,
               r_blk: int, device) -> SlabGraph:
    """Rank w's rows of a band ELL (and weights) as a SlabGraph without
    fallback edges, the input of the shard kernels.  ``ell`` has at least
    (w + 1) * rs rows (pad with -1)."""
    sl = slice(w * rs, (w + 1) * rs)

    def t(a):
        return None if a is None else torch.as_tensor(np.ascontiguousarray(a[sl]),
                                                       device=device)

    ell_l = t(ell)
    no_edges = torch.zeros(0, dtype=torch.int32, device=device)
    return SlabGraph(ell=ell_l, ell_w=t(ell_w), fb_src=no_edges, fb_dst=no_edges,
                     fb_w=None, degrees=(ell_l >= 0).sum(1, dtype=torch.int32),
                     num_rows=rs, block_rows=r_blk, n_blocks=rs // r_blk,
                     fb_rowptr=torch.zeros(rs + 1, dtype=torch.int64, device=device),
                     ell_len=ell_lengths(ell_l))


def shard_attention_pair(pair: AG.AttnSlabPair, w: int, rs: int, n_pad: int,
                         device) -> AG.AttnSlabPair:
    """Rank w's part of a whole graph's attention pair (host tensors): its
    band by destination, its band by source (the band CSR by source with
    destination rows shifted into the halo-extended numbering: global row -
    (w*rs - R); and ``t_ell`` rows where the pair has them), no fallback
    edges."""
    r_blk, n = pair.fwd.block_rows, pair.fwd.num_rows
    fwd = shard_slab(_padded(pair.fwd.ell.cpu().numpy(), n_pad, -1), None, w, rs,
                     r_blk, device)
    no_edges = torch.zeros(0, dtype=torch.int32, device=device)
    empty_ptr = torch.zeros(rs + 1, dtype=torch.int64, device=device)
    t_ell = None
    if pair.t_ell is not None:
        t_ell = torch.as_tensor(np.ascontiguousarray(
            _padded(pair.t_ell.cpu().numpy(), n_pad, -1)[w * rs:(w + 1) * rs]), device=device)
    ptr = pair.t_rowptr.cpu().numpy()
    lo, hi = min(w * rs, n), min((w + 1) * rs, n)
    e0, e1 = int(ptr[lo]), int(ptr[hi])
    t_ptr = np.full(rs + 1, e1 - e0, np.int64)
    t_ptr[:hi - lo + 1] = ptr[lo:hi + 1] - e0
    t_rows = (pair.t_rows.cpu().numpy()[e0:e1].astype(np.int64)
              - (w * rs - r_blk)).astype(np.int32)
    return AG.AttnSlabPair(fwd=fwd, fb_t_rowptr=empty_ptr, fb_t_dst=no_edges, t_ell=t_ell,
                           t_rowptr=torch.as_tensor(t_ptr, device=device),
                           t_rows=torch.as_tensor(t_rows, device=device))


class FallbackTable(NamedTuple):
    """One rank's bucketed fallback edges planned against its table X =
    [previous rank's last R rows | its rs rows | next rank's first R rows |
    tail], host arrays."""

    rowptr: np.ndarray        # (rs + 1,) int64: the slots of local row r
    x_ids: np.ndarray         # (E,) int32: each slot's row of X
    dst: np.ndarray           # (E,) int32: each slot's local row
    weights: Optional[np.ndarray]   # (E,) float32 in slot order, or None
    tail: np.ndarray          # (U,) int64: the tail's global rows, sorted


def plan_fallback_table(fb_src, fb_dst, fb_w=None, *, rank: int, rows_per_rank: int,
                        block_rows: int) -> FallbackTable:
    """Plan rank ``rank``'s fallback edges (global sources ``fb_src``, local
    destinations ``fb_dst`` in [0, rows_per_rank), optional weights; other
    slots dropped) as a CSR by local row into its table X: a source within
    the halo-extended rows [rank*rs - R, (rank+1)*rs + R) is its row there,
    ``src - rank*rs + R``; any other source is a tail row, one for each
    distinct remote source, the tail sorted (so grouped by owner, in rank
    order) after the rs + 2R halo-extended rows.  A row's slots keep the
    order of ``fb_dst`` (a stable sort, ``segment_plan``'s order)."""
    rs, r_blk = int(rows_per_rank), int(block_rows)
    src = np.asarray(fb_src, np.int64)
    dst = np.asarray(fb_dst, np.int64)
    keep = (src >= 0) & (dst >= 0) & (dst < rs)
    order = np.nonzero(keep)[0][np.argsort(dst[keep], kind="stable")]
    src, dst = src[order], dst[order]
    lo = rank * rs - r_blk
    near = (src >= lo) & (src < lo + rs + 2 * r_blk)
    tail = np.unique(src[~near])
    x_ids = np.where(near, src - lo, rs + 2 * r_blk + np.searchsorted(tail, src))
    return FallbackTable(
        rowptr=np.searchsorted(dst, np.arange(rs + 1)).astype(np.int64),
        x_ids=x_ids.astype(np.int32), dst=dst.astype(np.int32),
        weights=None if fb_w is None else np.asarray(fb_w, np.float32)[order],
        tail=tail)


def with_table(band: SlabGraph, table: FallbackTable, degrees, device) -> SlabGraph:
    """A shard's band (``shard_slab``) with its planned fallback edges and
    its degrees: the input of ``slab_spmm_shard``."""
    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return band._replace(fb_src=t(table.x_ids), fb_dst=t(table.dst), fb_w=t(table.weights),
                         fb_rowptr=t(table.rowptr),
                         degrees=t(np.asarray(degrees, np.int32)))


def shard_table_graph(slab: SlabGraph, w: int, rs: int, n_pad: int, world: int, device):
    """Rank w's input of ``slab_spmm_shard`` for a whole graph's host slab,
    with no process group (the bucketed plan, as ``DistFullBatchGraph``
    builds it when the fallback counts are even): (SlabGraph, the tail's
    global rows)."""
    fb_w = None if slab.fb_w is None else slab.fb_w.numpy()
    planned = _bucket_fallback(slab.fb_src.numpy(), slab.fb_dst.numpy(), rs, world, fb_w=fb_w)
    cap = len(planned[0]) // world
    mine = [a[w * cap:(w + 1) * cap] for a in planned]
    table = plan_fallback_table(*mine, rank=w, rows_per_rank=rs,
                                block_rows=slab.block_rows)
    band = shard_slab(_padded(slab.ell.numpy(), n_pad, -1),
                      None if slab.ell_w is None else _padded(slab.ell_w.numpy(), n_pad, 0),
                      w, rs, slab.block_rows, device)
    deg = _padded(slab.degrees.numpy(), n_pad, 0)[w * rs:(w + 1) * rs]
    return with_table(band, table, deg, device), table.tail


def _rank_part(planned, rank: int, world: int):
    """Rank ``rank``'s slice of planned fallback arrays ((world * cap,)
    each), without its -1 padding (host arrays)."""
    cap = len(planned[0]) // world
    sl = slice(rank * cap, (rank + 1) * cap)
    keep = (planned[0][sl] >= 0) & (planned[1][sl] >= 0)
    return tuple(a[sl][keep] for a in planned)


def _attention_tables(fb_src, fb_dst, *, rank: int, rows_per_rank: int, world: int,
                      block_rows: int):
    """Rank ``rank``'s two attention tables from a whole graph's fallback
    edges (host arrays, global ids): A, the edges bucketed by destination
    rank into rows of x (sources: the forward and the backward's destination
    pass), and B, the edges bucketed by source rank into rows of g
    (destinations: the backward's source pass), planned by
    :func:`plan_fallback_table` with sources and destinations swapped."""
    rs = rows_per_rank
    src, dst = _rank_part(_bucket_fallback(fb_src, fb_dst, rs, world), rank, world)
    table_a = plan_fallback_table(src, dst, rank=rank, rows_per_rank=rs, block_rows=block_rows)
    src, dst = _rank_part(_bucket_fallback(fb_src, fb_dst, rs, world, bucket_by="src",
                                           localize="src"), rank, world)
    table_b = plan_fallback_table(dst, src, rank=rank, rows_per_rank=rs, block_rows=block_rows)
    return table_a, table_b


def with_attention_tables(shard: AG.AttnSlabPair, table_a: FallbackTable,
                          table_b: FallbackTable, device) -> AG.AttnSlabPair:
    """A shard's attention pair (:func:`shard_attention_pair`) with its
    fallback edges planned into its tables: by destination into table A
    (``fwd.fb_rowptr``/``fb_src``, ``fb_dst`` the local rows) and by source
    into table B (``fb_t_rowptr``/``fb_t_dst``): the input of the shard
    kernels."""
    def t(a):
        return torch.as_tensor(a, device=device)

    fwd = shard.fwd._replace(fb_src=t(table_a.x_ids), fb_dst=t(table_a.dst),
                             fb_rowptr=t(table_a.rowptr))
    return shard._replace(fwd=fwd, fb_t_rowptr=t(table_b.rowptr), fb_t_dst=t(table_b.x_ids))


def shard_attention_tables(pair: AG.AttnSlabPair, w: int, rs: int, n_pad: int, world: int,
                           device):
    """Rank w's input of the shard attention kernels for a whole graph's
    host pair, with no process group, as ``DistFullBatchGraph`` builds it:
    (the shard's pair with its tables, table A's tail (global source rows),
    table B's tail (global destination rows))."""
    table_a, table_b = _attention_tables(pair.fwd.fb_src.cpu().numpy(),
                                         pair.fwd.fb_dst.cpu().numpy(), rank=w,
                                         rows_per_rank=rs, world=world,
                                         block_rows=pair.fwd.block_rows)
    shard = shard_attention_pair(pair, w, rs, n_pad, device)
    return with_attention_tables(shard, table_a, table_b, device), table_a.tail, table_b.tail


def _gather_packed(head: torch.Tensor, body: torch.Tensor, route: Optional[GatherPlan],
                   mesh: Mesh) -> PackedRows:
    """The packed rows (``head`` (rs, h) float32 beside ``body`` (rs, ...))
    of a table's tail along its planned route: one all-to-all of packed rows
    (none at world 1 or without fallback edges: an empty tail)."""
    if route is None:
        return pack_rows(head[:0], body[:0])
    sent = pack_rows(head[route.send_rows], body[route.send_rows])
    return sent._replace(data=alltoallv(sent.data, route.send_sizes, route.recv_sizes, mesh))


class _ShardSpmm(NamedTuple):
    """One orientation's SpMM structures on this rank: the shard's band
    (with, bucketed, its fallback CSR into the table and its degrees), the
    bucketed fallback edges as planned (global sources; local destinations,
    or global ones when balanced), and the route of the table's remote rows
    (None at world 1 or without fallback edges) or the balanced plan's
    scatter-add."""

    band: SlabGraph
    fb_src: torch.Tensor
    fb_dst: torch.Tensor
    fb_w: Optional[torch.Tensor]
    balanced: bool
    has_fb: bool
    route: Optional[GatherPlan]
    scatter: Optional[ScatterAddPlan]


def _shard_spmm_body(st: _ShardSpmm, x_local, *, reduce: str, compute_dtype, mesh: Mesh,
                     book: PartitionBook):
    """One rank's sum/mean aggregation, in x's dtype (rs, F).  Bucketed:
    the halo exchange and, at world > 1, one all-to-all of the table's
    remote rows, then ``slab_spmm_shard`` (band, fallback, divide, cast in
    one launch).  Balanced: the band kernel over the halo-extended x, the
    fallback rows by the distributed gather, returned to their owners by the
    distributed scatter-add, then the divide and the cast.  Every rank calls
    it together (with or without fallback edges of its own)."""
    r_blk = st.band.block_rows
    if not st.balanced:
        prev, nxt = _halo_pair(x_local, r_blk, mesh)
        tail = (x_local.new_zeros((0, x_local.shape[1])) if st.route is None
                else _dist_gather_planned(x_local, st.route, mesh=mesh))
        return slab_spmm_shard(st.band, x_local, prev, nxt, tail, reduce, compute_dtype)
    out = slab_spmm_band_shard(st.band, _halo_exchange(x_local, r_blk, mesh), compute_dtype)
    if st.has_fb:
        rows = _dist_gather_shard(x_local, st.fb_src, book=book, mesh=mesh, fill=0).float()
        if st.fb_w is not None:
            rows = rows * st.fb_w[:, None]
        plan = st.scatter if st.scatter is not None else scatter_add_plan(
            st.fb_dst, out.shape[0], book=book, mesh=mesh)
        out = _dist_scatter_add(out, rows, plan, mesh=mesh)
    if reduce == "mean":
        out = out / st.band.degrees.clamp(min=1)[:, None].to(out.dtype)
    return out.to(x_local.dtype)


class _DistSpmm(torch.autograd.Function):
    """Forward: the sharded SpMM ('mean' divided by max(degree, 1)) in x's
    dtype.  Backward: g / degree for 'mean', then the sharded 'sum' over the
    transposed structures, as ``FullBatchGraph``'s."""

    @staticmethod
    def forward(ctx, x, graph, reduce, compute_dtype):
        ctx.graph, ctx.reduce, ctx.compute_dtype = graph, reduce, compute_dtype
        ctx.x_dtype = x.dtype
        return graph._spmm_sharded(x, transpose=False, reduce=reduce,
                                   compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, g):
        graph = ctx.graph
        g = g.contiguous()
        if ctx.reduce == "mean":
            g = g / graph.degrees.clamp(min=1)[:, None].to(g.dtype)
        gx = graph._spmm_sharded(g, transpose=True, reduce="sum",
                                 compute_dtype=ctx.compute_dtype)
        return gx.to(ctx.x_dtype), None, None, None


class _DistAttention(torch.autograd.Function):
    """Forward: the sharded fused attention, keeping its stats and its table
    A (halos, remote rows, halo-extended alpha_src), so that the backward
    exchanges no row of x again.  Backward: t = sum(g * out, -1), then the
    sharded backward; gradients in their inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, alpha_dst, alpha_src, graph, negative_slope):
        out, m, s, table_a, as_ext = graph._attn_fwd(x, alpha_dst, alpha_src, negative_slope)
        ctx.save_for_backward(x, alpha_dst, alpha_src, out, m, s, table_a.prev, table_a.next,
                              table_a.tail.data, as_ext)
        ctx.tail = table_a.tail._replace(data=None)
        ctx.graph, ctx.negative_slope = graph, negative_slope
        return out

    @staticmethod
    def backward(ctx, g):
        x, alpha_dst, alpha_src, out, m, s, prev, nxt, tail, as_ext = ctx.saved_tensors
        table_a = ShardTable(x.contiguous(), prev, nxt, ctx.tail._replace(data=tail))
        t = (g.float() * out).sum(-1)
        dx, dad, das = ctx.graph._attn_bwd(table_a, as_ext, alpha_dst, m, s, t, g,
                                           ctx.negative_slope)
        return (dx.to(x.dtype), dad.to(alpha_dst.dtype), das.to(alpha_src.dtype),
                None, None)


class DistFullBatchGraph:
    """Row-sharded full-batch message passing over ``mesh``.

    The surface of ``FullBatchGraph`` that distributes (``spmm`` sum/mean,
    ``degrees``, the attention methods, ``to_graph_order``), so that the
    models' ``full_graph`` paths run unchanged on this rank's rows.  The
    node count is padded to ``n_pad``, a multiple of world x R; rank w owns
    rows [w*rs, (w+1)*rs).  Padded rows have no edges and degree 0.
    ``build_seconds`` holds the host seconds of the builds.
    """

    def __init__(self, indptr, indices, mesh: Mesh, *, weights=None,
                 reorder: str = "auto", block_rows: int = 256, max_k: int = 64):
        t0 = time.perf_counter()
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int32)
        if weights is not None:
            weights = np.asarray(weights, np.float32)
        n = len(indptr) - 1
        self.num_nodes = n
        self.mesh = mesh
        self._order = None
        if reorder in ("rcm", "auto"):
            rg = reorder_csr(indptr, indices)
            if reorder == "rcm" or self._band_better(indptr, indices, rg, block_rows):
                self._order = rg
                indptr, indices = rg.indptr, rg.indices
                if weights is not None:
                    weights = weights[np.asarray(rg.edge_perm)]
        elif reorder != "none":
            raise ValueError(f"unknown reorder {reorder!r}")
        build = dict(block_rows=block_rows, max_k=max_k, device="cpu")
        slab = build_slab_graph(indptr, indices, weights, **build)
        self.band_fraction = slab.band_fraction
        self._indptr_g, self._indices_g = indptr, indices
        self._max_k = max_k
        world = mesh.world
        # pad the block count to a multiple of the world size
        nb_w = -(-slab.n_blocks // world) * world
        self._r_blk = block_rows
        self._rs = (nb_w // world) * block_rows
        self._n_pad = nb_w * block_rows
        self._world = world
        self._book = PartitionBook.even(self._n_pad, world)
        self.weighted = weights is not None
        deg = np.zeros(self._n_pad, np.int32)
        deg[:n] = slab.degrees.numpy()[:n]
        self.degrees = put_global(deg, mesh)
        self._spmm = {False: self._spmm_structs(slab)}
        t1 = time.perf_counter()
        # transpose structures for the backward pass
        rows = np.repeat(np.arange(n, dtype=np.int32), indptr[1:] - indptr[:-1])
        ok = (indices >= 0) & (indices < n)
        t_indptr, t_indices, t_perm = _native.build_csr(indices[ok], rows[ok], n)
        w_t = None if weights is None else weights[ok][t_perm]
        self._spmm[True] = self._spmm_structs(build_slab_graph(t_indptr, t_indices, w_t,
                                                               **build))
        self._attn = None
        self.build_seconds: Dict[str, float] = {
            "graph": t1 - t0, "transpose": time.perf_counter() - t1}

    @staticmethod
    def _band_better(indptr, indices, rg, block_rows) -> bool:
        """auto mode: keep RCM only if it raises the in-band fraction."""
        n = len(indptr) - 1

        def frac(ip, ix):
            rows = np.repeat(np.arange(n, dtype=np.int64),
                             np.asarray(ip)[1:] - np.asarray(ip)[:-1])
            cols = np.asarray(ix, np.int64)
            ok = (cols >= 0) & (cols < n)
            if not ok.any():
                return 0.0
            return float((np.abs(cols[ok] - rows[ok]) <= block_rows).mean())

        return frac(rg.indptr, rg.indices) > frac(indptr, indices)

    # -- placement ---------------------------------------------------------

    def _local_np(self, *arrays):
        """This rank's :func:`_rank_part` of planned fallback arrays."""
        return _rank_part(arrays, self.mesh.rank, self._world)

    def _local_edges(self, *arrays) -> Tuple[torch.Tensor, ...]:
        """:meth:`_local_np` on this rank's device (ids int64)."""
        return tuple(torch.as_tensor(a.astype(np.int64 if a.dtype.kind == "i" else np.float32),
                                     device=self.mesh.device)
                     for a in self._local_np(*arrays))

    def _table_structs(self, band: SlabGraph, src, dst, w, degrees,
                       has_fb: bool) -> _ShardSpmm:
        """The bucketed plan of this rank's fallback edges (host arrays:
        global sources, local destinations, weights or None); the remote
        rows' route is exchanged here (every rank calls it together)."""
        table = plan_fallback_table(src, dst, w, rank=self.mesh.rank, rows_per_rank=self._rs,
                                    block_rows=self._r_blk)
        dev = self.mesh.device
        route = None
        if self._world > 1 and has_fb:
            route = gather_plan(torch.as_tensor(table.tail, device=dev), book=self._book,
                                mesh=self.mesh)
        return _ShardSpmm(band=with_table(band, table, degrees, dev),
                          fb_src=torch.as_tensor(np.asarray(src, np.int64), device=dev),
                          fb_dst=torch.as_tensor(np.asarray(dst, np.int64), device=dev),
                          fb_w=None if w is None else torch.as_tensor(w, device=dev),
                          balanced=False, has_fb=has_fb, route=route, scatter=None)

    def _spmm_structs(self, slab: SlabGraph) -> _ShardSpmm:
        ell = _padded(slab.ell.numpy(), self._n_pad, -1)
        ell_w = None if slab.ell_w is None else _padded(slab.ell_w.numpy(), self._n_pad, 0)
        fb_w = None if slab.fb_w is None else slab.fb_w.numpy()
        *planned, balanced = _plan_fallback(slab.fb_src.numpy(), slab.fb_dst.numpy(),
                                            self._rs, self._world, fb_w=fb_w)
        rank, rs = self.mesh.rank, self._rs
        band = shard_slab(ell, ell_w, rank, rs, self._r_blk, self.mesh.device)
        deg = _padded(slab.degrees.numpy(), self._n_pad, 0)[rank * rs:(rank + 1) * rs]
        has_fb = len(planned[0]) > 0
        if not balanced:
            src, dst, *w = self._local_np(*planned)
            return self._table_structs(band, src, dst, w[0] if w else None, deg, has_fb)
        fb = self._local_edges(*planned)
        deg = torch.as_tensor(deg, device=self.mesh.device)
        return _ShardSpmm(band=band._replace(degrees=deg),
                          fb_src=fb[0], fb_dst=fb[1], fb_w=fb[2] if len(fb) > 2 else None,
                          balanced=True, has_fb=has_fb, route=None,
                          scatter=scatter_add_plan(fb[1], rs, book=self._book, mesh=self.mesh))

    @property
    def n_pad(self) -> int:
        """Padded node count (world x rows per rank)."""
        return self._n_pad

    @property
    def rows_per_rank(self) -> int:
        return self._rs

    @property
    def order(self) -> Optional[np.ndarray]:
        return None if self._order is None else self._order.order

    @property
    def inv_order(self) -> Optional[np.ndarray]:
        return None if self._order is None else self._order.inv_order

    def to_graph_order(self, x):
        """A host node array (numpy or CPU tensor, N rows) in graph order."""
        return x if self._order is None else x[np.asarray(self._order.order)]

    def shard(self, x, dtype=None) -> torch.Tensor:
        """This rank's rows of a host node array (graph order, N rows),
        padded with zeros, on its device: (rs, ...)."""
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        if dtype is not None:
            x = x.to(dtype)
        rs, w = self._rs, self.mesh.rank
        out = torch.zeros((rs,) + tuple(x.shape[1:]), dtype=x.dtype, device=self.mesh.device)
        part = x[w * rs:min((w + 1) * rs, self.num_nodes)]
        out[:part.shape[0]] = part.to(self.mesh.device)
        return out

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a sharded node array, trimmed to N, on the
        host (a collective: every rank calls it)."""
        parts = [torch.empty_like(x) for _ in range(self._world)]
        dist.all_gather(parts, x.contiguous(), group=self.mesh.group)
        return torch.cat(parts)[:self.num_nodes].cpu()

    # -- aggregation -------------------------------------------------------

    def spmm_arrays(self, transpose: bool = False):
        """(ell, fb_src, fb_dst) of this rank, for :meth:`spmm_with_arrays`."""
        st = self._spmm[transpose]
        return st.band.ell, st.fb_src, st.fb_dst

    def spmm_with_arrays(self, x, ell, fb_s, fb_d, *, compute_dtype=torch.float32):
        """Forward-only, unweighted sum aggregation with this graph's
        structure arrays passed explicitly (see :meth:`spmm_arrays`), in x's
        dtype: its fallback plan is built from them here, by the route and in
        the order of :meth:`spmm` (every rank calls it together)."""
        st = self._spmm[False]
        band = st.band.with_ell(ell)
        if st.balanced:
            st = st._replace(band=band, fb_src=fb_s, fb_dst=fb_d, fb_w=None, scatter=None)
        else:
            st = self._table_structs(band, fb_s.cpu().numpy(), fb_d.cpu().numpy(), None,
                                     st.band.degrees.cpu().numpy(), st.has_fb)
        return _shard_spmm_body(st, x.contiguous(), reduce="sum", compute_dtype=compute_dtype,
                                mesh=self.mesh, book=self._book)

    def _spmm_sharded(self, x, *, transpose: bool, reduce: str, compute_dtype):
        return _shard_spmm_body(self._spmm[transpose], x.contiguous(), reduce=reduce,
                                compute_dtype=compute_dtype, mesh=self.mesh, book=self._book)

    def spmm(self, x, reduce: str = "mean", *, compute_dtype=torch.float32):
        """out[r] = reduce over row r's in-neighbors of w * x[c]; x and out
        are this rank's rows (:meth:`shard`).  Differentiable in x (the
        transposed graph's sharded SpMM)."""
        if reduce not in ("sum", "mean"):
            raise ValueError(f"dist slab spmm supports sum/mean, got {reduce!r}")
        return _DistSpmm.apply(x, self, reduce, compute_dtype)

    # -- fused attention -----------------------------------------------------

    def _attn_structs(self):
        """The attention pair of the graph-order CSR and this rank's part of
        it with its fallback edges planned into its two tables (by
        destination into table A, by source into table B), and, at world >
        1, the routes of the tables' remote rows; built at first use (every
        rank together)."""
        if self._attn is None:
            t0 = time.perf_counter()
            pair = AG.build_attention_slab_pair(self._indptr_g, self._indices_g,
                                                block_rows=self._r_blk,
                                                max_k=self._max_k, device="cpu")
            fb_s, fb_d = pair.fwd.fb_src.numpy(), pair.fwd.fb_dst.numpy()
            rank, dev = self.mesh.rank, self.mesh.device
            table_a, table_b = _attention_tables(fb_s, fb_d, rank=rank, rows_per_rank=self._rs,
                                                 world=self._world, block_rows=self._r_blk)
            routes = [None, None]
            # the same on every rank: whether the graph has fallback edges
            if self._world > 1 and bool(((fb_s >= 0) & (fb_d >= 0)).any()):
                routes = [gather_plan(torch.as_tensor(t.tail, device=dev), book=self._book,
                                      mesh=self.mesh) for t in (table_a, table_b)]
            shard = shard_attention_pair(pair, rank, self._rs, self._n_pad, dev)
            self._attn = dict(pair=with_attention_tables(shard, table_a, table_b, dev),
                              route_a=routes[0], route_b=routes[1])
            self.build_seconds["attention_pair"] = time.perf_counter() - t0
        return self._attn

    def _attn_fwd(self, x, alpha_dst, alpha_src, negative_slope):
        """(out (rs, H, F), m, s (rs, H)) float32, and the call's table A
        and halo-extended alpha_src: the halo exchange of x and alpha_src,
        at world > 1 one all-to-all of table A's remote rows (x beside
        alpha_src), then one launch of the shard forward (band and fallback
        edges in one softmax; H = 1: the single-head wrapper)."""
        st = self._attn_structs()
        graph = st["pair"].fwd
        rs, heads, _ = x.shape
        x = x.contiguous()
        as32 = alpha_src.float().contiguous()
        (prev, nxt), (as_prev, as_next) = _halo_pairs([x, as32], self._r_blk, self.mesh)
        as_ext = torch.cat([as_prev, as32, as_next])
        table = ShardTable(x, prev, nxt, _gather_packed(as32, x.reshape(rs, -1),
                                                        st["route_a"], self.mesh))
        ad = alpha_dst.float()
        kw = dict(negative_slope=negative_slope, return_stats=True)
        if heads == 1:
            out, m, s = (a[:, None] for a in slab_attention_spmm_shard(
                graph, table.squeeze_heads(), ad[:, 0], as_ext[:, 0], **kw))
        else:
            out, m, s = slab_attention_spmm_mh_shard(graph, table, ad, as_ext, **kw)
        return out, m, s, table, as_ext

    def _attn_bwd(self, table_a, as_ext, alpha_dst, m, s, t, g, negative_slope):
        """(dx (rs, H, F), dalpha_dst, dalpha_src (rs, H)) float32 from the
        forward's table A and halo-extended alpha_src: the halo exchange of
        g and the stats, at world > 1 one all-to-all of table B's remote rows
        (g beside the stats), then one call of the shard backward (band and
        fallback edges, every gradient summed on its owner)."""
        st = self._attn_structs()
        pair = st["pair"]
        rs, heads, _ = table_a.own.shape
        r_blk = self._r_blk
        g32 = g.float().contiguous()
        # the stats written in place between their halos: no copy of the rows
        stats_ext = g32.new_empty((rs + 2 * r_blk, heads, 4))
        stats = AG.attention_stats(alpha_dst, m, s, t, out=stats_ext[r_blk:r_blk + rs])
        (g_prev, g_next), (st_prev, st_next) = _halo_pairs([g32, stats], r_blk, self.mesh)
        for rows, halo in ((slice(0, r_blk), st_prev), (slice(r_blk + rs, None), st_next)):
            stats_ext[rows] = halo
            stats_ext[rows, :, 2].clamp_(min=1e-16)   # the end ranks' zero halo rows
        table_b = ShardTable(g32, g_prev, g_next, _gather_packed(
            stats.reshape(rs, -1), g32.reshape(rs, -1), st["route_b"], self.mesh))
        if heads == 1:
            return tuple(a[:, None] for a in AG.slab_attention_bwd_shard(
                pair, table_a.squeeze_heads(), as_ext[:, 0], table_b.squeeze_heads(),
                stats_ext[:, 0], negative_slope=negative_slope))
        return AG.slab_attention_bwd_mh_shard(pair, table_a, as_ext, table_b, stats_ext,
                                              negative_slope=negative_slope)

    def attention_spmm(self, x, alpha_dst, alpha_src, *, negative_slope: float = 0.2):
        """Single-head fused attention aggregate: x (rs, F), alpha_* (rs,)
        this rank's rows -> (rs, F) float32; differentiable in all three."""
        return _DistAttention.apply(x[:, None], alpha_dst[:, None], alpha_src[:, None],
                                    self, negative_slope)[:, 0]

    def attention_spmm_mh(self, x, alpha_dst, alpha_src, *, negative_slope: float = 0.2):
        """Multi-head fused attention aggregate (``GATConv.full_graph``'s
        contract): x (rs, H, F), alpha_* (rs, H) -> (rs, H, F) float32,
        differentiable.  All heads of a group run in one kernel launch per
        direction; heads beyond ``MAX_PACKED_HEADS`` run in groups of that
        size.  H = 1 takes the single-head kernels."""
        heads = x.shape[1]
        group = AG.MAX_PACKED_HEADS
        if heads > group:
            return torch.cat([
                self.attention_spmm_mh(x[:, h0:h0 + group], alpha_dst[:, h0:h0 + group],
                                       alpha_src[:, h0:h0 + group],
                                       negative_slope=negative_slope)
                for h0 in range(0, heads, group)], dim=1)
        return _DistAttention.apply(x, alpha_dst, alpha_src, self, negative_slope)

    @classmethod
    def from_coo(cls, src, dst, num_nodes: int, mesh: Mesh, weights=None, **kw):
        """From COO edges src -> dst (aggregation at dst); keyword arguments
        as for the constructor."""
        indptr, indices, perm = _native.build_csr(
            np.asarray(dst, np.int32), np.asarray(src, np.int32), num_nodes)
        w = None if weights is None else np.asarray(weights)[perm]
        return cls(indptr, indices, mesh, weights=w, **kw)
