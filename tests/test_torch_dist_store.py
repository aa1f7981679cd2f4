"""Port parity: the partition book and the fallback plans against the JAX
package's (exact, host numpy), and the port's distributed exchanges
(``_dist_gather_shard``, ``_dist_scatter_shard`` set and add,
``_halo_exchange``, ``_halo_reduce``, ``put_global``) against numpy indexing
of the whole array, in spawned gloo worlds of 2 and 4 ranks (exact: the
exchanges move values, and the adds are of integers held in float32); the
fixed-order sums under the adds (``segment_plan``, ``segment_add``) against
numpy.  Also ``RoundRobinBook`` (its queries, and the gather and scatters
over it), ``DistArray.from_array`` / ``from_file`` (``.npy`` and ``.pt``)
with even and round-robin books, ``DistMatrix`` and ``renumber_kg`` against
JAX's, exactly.

The JAX package is imported inside the tests, not at the top: the spawned
workers import this file and run torch alone.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cugraph_gnn_tpu_torch.ops import dist_full_batch as DF
from cugraph_gnn_tpu_torch.parallel.mesh import Mesh
from cugraph_gnn_tpu_torch.store.partition import PartitionBook, RoundRobinBook, even_shard_size


@pytest.mark.parametrize("total,world", [(10, 4), (1000, 8), (7, 7), (5, 8), (0, 3),
                                         (100_003, 4)])
def test_partition_book_matches_jax(total, world):
    from cugraph_gnn_tpu.store import partition as jp

    book, jbook = PartitionBook.even(total, world), jp.PartitionBook.even(total, world)
    assert jbook.is_even
    assert even_shard_size(total, world) == jp.even_shard_size(total, world)
    assert (book.total, book.world_size, book.shard_size, book.padded_total) == (
        jbook.total, jbook.world_size, jbook.shard_size, jbook.padded_total)
    np.testing.assert_array_equal(book.offsets, jbook.offsets)
    np.testing.assert_array_equal(book.counts, jbook.counts)
    ids = np.arange(book.padded_total)
    np.testing.assert_array_equal(book.owner_of_np(ids), jbook.owner_of_np(ids))
    np.testing.assert_array_equal(book.local_offset_np(ids[:total]),
                                  jbook.local_offset_np(ids[:total]))
    t = torch.as_tensor(ids)
    np.testing.assert_array_equal(book.owner_of(t).numpy(), np.asarray(jbook.owner_of(ids)))
    np.testing.assert_array_equal(book.local_offset(t).numpy(),
                                  np.asarray(jbook.local_offset(ids)))


def _fallback_coo(rng, skew):
    """A fallback COO (-1 padded) whose destinations spread evenly or pile
    onto one hub node."""
    n, e = 1000, 700
    src = rng.integers(0, n, e).astype(np.int32)
    dst = (np.full(e, 3) if skew == "hub" else rng.integers(0, n, e)).astype(np.int32)
    pad = np.full(20, -1, np.int32)
    return (np.concatenate([src, pad]), np.concatenate([dst, pad]),
            np.concatenate([rng.random(e), np.zeros(20)]).astype(np.float32))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("skew", ["even", "hub"])
def test_plan_fallback_matches_jax(skew, weighted):
    """Both regimes (dst-bucketed, and even chunks with global dst ids when
    one shard's count passes twice the mean), arrays equal to JAX's."""
    from cugraph_gnn_tpu.ops import dist_full_batch as jdf

    src, dst, w = _fallback_coo(np.random.default_rng(1), skew)
    fb_w = w if weighted else None
    got = DF._plan_fallback(src, dst, 250, 4, fb_w=fb_w)
    want = jdf._plan_fallback(src, dst, 250, 4, fb_w=fb_w)
    assert got[-1] == want[-1] == (skew == "hub")
    assert len(got) == len(want) == (4 if weighted else 3)
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bucket_by", ["dst", "src"])
def test_bucket_fallback_matches_jax(bucket_by):
    from cugraph_gnn_tpu.ops import dist_full_batch as jdf

    src, dst, w = _fallback_coo(np.random.default_rng(2), "even")
    for fb_w in (None, w):
        got = DF._bucket_fallback(src, dst, 300, 4, bucket_by=bucket_by,
                                  localize=bucket_by, fb_w=fb_w)
        want = jdf._bucket_fallback(src, dst, 300, 4, bucket_by=bucket_by,
                                    localize=bucket_by, fb_w=fb_w)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    empty = np.zeros(0, np.int32)
    assert all(a.shape == (0,) for a in DF._bucket_fallback(empty, empty, 300, 4))


@pytest.mark.parametrize("weighted", [False, True])
def test_segment_plan_and_add_match_numpy(weighted):
    """``segment_plan`` keeps each row's slots in the order of the ids and
    drops ids of -1 and past the rows; ``segment_add`` adds the (weighted)
    value rows into its output in place (on the CPU the plain version)."""
    from cugraph_gnn_tpu_torch.store.dist_array import segment_add, segment_plan

    rng = np.random.default_rng(3)
    n, e, f = 50, 400, 5
    ids = rng.integers(-1, n + 5, e)
    w = rng.standard_normal(e).astype(np.float32) if weighted else None
    plan = segment_plan(torch.as_tensor(ids), n, None if w is None else torch.as_tensor(w))
    ok = (ids >= 0) & (ids < n)
    order = np.flatnonzero(ok)[np.argsort(ids[ok], kind="stable")]
    kept = len(order)
    np.testing.assert_array_equal(plan.cols.numpy()[:kept], order)
    np.testing.assert_array_equal(plan.rows.numpy()[:kept], ids[order])
    assert (plan.rows.numpy()[kept:] == -1).all()
    np.testing.assert_array_equal(plan.rowptr.numpy(),
                                  np.searchsorted(ids[order], np.arange(n + 1)))
    vals = rng.integers(-8, 8, (e, f)).astype(np.float32)
    base = rng.integers(-8, 8, (n, f)).astype(np.float32)
    out = torch.as_tensor(base.copy())
    assert segment_add(out, plan, torch.as_tensor(vals)) is out
    want = base.copy()
    np.add.at(want, ids[ok], vals[ok] * (1 if w is None else w[ok][:, None]))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-5)


def _exchange_worker(rank, world, store):
    """One rank: every exchange against numpy indexing of the whole array."""
    from cugraph_gnn_tpu_torch.store.dist_array import (
        _dist_gather_shard,
        _dist_scatter_shard,
        put_global,
    )
    from cugraph_gnn_tpu_torch.utils import distributed as D

    torch.set_num_threads(1)     # the ranks share the CPU cores
    mesh = D.init(init_method=f"file://{store}", rank=rank, world_size=world, device="cpu")
    try:
        assert D.world_info()[:2] == (rank, world) and mesh.shape == {"store": world}
        rng = np.random.default_rng(0)                 # the same on every rank
        total, f, r_blk = 37, 3, 2
        book = PartitionBook.even(total, world)
        table = rng.integers(-50, 50, (book.padded_total, f)).astype(np.float32)
        table[total:] = 0
        mine = put_global(table, mesh)
        rs = book.shard_size
        np.testing.assert_array_equal(mine.numpy(), table[rank * rs:(rank + 1) * rs])

        my = np.random.default_rng(rank + 1)
        ids = my.integers(-1, total, 25)
        got = _dist_gather_shard(mine, torch.as_tensor(ids), book=book, mesh=mesh, fill=-7)
        want = np.where((ids >= 0)[:, None], table[np.maximum(ids, 0)], -7)
        np.testing.assert_array_equal(got.numpy(), want)
        empty = _dist_gather_shard(mine, torch.zeros(0, dtype=torch.int64), book=book,
                                   mesh=mesh)
        assert empty.shape == (0, f)

        def whole(shard):
            parts = [torch.empty_like(shard) for _ in range(world)]
            torch.distributed.all_gather(parts, shard)
            return torch.cat(parts).numpy()

        # set: a permutation of the rows split over the ranks (no repeats)
        perm = rng.permutation(total)
        share = np.array_split(perm, world)[rank]
        vals = -np.arange(len(share) * f, dtype=np.float32).reshape(-1, f) - 100 * rank
        got = whole(_dist_scatter_shard(mine, torch.as_tensor(share),
                                        torch.as_tensor(vals), book=book, mesh=mesh,
                                        mode="set"))
        want = table.copy()
        for w, part in enumerate(np.array_split(perm, world)):
            want[part] = -np.arange(len(part) * f, dtype=np.float32).reshape(-1, f) - 100 * w
        np.testing.assert_array_equal(got, want)

        # add: repeated ids accumulate, -1 ids are dropped
        want = table.copy()
        for w in range(world):
            r = np.random.default_rng(w + 10)
            ids_w = r.integers(-1, total, 30)
            vals_w = r.integers(-5, 5, (30, f)).astype(np.float32)
            if w == rank:
                ids_m, vals_m = ids_w, vals_w
            np.add.at(want, ids_w[ids_w >= 0], vals_w[ids_w >= 0])
        got = whole(_dist_scatter_shard(mine, torch.as_tensor(ids_m), torch.as_tensor(vals_m),
                                        book=book, mesh=mesh, mode="add"))
        np.testing.assert_array_equal(got, want)

        # a round-robin book: gather, set and add through DistArray, and
        # DistMatrix's edge gather over an even book
        from cugraph_gnn_tpu_torch.store import DistArray, DistMatrix

        rr = DistArray.from_array(table[:total], mesh, book=RoundRobinBook(total, world))
        np.testing.assert_array_equal(rr.to_global().numpy(), table[:total])
        ids = my.integers(-1, total, 25)
        np.testing.assert_array_equal(
            rr.gather(torch.as_tensor(ids), fill=-7).numpy(),
            np.where((ids >= 0)[:, None], table[np.maximum(ids, 0)], -7))
        rr.scatter(torch.as_tensor(share), torch.as_tensor(vals))
        rr.scatter_add(torch.as_tensor(ids_m), torch.as_tensor(vals_m))
        want = table[:total].copy()
        for w, part in enumerate(np.array_split(perm, world)):
            want[part] = -np.arange(len(part) * f, dtype=np.float32).reshape(-1, f) - 100 * w
        for w in range(world):
            r = np.random.default_rng(w + 10)
            ids_w, vals_w = r.integers(-1, total, 30), r.integers(-5, 5, (30, f))
            np.add.at(want, ids_w[ids_w >= 0], vals_w[ids_w >= 0].astype(np.float32))
        np.testing.assert_array_equal(rr.to_global().numpy(), want)
        src, dst = _coo_edges()
        dm = DistMatrix.from_coo(src, dst, mesh)
        eids = my.integers(0, len(src), 20)
        got_s, got_d = dm.gather_edges(torch.as_tensor(eids))
        np.testing.assert_array_equal(got_s.numpy(), src[eids])
        np.testing.assert_array_equal(got_d.numpy(), dst[eids])
        np.testing.assert_array_equal(torch.stack(dm.to_global()).numpy(), np.stack([src, dst]))

        # halo exchange: the rows around this rank's, zeros past the ends
        ext = DF._halo_exchange(mine, r_blk, mesh)
        np.testing.assert_array_equal(
            ext.numpy(), DF.halo_rows(torch.as_tensor(table), rank, rs, r_blk).numpy())
        # halo reduce: each rank's (rs + 2R) contributions land on the rows
        # they cover, the outer margins of the end ranks dropped
        acc = np.zeros((book.padded_total + 2 * r_blk, f), np.float32)
        for w in range(world):
            c = np.random.default_rng(w + 20).integers(-9, 9, (rs + 2 * r_blk, f))
            if w == rank:
                c_mine = c.astype(np.float32)
            acc[w * rs:w * rs + rs + 2 * r_blk] += c
        got = DF._halo_reduce(torch.as_tensor(c_mine), r_blk, mesh)
        np.testing.assert_array_equal(got.numpy(),
                                      acc[r_blk + rank * rs:r_blk + (rank + 1) * rs])
    finally:
        D.finalize()


@pytest.mark.parametrize("world", [2, 4])
def test_dist_exchanges_match_numpy(world, tmp_path):
    """Gather (-1 ids filled, empty batch), scatter set and add, halo
    exchange and halo reduce, each rank against the whole array; gloo, one
    spawned world running every check."""
    mp.spawn(_exchange_worker, args=(world, os.path.join(tmp_path, "store")),
             nprocs=world, join=True)


def test_halo_rows_pads_the_ends():
    x = torch.arange(12.0).reshape(6, 2)
    np.testing.assert_array_equal(DF.halo_rows(x, 0, 3, 1).numpy(),
                                  np.concatenate([np.zeros((1, 2)), x[:4].numpy()]))
    np.testing.assert_array_equal(DF.halo_rows(x, 1, 3, 1).numpy(),
                                  np.concatenate([x[2:].numpy(), np.zeros((1, 2))]))


# -- round-robin books, files, DistMatrix, renumbering (no process group) ----------------

def _cpu_mesh(rank, world):
    return Mesh(group=None, rank=rank, world=world, device=torch.device("cpu"), backend="gloo")


def _coo_edges():
    rng = np.random.default_rng(8)
    return rng.integers(0, 50, 37), rng.integers(0, 50, 37)


@pytest.mark.parametrize("total,world", [(10, 4), (23, 4), (7, 7), (5, 8), (0, 3)])
def test_round_robin_book_matches_jax(total, world):
    from cugraph_gnn_tpu.store import partition as jp

    book, jbook = RoundRobinBook(total, world), jp.RoundRobinBook(total, world)
    assert (book.shard_size, book.padded_total, book.is_even) == (
        jbook.shard_size, jbook.padded_total, jbook.is_even)
    np.testing.assert_array_equal(book.counts, jbook.counts)
    np.testing.assert_array_equal(book.offsets, jbook.offsets)
    ids = np.arange(total + world)
    t = torch.as_tensor(ids)
    for got, want in ((book.owner_of(t), jbook.owner_of(ids)),
                      (book.local_offset(t), jbook.local_offset(ids)),
                      (book.to_padded(t), jbook.to_padded(ids))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(book.owner_of_np(ids), jbook.owner_of_np(ids))
    np.testing.assert_array_equal(book.local_offset_np(ids), jbook.local_offset_np(ids))


@pytest.mark.parametrize("kind", ["even", "round_robin"])
def test_dist_array_from_array_and_file_match_jax(kind, tmp_path):
    """Each rank's shard from a whole array, a ``.npy`` file and a ``.pt``
    file (memory-mapped) is JAX's rows of that rank in its padded layout."""
    from cugraph_gnn_tpu.parallel.mesh import create_store_mesh
    from cugraph_gnn_tpu.store import partition as jp
    from cugraph_gnn_tpu.store.dist_array import DistArray as JaxDistArray

    from cugraph_gnn_tpu_torch.store import DistArray

    world, total = 4, 23
    host = np.random.default_rng(9).standard_normal((total, 3)).astype(np.float32)
    np.save(tmp_path / "a.npy", host)
    torch.save(torch.as_tensor(host), tmp_path / "a.pt")
    book = None if kind == "even" else RoundRobinBook(total, world)
    jbook = None if kind == "even" else jp.RoundRobinBook(total, world)
    mesh = create_store_mesh(world)
    for jarr in (JaxDistArray.from_array(host, mesh, book=jbook),
                 JaxDistArray.from_file(str(tmp_path / "a.npy"), mesh, book=jbook)):
        want = np.asarray(jarr.data).reshape(world, -1, 3)
        for r in range(world):
            m = _cpu_mesh(r, world)
            for got in (DistArray.from_array(host, m, book=book),
                        DistArray.from_file(str(tmp_path / "a.npy"), m, book=book),
                        DistArray.from_file(str(tmp_path / "a.pt"), m, book=book),
                        DistArray.from_file(str(tmp_path / "a.npy"), m, book=book,
                                            dtype=torch.bfloat16)):
                assert got.book.shard_size == jarr.book.shard_size
                np.testing.assert_array_equal(got.data.float().numpy(),
                                              torch.as_tensor(np.array(want[r])).to(got.dtype)
                                              .float().numpy())
    with pytest.raises(ValueError, match="npy"):
        DistArray.from_file(str(tmp_path / "a.bin"), _cpu_mesh(0, world))


def test_dist_matrix_matches_jax():
    """Each rank's local COO is JAX's; JAX's edge gather is the numpy one
    that the port's gather (in the spawned worlds above) matches."""
    import jax
    import jax.numpy as jnp

    from cugraph_gnn_tpu.parallel.mesh import create_store_mesh
    from cugraph_gnn_tpu.store.dist_matrix import DistMatrix as JaxDistMatrix

    from cugraph_gnn_tpu_torch.store import DistMatrix

    src, dst = _coo_edges()
    world = 4
    jm = JaxDistMatrix.from_coo(src, dst, create_store_mesh(world))
    for r in range(world):
        pm = DistMatrix.from_coo(src, dst, _cpu_mesh(r, world))
        assert pm.num_edges == jm.num_edges and pm.book.shard_size == jm.book.shard_size
        for got, want in zip(pm.local_coo(r), jm.local_coo(r)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    eids = np.random.default_rng(2).integers(0, len(src), 20).astype(np.int32)
    js, jd = jax.jit(jm.gather_edges)(jnp.asarray(eids))   # its shard_map, compiled
    np.testing.assert_array_equal(np.asarray(js), src[eids])
    np.testing.assert_array_equal(np.asarray(jd), dst[eids])


def test_renumber_kg_matches_jax():
    """Maps, renumbered edges and counts equal JAX's; unknown ids raise
    (strict) or give -1."""
    from cugraph_gnn_tpu.utils import renumber as jr

    from cugraph_gnn_tpu_torch.utils import renumber as pr

    rng = np.random.default_rng(4)
    users = [rng.choice(10**9, 30, replace=False), rng.choice(10**9, 20, replace=False)]
    items = rng.choice(10**9, 25, replace=False)
    extra_item = 10**9 + 7                      # an endpoint no node file lists
    clicks = [(users[0][rng.integers(0, 30, 40)], items[rng.integers(0, 25, 40)]),
              (users[1][rng.integers(0, 20, 30)],
               np.r_[items[rng.integers(0, 25, 29)], extra_item])]
    args = ({"user": users, "item": [items]}, {("user", "clicks", "item"): clicks})
    for endpoints in (True, False):
        if not endpoints:
            with pytest.raises(KeyError):
                pr.renumber_kg(*args, include_edge_endpoints=False)
            continue
        got = pr.renumber_kg(*args, include_edge_endpoints=endpoints)
        want = jr.renumber_kg(*args, include_edge_endpoints=endpoints)
        assert got.num_nodes == want.num_nodes
        for t in want.maps:
            np.testing.assert_array_equal(got.maps[t], want.maps[t])
        for et in want.edges:
            for a, b in zip(got.edges[et], want.edges[et]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    rmap = pr.build_renumber_map([items])
    probe = np.r_[items[:3], 5]
    np.testing.assert_array_equal(pr.apply_renumber_map(rmap, probe, strict=False),
                                  jr.apply_renumber_map(jr.build_renumber_map([items]), probe,
                                                        strict=False))
    assert pr.build_renumber_map([]).shape == (0,)
