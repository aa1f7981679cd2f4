"""Port parity: the distributed sampler against the JAX package's.

- The partition books (``edge_balanced``, ``from_counts``, ``even``) against
  JAX's: offsets, counts, shard sizes and every query, exactly.
- ``DistGraph.from_global_csr``'s shards against JAX's (the JAX shards carry
  line padding past the edges), and ``from_shard_files`` equal to it, per
  rank with no process group (neither exchanges anything).
- In spawned gloo worlds of 2 and 4 ranks against JAX's
  ``DistNeighborSampler`` on a 2- and 4-device CPU mesh, with the JAX draws
  replayed: uniform in the static layout, deduplicated and capped,
  weighted, temporal (deduplicated), and 64-bit edge ids.  Each rank's
  levels, blocks (local and global ids, edge ids and their high plane) and
  the global level counts are exact.  ``from_local_coo`` of the ranks'
  slices of the COO equals ``from_global_csr`` of the whole.

The JAX draws are over each owner's receive buffer (``u`` of hop h on rank
r: ``uniform(fold_in(fold_in(key, h), r), (W * t, k))``, rows in sender
order, each sender's targets stably sorted by owner, -1 pads with the last
rank's); the port's frame is the same rows without the pads.  The JAX
package is imported inside fixtures and tests only: the spawned ranks import
this file and run torch alone.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cugraph_gnn_tpu_torch.parallel.mesh import Mesh
from cugraph_gnn_tpu_torch.sampler.dist_sampler import DistGraph
from cugraph_gnn_tpu_torch.store.partition import PartitionBook

N, E = 200, 2400
PER = 12                  # seeds a rank
FANOUTS = (3, 2)
CASES = {
    "uniform": dict(dedup=False),
    "dedup": dict(dedup=True, max_unique_per_hop=(30, 60)),
    "weighted": dict(dedup=False, weights=True),
    "temporal": dict(dedup=True, times=True),
    "bits64": dict(dedup=False, edge_id_bits=64),
}
KEY_SEED = 11


def _coo():
    """A COO with a hub (node 7 takes 300 in-edges, so edge-balanced shards
    are uneven), f32 weights (some zero) and int32 times."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, N, E).astype(np.int64)
    dst = rng.integers(0, N, E).astype(np.int64)
    dst[:300] = 7
    w = rng.uniform(0.1, 1.0, E).astype(np.float32)
    w[::17] = 0
    t = rng.integers(0, 100, E).astype(np.int32)
    return src, dst, w, t


def _csr(src, dst, *attrs):
    """The reversed CSR (rows = dst, each row's edges in COO order)."""
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=N))]).astype(np.int64)
    return (indptr, src[order].astype(np.int32)) + tuple(a[order] for a in attrs)


def _seeds(world):
    rng = np.random.default_rng(world)
    seeds = rng.integers(0, N, world * PER).astype(np.int32)
    seeds[::5] = -1
    seeds[3] = 7                              # the hub
    return seeds, rng.integers(40, 100, world * PER).astype(np.int32)


def _cpu_mesh(rank, world):
    """A rank's mesh without a process group, for the constructors that
    exchange nothing."""
    return Mesh(group=None, rank=rank, world=world, device=torch.device("cpu"),
                backend="gloo")


# -- books -----------------------------------------------------------------------

def _assert_book_equal(book, jbook, ids):
    assert (book.total, book.world_size, book.shard_size, book.padded_total, book.is_even) == (
        jbook.total, jbook.world_size, jbook.shard_size, jbook.padded_total, jbook.is_even)
    np.testing.assert_array_equal(book.offsets, jbook.offsets)
    np.testing.assert_array_equal(book.counts, jbook.counts)
    np.testing.assert_array_equal(book.owner_of_np(ids), jbook.owner_of_np(ids))
    np.testing.assert_array_equal(book.local_offset_np(ids), jbook.local_offset_np(ids))
    t = torch.as_tensor(ids)
    for got, want in ((book.owner_of(t), jbook.owner_of(ids)),
                      (book.local_offset(t), jbook.local_offset(ids)),
                      (book.to_padded(t), jbook.to_padded(ids))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("world", [1, 2, 3, 4, 7])
def test_edge_balanced_book_matches_jax(world):
    """Edge-balanced cuts on a hub graph (some ranks empty at 7) and on an
    empty one; ``from_counts`` of the same counts is the same book."""
    from cugraph_gnn_tpu.store import partition as jp

    indptr = _csr(*_coo()[:2])[0]
    for ip in (indptr, np.zeros(6, np.int64)):
        book = PartitionBook.edge_balanced(ip, world)
        jbook = jp.PartitionBook.edge_balanced(ip, world)
        _assert_book_equal(book, jbook, np.arange(len(ip) - 1))
        again = PartitionBook.from_counts(book.counts)
        _assert_book_equal(again, jp.PartitionBook.from_counts(jbook.counts),
                           np.arange(len(ip) - 1))


@pytest.mark.parametrize("counts", [[5, 0, 3, 9], [4, 4, 4, 2], [0, 0, 6], [10]])
def test_from_counts_book_matches_jax(counts):
    from cugraph_gnn_tpu.store import partition as jp

    book = PartitionBook.from_counts(counts)
    _assert_book_equal(book, jp.PartitionBook.from_counts(counts), np.arange(book.total))
    assert book.is_even == (counts == [4, 4, 4, 2] or counts == [10])


# -- shards without a process group ------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_from_global_csr_shards_match_jax(world):
    """Each rank's rebased indptr, global column ids, weights, times, edge
    bases, degree bound and book equal JAX's shard r (its padding aside)."""
    from cugraph_gnn_tpu.parallel.mesh import create_store_mesh
    from cugraph_gnn_tpu.sampler.dist_sampler import DistGraph as JaxDistGraph

    src, dst, w, t = _coo()
    indptr, indices, wc, tc = _csr(src, dst, w, t)
    jg = JaxDistGraph.from_global_csr(indptr, indices, create_store_mesh(world),
                                      weights=wc, times=tc)
    rps = jg.rows_per_shard
    jip = np.asarray(jg.indptr).reshape(world, rps + 1)
    jix, jw, jt = (np.asarray(a).reshape(world, -1) for a in (jg.indices, jg.weights, jg.times))
    for r in range(world):
        g = DistGraph.from_global_csr(indptr, indices, _cpu_mesh(r, world), weights=wc,
                                      times=tc)
        np.testing.assert_array_equal(g.book.offsets, jg.book.offsets)
        count, e_r = int(g.book.counts[r]), g.indices.shape[0]
        assert g.indptr.dtype == g.indices.dtype == torch.int32
        np.testing.assert_array_equal(g.indptr.numpy(), jip[r, :count + 1])
        for got, want in ((g.indices, jix), (g.weights, jw), (g.times, jt)):
            np.testing.assert_array_equal(got.numpy(), want[r, :e_r])
        np.testing.assert_array_equal(g.edge_base, np.asarray(jg.edge_base))
        assert (g.max_degree, g.edge_id_bits, g.rows_per_shard) == (jg.max_degree, 32, rps)
    g64 = DistGraph.from_global_csr(indptr, indices, _cpu_mesh(world - 1, world),
                                    edge_id_bits=64)
    assert g64.edge_id_bits == 64


def test_from_shard_files_equals_global(tmp_path):
    """Three edge files (the COO split unevenly) with weights and times:
    every rank's shard equals ``from_global_csr`` of the COO, with the
    default edge-balanced book and with a given one."""
    src, dst, w, t = _coo()
    parts = np.split(np.arange(E), [700, 1900])
    files = {k: [] for k in ("e", "w", "t")}
    for i, p in enumerate(parts):
        for k, a in (("e", np.stack([src[p], dst[p]], 1)), ("w", w[p]), ("t", t[p])):
            files[k].append(str(tmp_path / f"{k}{i}.npy"))
            np.save(files[k][-1], a)
    indptr, indices, wc, tc = _csr(src, dst, w, t)
    for world, book in ((3, None), (4, PartitionBook.from_counts([60, 0, 90, 50]))):
        for r in range(world):
            mesh = _cpu_mesh(r, world)
            want = DistGraph.from_global_csr(indptr, indices, mesh, weights=wc, times=tc,
                                             book=book)
            got = DistGraph.from_shard_files(files["e"], N, mesh, weights_files=files["w"],
                                             times_files=files["t"], book=book)
            _assert_graph_equal(got, want)


def _assert_graph_equal(got, want):
    np.testing.assert_array_equal(got.book.offsets, want.book.offsets)
    for a, b in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.weights, want.weights), (got.times, want.times)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(got.edge_base, want.edge_base)
    assert (got.max_degree, got.edge_id_bits) == (want.max_degree, want.edge_id_bits)


# -- the sampler in gloo worlds ----------------------------------------------------

def _graph_for(case, mesh):
    src, dst, w, t = _coo()
    indptr, indices, wc, tc = _csr(src, dst, w, t)
    spec = CASES[case]
    return DistGraph.from_global_csr(
        indptr, indices, mesh, weights=wc if spec.get("weights") else None,
        times=tc if spec.get("times") else None, edge_id_bits=spec.get("edge_id_bits"))


def _worker(rank, world, store, out_dir):
    """One rank: every case sampled on this rank's seeds with the replayed
    draws; ``from_local_coo`` of this rank's slice.  Saves out_{rank}.npz."""
    from cugraph_gnn_tpu_torch.sampler.dist_sampler import DistNeighborSampler
    from cugraph_gnn_tpu_torch.utils import distributed as D

    torch.set_num_threads(1)     # the ranks share the CPU cores
    mesh = D.init(init_method=f"file://{store}", rank=rank, world_size=world, device="cpu")
    try:
        draws = np.load(os.path.join(out_dir, "draws.npz"))
        seeds, times = (a[rank * PER:(rank + 1) * PER] for a in _seeds(world))
        res = {}
        for case, spec in CASES.items():
            g = _graph_for(case, mesh)
            sampler = DistNeighborSampler(g, FANOUTS, dedup=spec["dedup"],
                                          max_unique_per_hop=spec.get("max_unique_per_hop"))
            kw = {}
            if spec.get("weights") or spec.get("times"):
                kw["hash_keys"] = [draws[f"{case}/k/{h}/{rank}"] for h in range(len(FANOUTS))]
            else:
                kw["u"] = [torch.as_tensor(draws[f"{case}/u/{h}/{rank}"])
                           for h in range(len(FANOUTS))]
            b = sampler.sample(torch.as_tensor(seeds),
                               torch.as_tensor(times) if spec.get("times") else None, **kw)
            for i, lv in enumerate(b.levels):
                res[f"{case}/level/{i}"] = lv.numpy()
            res[f"{case}/counts"] = torch.stack(b.level_counts).numpy()
            for h, hop in enumerate(b.hops):
                for name in ("neigh_local", "neigh_global", "edge_ids", "edge_hi"):
                    if getattr(hop, name) is not None:
                        res[f"{case}/hop/{h}/{name}"] = getattr(hop, name).numpy()
        src, dst, w, t = _coo()
        mine = np.array_split(np.arange(E), world)[rank]
        local = DistGraph.from_local_coo(src[mine], dst[mine], N, mesh, weights=w[mine],
                                         times=t[mine], chunk=97)
        indptr, indices, wc, tc = _csr(src, dst, w, t)
        want = DistGraph.from_global_csr(indptr, indices, mesh, weights=wc, times=tc)
        for name in ("indptr", "indices", "weights", "times"):
            res[f"local/{name}"] = getattr(local, name).numpy()
            res[f"global/{name}"] = getattr(want, name).numpy()
        for name in ("edge_base", "book_offsets", "max_degree"):
            pick = {"book_offsets": lambda g: g.book.offsets, "edge_base": lambda g: g.edge_base,
                    "max_degree": lambda g: np.array(g.max_degree)}[name]
            res[f"local/{name}"], res[f"global/{name}"] = pick(local), pick(want)
        np.savez(os.path.join(out_dir, f"out_{rank}.npz"), **res)
    finally:
        D.finalize()


def _frames(targets, jbook, world):
    """For each owner r, the JAX receive buffer's rows (sender-major, each
    sender's targets stably by owner, -1 pads with the last rank) that hold
    real ids: the rows of the port's frame."""
    t = targets.shape[1]
    owner = np.clip(jbook.owner_of_np(np.maximum(targets, 0)), 0, world - 1)
    owner = np.where(targets >= 0, owner, world - 1)
    out = []
    for r in range(world):
        pos, keep, start = [], [], 0
        for s in range(world):
            mine = np.flatnonzero(owner[s] == r)
            pos.extend(range(start, start + len(mine)))
            keep.extend(targets[s, mine] >= 0)
            start += len(mine)
        out.append(np.asarray(pos, np.int64)[np.asarray(keep, bool)])
        assert start <= world * t
    return out


@pytest.fixture(scope="module")
def want():
    """JAX's batches of every case at worlds 2 and 4 and the port's draws
    (each rank's frame), by world."""
    import jax
    import jax.numpy as jnp

    from cugraph_gnn_tpu.parallel.mesh import create_store_mesh
    from cugraph_gnn_tpu.sampler.dist_sampler import DistGraph as JaxDistGraph
    from cugraph_gnn_tpu.sampler.dist_sampler import DistNeighborSampler as JaxSampler

    src, dst, w, t = _coo()
    indptr, indices, wc, tc = _csr(src, dst, w, t)
    out = {}
    for world in (2, 4):
        mesh = create_store_mesh(world)
        seeds, times = _seeds(world)
        key = jax.random.PRNGKey(KEY_SEED)
        res, draws = {}, {}
        for case, spec in CASES.items():
            g = JaxDistGraph.from_global_csr(
                indptr, indices, mesh, weights=wc if spec.get("weights") else None,
                times=tc if spec.get("times") else None,
                edge_id_bits=spec.get("edge_id_bits"))
            sampler = JaxSampler(g, FANOUTS, dedup=spec["dedup"],
                                 max_unique_per_hop=spec.get("max_unique_per_hop"))
            b = sampler.sample(key, jnp.asarray(seeds),
                               jnp.asarray(times) if spec.get("times") else None)
            levels = [np.asarray(lv).reshape(world, -1) for lv in b.levels]
            res[case] = b
            for h, k in enumerate(FANOUTS):
                frames = _frames(levels[h], g.book, world)
                for r in range(world):
                    skey = jax.random.fold_in(jax.random.fold_in(key, h), r)
                    if spec.get("weights") or spec.get("times"):
                        fold = 0 if spec.get("weights") else 1
                        draws[f"{case}/k/{h}/{r}"] = np.asarray(jax.random.key_data(
                            jax.random.fold_in(skey, fold)))[-2:].astype(np.int64)
                    else:
                        u = np.asarray(jax.random.uniform(skey, (world * levels[h].shape[1], k)))
                        draws[f"{case}/u/{h}/{r}"] = u[frames[r]]
        out[world] = (res, draws)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def got(request, want, tmp_path_factory):
    """Every rank's results at a gloo world of 2 or 4: (per-rank dicts,
    world)."""
    world = request.param
    out_dir = tmp_path_factory.mktemp(f"dist_sampler_world{world}")
    np.savez(out_dir / "draws.npz", **want[world][1])
    mp.spawn(_worker, args=(world, str(out_dir / "store"), str(out_dir)), nprocs=world,
             join=True)
    return [dict(np.load(out_dir / f"out_{r}.npz")) for r in range(world)], world


@pytest.mark.parametrize("case", list(CASES))
def test_dist_sampler_matches_jax(got, want, case):
    """Each rank's levels and blocks are JAX's shard r exactly, the level
    counts JAX's global ones; hop blocks of 64-bit graphs carry JAX's high
    plane."""
    ranks, world = got
    b = want[world][0][case]
    levels = [np.asarray(lv).reshape(world, -1) for lv in b.levels]
    for r, res in enumerate(ranks):
        for i, lv in enumerate(levels):
            np.testing.assert_array_equal(res[f"{case}/level/{i}"], lv[r], err_msg=f"level {i}")
        np.testing.assert_array_equal(res[f"{case}/counts"],
                                      [int(c) for c in b.level_counts])
        for h, hop in enumerate(b.hops):
            t = levels[h].shape[1]
            for name in ("neigh_local", "neigh_global", "edge_ids", "edge_hi"):
                jv = getattr(hop, name)
                assert (jv is None) == (f"{case}/hop/{h}/{name}" not in res)
                if jv is not None:
                    np.testing.assert_array_equal(
                        res[f"{case}/hop/{h}/{name}"],
                        np.asarray(jv).reshape(world, t, -1)[r], err_msg=f"hop {h} {name}")
    if case == "bits64":
        assert any((r["bits64/hop/0/edge_ids"] >= 0).any() for r in ranks)
    assert any((r[f"{case}/hop/1/neigh_global"] >= 0).any() for r in ranks)


def test_from_local_coo_equals_global(got):
    """The ranks' slices routed to their owners (in rounds of 97 edges)
    build each rank's shard of the whole COO's CSR, bit for bit."""
    ranks, _ = got
    for res in ranks:
        for name in ("indptr", "indices", "weights", "times", "edge_base", "book_offsets",
                     "max_degree"):
            a, b = res[f"local/{name}"], res[f"global/{name}"]
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_mesh_axis_size():
    """The flat mesh's one axis, and the hierarchical mesh's axes and their
    tuple (the product); an axis the mesh lacks raises."""
    from cugraph_gnn_tpu_torch.parallel.mesh import HierarchicalMesh
    from cugraph_gnn_tpu_torch.store.dist_array import mesh_axis_size

    mesh = _cpu_mesh(1, 4)
    assert mesh_axis_size(mesh) == mesh_axis_size(mesh, "store") == 4
    with pytest.raises(ValueError, match="axis"):
        mesh_axis_size(mesh, "node")
    with pytest.raises(ValueError, match="axis"):
        mesh_axis_size(mesh, ("node", "device"))
    hm = HierarchicalMesh(group=None, rank=5, world=6, device=torch.device("cpu"),
                          backend="gloo", num_nodes=3, devices_per_node=2,
                          device_mesh=_cpu_mesh(1, 2), node_mesh=_cpu_mesh(2, 3))
    assert mesh_axis_size(hm) == mesh_axis_size(hm, ("node", "device")) == 6
    assert (mesh_axis_size(hm, "node"), mesh_axis_size(hm, "device")) == (3, 2)
