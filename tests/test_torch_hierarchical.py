"""Port parity: the hierarchical (node, device) mesh and gather against the
JAX package's.

In a spawned gloo world of 4 ranks made a 2 x 2 mesh
(``create_hierarchical_mesh(2)``), against JAX's ``HierarchicalDistArray``
on ``create_hierarchical_mesh(2, devices[:4])`` (the cases of
``tests/test_hierarchical.py`` at 2 x 2): random ids, duplicates and pads,
ids all on one rank, ids that both ranks of a node ask for (deduplicated
before they cross between nodes) and mixed ownership.  Each rank's rows and
its cross-node id count are exact.  Also: ``auto_mesh`` with
``LOCAL_WORLD_SIZE=2`` gives the 2 x 2 mesh and without it the flat one,
``get_hierarchical_mesh`` / ``get_global_mesh``, ``split_mesh`` (each pair's
collective stays in the pair), ``to_global``, and a homogeneous
``DistNeighborLoader`` on the hierarchical mesh (its gathers through the
two-level gather) equal to the flat mesh's, batch for batch.

JAX is imported inside the fixture only: the spawned ranks import this file
and run torch alone.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

N, F, B = 64, 4, 16       # rows, width, ids a rank (rank r owns rows 16r..16r+15)
WORLD = 4


def _table():
    return np.random.default_rng(0).standard_normal((N, F)).astype(np.float32)


def _cases():
    """Each case's ids, (WORLD, B): rank r queries row r."""
    rng = np.random.default_rng(1)
    dup = np.array([5, 5, -1, 63, 5, 0, -1, 17, 3, 3, 3, 3, -1, -1, 2, 1])
    mixed = [np.r_[48, 49, 50, 51, 0, 1, 2, 3, 48, 48, 4, 5, 6, 7, -1, 8],
             np.r_[50, 51, 52, 53, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31],
             np.arange(32, 48), np.arange(32, 48)[::-1]]
    return {
        "random": rng.integers(0, N, (WORLD, B)),
        "dup_pads": np.stack([np.roll(dup, r) for r in range(WORLD)]),
        "skewed": rng.integers(0, 8, (WORLD, B)),
        # every rank asks for rows 32-39 of rank 2 (node 1, column 0) twice:
        # node 0's 32 requests meet at its column-0 rank, and 8 ids cross
        # between the nodes; node 1 holds them itself
        "siblings": np.tile(np.r_[np.arange(32, 40), np.arange(32, 40)], (WORLD, 1)),
        # node 0 asks rank 3 (node 1, column 1) for 48-53 in overlapping
        # sets: they meet at node 0's column-1 rank, and 6 ids cross, not 10
        "mixed": np.stack(mixed),
    }


def _data():
    rng = np.random.default_rng(5)
    n, e = 90, 700
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, F)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    return src, dst, x, y


def _worker(rank, world, store, out_dir):
    from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
    from cugraph_gnn_tpu_torch.loader import DistNeighborLoader, auto_mesh
    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import read_rows
    from cugraph_gnn_tpu_torch.parallel.mesh import (
        HierarchicalMesh,
        create_hierarchical_mesh,
        split_mesh,
    )
    from cugraph_gnn_tpu_torch.store.hierarchical import HierarchicalDistArray
    from cugraph_gnn_tpu_torch.utils import distributed as D

    torch.set_num_threads(1)
    mesh = D.init(init_method=f"file://{store}", rank=rank, world_size=world, device="cpu")
    try:
        res = {}
        hm = create_hierarchical_mesh(2, "cpu")
        res["shape"] = np.array([hm.shape["node"], hm.shape["device"], hm.node,
                                 hm.device_mesh.rank, hm.node_mesh.rank, hm.rank])
        arr = HierarchicalDistArray.from_array(_table(), hm)
        for case, ids in _cases().items():
            rows, cross = arr.gather_with_stats(torch.as_tensor(ids[rank]))
            res[f"{case}/rows"], res[f"{case}/cross"] = rows.numpy(), cross.numpy()
        res["read"] = arr.gather(torch.as_tensor(_cases()["dup_pads"][rank]),
                                 read=read_rows).numpy()
        res["to_global"] = arr.to_global().numpy()

        # the topology: several hosts give the 2 x 2 mesh, one host the flat one
        res["flat_world"] = np.array(auto_mesh("cpu").world)
        os.environ["LOCAL_WORLD_SIZE"] = "2"
        try:
            am = auto_mesh("cpu")
            hier = D.get_hierarchical_mesh("cpu")
            res["auto"] = np.array([isinstance(am, HierarchicalMesh), am.num_nodes,
                                    am.devices_per_node, hier.num_nodes, D.num_hosts()])
            res["auto_axis"] = np.array(am.axis)
            src, dst, x, y = _data()
            batches = {}
            for tag, m in (("flat", D.get_global_mesh("cpu")), ("hier", am)):
                gs, fs = GraphStore(device="cpu"), FeatureStore(device="cpu")
                gs.put_edge_index((src, dst), ("n", "e", "n"), num_nodes=(90, 90))
                fs["x"], fs["y"] = x, y
                ld = DistNeighborLoader((fs, gs), [3, 2], m, batch_size=22, shuffle=True,
                                        dedup=True, seed=4)
                batches[tag] = list(ld)
            for i, (a, b) in enumerate(zip(batches["flat"], batches["hier"])):
                for name, u, v in [("x", a.x, b.x), ("y", a.y, b.y)] + [
                        (f"level{j}", p, q) for j, (p, q) in enumerate(
                            zip(a.sample.levels, b.sample.levels))]:
                    res[f"loader/{i}/{name}/flat"], res[f"loader/{i}/{name}/hier"] = (
                        u.numpy(), v.numpy())
        finally:
            del os.environ["LOCAL_WORLD_SIZE"]

        # split: pairs of ranks; an all-reduce inside a pair sums the pair only
        subs = split_mesh(mesh, 2)
        mine = [s for s in subs if s is not None]
        t = torch.tensor([rank + 1])
        torch.distributed.all_reduce(t, group=mine[0].group)
        res["split"] = np.array([len(subs), subs.index(mine[0]), mine[0].rank,
                                 mine[0].world, int(t)])
        np.savez(os.path.join(out_dir, f"out_{rank}.npz"), **res)
    finally:
        D.finalize()


@pytest.fixture(scope="module")
def want():
    """JAX's rows and cross-node counts of every case on a 2 x 2 mesh (one
    jitted gather)."""
    import jax
    import jax.numpy as jnp

    from cugraph_gnn_tpu.parallel.mesh import create_hierarchical_mesh
    from cugraph_gnn_tpu.store.hierarchical import HierarchicalDistArray

    mesh = create_hierarchical_mesh(2, jax.devices()[:WORLD])
    arr = HierarchicalDistArray.from_array(_table(), mesh)
    gather = jax.jit(arr.gather_with_stats)
    out = {}
    for case, ids in _cases().items():
        rows, stats = gather(jnp.asarray(ids.reshape(-1).astype(np.int32)))
        out[case] = (np.asarray(rows).reshape(WORLD, B, F), np.asarray(stats))
    return out


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("hierarchical")
    mp.spawn(_worker, args=(WORLD, str(out_dir / "store"), str(out_dir)), nprocs=WORLD,
             join=True)
    return [dict(np.load(out_dir / f"out_{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("case", list(_cases()))
def test_hier_gather_matches_jax(got, want, case):
    """Each rank's rows and cross-node id count are JAX's device r's."""
    rows, stats = want[case]
    table = _table()
    ids = _cases()[case]
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res[f"{case}/rows"], rows[r])
        np.testing.assert_array_equal(
            res[f"{case}/rows"], np.where((ids[r] >= 0)[:, None], table[np.maximum(ids[r], 0)],
                                          0))
        assert int(res[f"{case}/cross"][0]) == int(stats[r]), (case, r)
    crossed = [int(res[f"{case}/cross"][0]) for res in got]
    if case == "siblings":
        assert crossed == [8, 0, 0, 0]
    if case == "mixed":
        assert crossed == [0, 6, 0, 0]


def test_hier_mesh_layout_and_read(got):
    """rank = node * 2 + device on the 2 x 2 mesh; the owner's read through
    ``read_rows`` gives the indexed rows; ``to_global`` the whole table."""
    table = _table()
    ids = _cases()["dup_pads"]
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["shape"], [2, 2, r // 2, r % 2, r // 2, r])
        np.testing.assert_array_equal(res["read"], np.where(
            (ids[r] >= 0)[:, None], table[np.maximum(ids[r], 0)], 0))
        np.testing.assert_array_equal(res["to_global"], table)


def test_auto_mesh_selection(got):
    """One host: the flat mesh of 4; ``LOCAL_WORLD_SIZE=2``: the 2 x 2
    (node, device) mesh, as ``get_hierarchical_mesh`` gives it."""
    for res in got:
        assert res["flat_world"] == 4
        np.testing.assert_array_equal(res["auto"], [1, 2, 2, 2, 2])
        assert tuple(res["auto_axis"]) == ("node", "device")


def test_loader_on_hierarchical_mesh_equals_flat(got):
    """Every batch of a shuffled epoch (features and labels through the
    two-level gather) equals the flat mesh's bit for bit."""
    for res in got:
        keys = [k for k in res if k.startswith("loader/") and k.endswith("/flat")]
        assert len(keys) >= 3 * 5
        for k in keys:
            np.testing.assert_array_equal(res[k[:-5] + "/hier"], res[k], err_msg=k)


def test_split_mesh(got):
    """Two sub-meshes of two ranks; this rank's is the one it is in, and an
    all-reduce over it sums its pair (1 + 2, 3 + 4)."""
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["split"], [2, r // 2, r % 2, 2, 3 if r < 2 else 7])
