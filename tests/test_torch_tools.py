"""Port parity of the utilities: datasets, node-split batching, the native
degree histogram and file-list reads (exact, against the JAX package);
profiling (the meter, regions and the trace file) on the CPU; and the DCP
checkpoints of ``DistArray`` and ``DistEmbedding`` in one spawned gloo world
of 2: the restored shards, books and optimizer state equal the saved ones,
the sidecar equals the one the JAX package writes for the same array and
book, and a restore at another world size raises.

The JAX package is imported inside the tests, not at the top: the spawned
workers import this file and run torch alone.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch.parallel.mesh import Mesh
from cugraph_gnn_tpu_torch.utils import data_loader, datasets, orbax_ckpt, profiling

# -- datasets ----------------------------------------------------------------------------


@pytest.mark.parametrize("power_law", [False, True])
@pytest.mark.parametrize("n,e,seed", [(50, 300, 0), (1000, 7, 3), (3, 40, 9)])
def test_random_graph_and_symmetrize_match_jax(n, e, seed, power_law):
    from cugraph_gnn_tpu.utils import datasets as jd

    got = datasets.random_graph(n, e, seed=seed, power_law=power_law)
    want = jd.random_graph(n, e, seed=seed, power_law=power_law)
    for g, w in ((got, want), (datasets.symmetrize(got), jd.symmetrize(want))):
        assert g.num_nodes == w.num_nodes and g.num_edges == w.num_edges
        for a, b in ((g.src, w.src), (g.dst, w.dst)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert g.edge_weight is None and w.edge_weight is None


def test_load_karate_and_weighted_symmetrize_match_jax(tmp_path):
    from cugraph_gnn_tpu.utils import datasets as jd

    rng = np.random.default_rng(4)
    rows = np.stack([rng.integers(0, 34, 78), rng.integers(0, 34, 78), rng.random(78)], 1)
    path = tmp_path / "karate.csv"
    np.savetxt(path, rows, fmt=["%d", "%d", "%.6f"], delimiter=" ")
    got, want = datasets.load_karate(str(path)), jd.load_karate(str(path))
    assert got.num_nodes == want.num_nodes
    for g, w in ((got, want), (datasets.symmetrize(got), jd.symmetrize(want))):
        for a, b in zip((g.src, g.dst, g.edge_weight), (w.src, w.dst, w.edge_weight)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.savetxt(tmp_path / "two.csv", rows[:, :2], fmt="%d")
    assert datasets.load_karate(str(tmp_path / "two.csv")).edge_weight is None


# -- node splits and batches -------------------------------------------------------------


def test_node_splits_match_jax():
    from cugraph_gnn_tpu.utils import data_loader as jdl

    rng = np.random.default_rng(2)
    d = {f"{s}_{k}": rng.integers(0, 99, 10 + i) for i, s in enumerate(("train", "valid", "test"))
         for k in ("idx", "label")}
    for a, b in zip(data_loader.create_node_classification_datasets(d),
                    jdl.create_node_classification_datasets(d)):
        assert len(a) == len(b)
        for x, y in ((a.idx, b.idx), (a.label, b.label)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="mismatch"):
        data_loader.NodeSplit(np.arange(3), np.arange(4))


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("replicas", [1, 3, 4])
def test_iterate_batches_match_jax(replicas, drop_last):
    from cugraph_gnn_tpu.utils import data_loader as jdl

    rng = np.random.default_rng(replicas)
    split = data_loader.NodeSplit(rng.permutation(103), rng.integers(0, 5, 103))
    jsplit = jdl.NodeSplit(split.idx, split.label)
    for epoch, shuffle, bs in ((0, True, 8), (1, True, 8), (2, False, 5), (0, True, 40)):
        kw = dict(num_replicas=replicas, shuffle=shuffle, drop_last=drop_last, seed=7,
                  epoch=epoch)
        for r in range(replicas):
            got = list(data_loader.iterate_batches(split, bs, replica_id=r, **kw))
            want = list(jdl.iterate_batches(jsplit, bs, replica_id=r, **kw))
            assert len(got) == len(want) == data_loader.num_batches(
                103, bs, num_replicas=replicas, drop_last=drop_last) == jdl.num_batches(
                103, bs, num_replicas=replicas, drop_last=drop_last)
            for (a, b), (c, d) in zip(got, want):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError, match="replica_id"):
        next(data_loader.iterate_batches(split, 4, replica_id=replicas, num_replicas=replicas))


# -- native host code ----------------------------------------------------------------------


@pytest.fixture
def jax_native_numpy(monkeypatch):
    """The JAX package's native module on its NumPy path: marked as tried
    with no library, so that it neither runs ``make -C cpp`` nor loads the
    tracked library."""
    from cugraph_gnn_tpu import native as jn

    monkeypatch.setattr(jn, "_tried", True)
    monkeypatch.setattr(jn, "_lib", None)
    return jn


def test_degrees_match_jax(jax_native_numpy):
    rng = np.random.default_rng(6)
    key = rng.integers(0, 500, 20_000).astype(np.int32)
    want = jax_native_numpy.degrees(key, 600)
    for got in (_native.degrees(key, 600), _native.degrees_np(key, 600)):
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_native.degrees(np.zeros(0, np.int32), 4), np.zeros(4))


def test_load_filelist_bytes_match_jax(jax_native_numpy, tmp_path):
    """Ranges inside one file, across each boundary (an empty file among
    them) and over the whole list, with 1 and 3 threads and O_DIRECT."""
    assert _native.have_native()
    rng = np.random.default_rng(7)
    paths = []
    for i, size in enumerate((4099, 0, 70_001, 1)):
        paths.append(str(tmp_path / f"part_{i}.bin"))
        rng.integers(0, 256, size, dtype=np.uint8).tofile(paths[-1])
    total = 4099 + 70_001 + 1
    for off, length in ((0, total), (17, 100), (4000, 5000), (4098, 70_002), (total - 1, 1),
                        (10, 0)):
        want = jax_native_numpy.load_filelist_bytes(paths, off, length)
        for got in (_native.load_filelist_bytes(paths, off, length, num_threads=3),
                    _native.load_filelist_bytes(paths, off, length, num_threads=1,
                                                use_direct=True),
                    _native.load_filelist_bytes_np(paths, off, length)):
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)


# -- profiling ---------------------------------------------------------------------------------


def test_meter_runs_and_records():
    meter = profiling.PerformanceMeter(warmup=1, iters=3, device="cpu")
    ms = meter.run(lambda acc: acc + torch.sum(torch.ones((8, 8)) * 2.0) / 128.0,
                   name="toy", bytes_per_iter=1e6, items_per_iter=64)
    assert ms > 0
    assert meter.metrics["toy"] == ms
    assert meter.metrics["toy_gbps"] > 0
    assert meter.metrics["toy_items_per_s"] > 0
    assert any("toy" in line for line in meter.report())


def test_annotate_and_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as t:
        with profiling.annotate("region-under-test"):
            out = torch.arange(4) * 2
    assert out.tolist() == [0, 2, 4, 6]
    assert os.path.dirname(t.path) == str(tmp_path / "tr")
    events = json.load(open(t.path))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "region-under-test" in names and "aten::mul" in names
    with profiling.annotate("no-profiler"):    # a region outside a trace costs nothing
        pass


# -- DCP checkpoints ---------------------------------------------------------------------------

CK_ROWS, CK_DIM, EMB_ROWS, EMB_DIM = 37, 3, 60, 8


def _host_array():
    return np.random.default_rng(11).standard_normal((CK_ROWS, CK_DIM)).astype(np.float32)


def _ckpt_worker(rank, world, store, root):
    """One rank: save and restore a float32 and a bfloat16 array (even and
    round-robin books) and a trained lazy-Adam embedding; the restored
    shards, books and state equal the saved ones, and training on from the
    restored embedding matches training on from the original."""
    from cugraph_gnn_tpu_torch.embedding import DistEmbedding
    from cugraph_gnn_tpu_torch.store.dist_array import DistArray
    from cugraph_gnn_tpu_torch.store.partition import RoundRobinBook
    from cugraph_gnn_tpu_torch.utils import distributed as D

    torch.set_num_threads(1)     # the ranks share the CPU cores
    mesh = D.init(init_method=f"file://{store}", rank=rank, world_size=world, device="cpu")
    try:
        host = _host_array()
        arrays = {"f32": DistArray.from_array(host, mesh),
                  "bf16": DistArray.from_array(host, mesh, dtype=torch.bfloat16),
                  "rr": DistArray.from_array(host, mesh, book=RoundRobinBook(CK_ROWS, world))}
        for name, arr in arrays.items():
            path = os.path.join(root, name)
            orbax_ckpt.save_dist_array(path, arr)
            back = orbax_ckpt.restore_dist_array(path, mesh)
            assert back.data.dtype == arr.data.dtype and torch.equal(back.data, arr.data)
            assert type(back.book) is type(arr.book)
            np.testing.assert_array_equal(back.book.counts, arr.book.counts)
            assert back.book.shard_size == arr.book.shard_size
            np.testing.assert_array_equal(back.to_global().float().numpy(),
                                          torch.as_tensor(host).to(arr.dtype).float().numpy())
        emb = DistEmbedding.create(EMB_ROWS, EMB_DIM, mesh, optimizer="lazy_adam", seed=3)
        ids = torch.arange(12) * 5 % EMB_ROWS + rank
        grads = torch.full((12, EMB_DIM), 0.3)
        emb.add_gradients(ids, grads)
        emb.apply_gradients(lr=0.05)
        path = os.path.join(root, "emb")
        orbax_ckpt.save_embedding(path, emb)
        back = orbax_ckpt.restore_embedding(path, mesh)
        assert back.optimizer == "lazy_adam" and sorted(back._state) == sorted(emb._state)
        assert torch.equal(back.table.data, emb.table.data)
        assert all(torch.equal(back._state[k], emb._state[k]) for k in emb._state)
        for e in (emb, back):
            e.add_gradients(ids, grads)
            e.apply_gradients(lr=0.05)
        assert torch.equal(back.table.data, emb.table.data)
    finally:
        D.finalize()


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    """The checkpoints one spawned gloo world of 2 wrote (and checked)."""
    root = tmp_path_factory.mktemp("dcp")
    mp.spawn(_ckpt_worker, args=(2, str(root / "store"), str(root)), nprocs=2, join=True)
    return root


def test_checkpoint_round_trips_at_world_2(ckpt_root):
    for name in ("f32", "bf16", "rr", "emb"):
        files = os.listdir(ckpt_root / name)
        assert "dist_meta.json" in files and ".metadata" in files


def test_sidecars_match_jax(ckpt_root, tmp_path):
    """The JAX package's orbax save of the same array (f32 and bf16, even
    and round-robin books) and of a lazy-Adam embedding of the same shape
    on a 2-device mesh writes the same ``dist_meta.json``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from cugraph_gnn_tpu.embedding import DistEmbedding as JEmb
    from cugraph_gnn_tpu.parallel import STORE_AXIS
    from cugraph_gnn_tpu.store.dist_array import DistArray as JArr
    from cugraph_gnn_tpu.store.partition import RoundRobinBook as JRR
    from cugraph_gnn_tpu.utils import orbax_ckpt as jck

    jmesh = JMesh(np.array(jax.devices()[:2]), (STORE_AXIS,))
    host = _host_array()
    cases = {"f32": JArr.from_array(host, jmesh),
             "bf16": JArr.from_array(jnp.asarray(host, jnp.bfloat16), jmesh),
             "rr": JArr.from_array(host, jmesh, book=JRR(CK_ROWS, 2))}
    for name, arr in cases.items():
        jck.save_dist_array(str(tmp_path / name), arr)
    jck.save_embedding(str(tmp_path / "emb"),
                       JEmb.create(EMB_ROWS, EMB_DIM, jmesh, optimizer="lazy_adam"))
    for name in ("f32", "bf16", "rr", "emb"):
        got = (ckpt_root / name / "dist_meta.json").read_text()
        assert got == (tmp_path / name / "dist_meta.json").read_text(), name


def test_restore_at_another_world_raises(ckpt_root):
    one = Mesh(group=None, rank=0, world=1, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="world_size=2"):
        orbax_ckpt.restore_dist_array(str(ckpt_root / "f32"), one)
    with pytest.raises(ValueError, match="world_size=2"):
        orbax_ckpt.restore_embedding(str(ckpt_root / "emb"), one)
