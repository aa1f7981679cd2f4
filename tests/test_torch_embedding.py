"""Port parity: the trainable embeddings, PyTorch port against the JAX
package on the same numpy inputs (made from a seed), on the CPU.

- The four sparse optimizers (and AdamW), one parametrised test: rtol 1e-6,
  atol 1e-7 (each computes in float32; pow and sqrt may differ by an ulp).
- ``dedup_ids_grads``: ids exact; sums within 1e-6 (the port sums each id's
  rows in float32 in the order of the ids, JAX's ``segment_sum`` in another
  order).
- ``DistEmbedding``: two steps each of sgd and lazy_adam at world 1 (a
  one-rank gloo mesh in this process, against a one-device JAX mesh), and
  one lazy_adam step at world 2 (a spawned gloo world, against a two-device
  JAX mesh); table and state within 1e-6, untouched rows exact; the tap's
  gradient is d loss / d rows; lookups exact (against numpy indexing: the
  JAX lookup's first call compiles for ~13 s here).
- Checkpoint: shard files byte-identical to the JAX package's for the same
  array and book; a JAX ``DistEmbedding`` saved at world 2 loads into the
  port at world 1 and the port's files at world 1 load into JAX at world 4.

JAX is imported inside fixtures and tests: the spawned ranks import this
file and run torch alone.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cugraph_gnn_tpu_torch.embedding import SPECS, UPDATE_FNS, DistEmbedding, dedup_ids_grads
from cugraph_gnn_tpu_torch.embedding.convert import embedding_from_jax_arrays
from cugraph_gnn_tpu_torch.store.dist_array import DistArray
from cugraph_gnn_tpu_torch.store.partition import PartitionBook
from cugraph_gnn_tpu_torch.utils import checkpoint as ckpt
from cugraph_gnn_tpu_torch.utils import distributed as D

N, DIM, B = 60, 8, 40
HYPER = {"weight_decay": 0.01}


def _batch(seed, n=N, b=B, dim=DIM):
    """Ids with repeats and -1 padding, and their gradient rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, b)
    ids[::7] = -1
    return ids.astype(np.int32), rng.standard_normal((b, dim)).astype(np.float32)


# -- optimizers and dedup -------------------------------------------------------

@pytest.mark.parametrize("name,hyper", [
    ("sgd", HYPER), ("lazy_adam", HYPER), ("lazy_adam", {"weight_decay": 0.01, "adam_w": True}),
    ("adagrad", HYPER), ("rmsprop", HYPER)])
def test_optimizers_match_jax(name, hyper):
    import jax.numpy as jnp

    from cugraph_gnn_tpu.embedding import optimizers as jopt

    rng = np.random.default_rng(0)
    rows = rng.standard_normal((20, DIM)).astype(np.float32)
    spec, jspec = SPECS[name], jopt.SPECS[name]
    assert spec.state_widths == jspec.state_widths
    assert spec.hyper_defaults == jspec.hyper_defaults
    state = {k: np.abs(rng.standard_normal((20, DIM * w if w else 1))).astype(np.float32)
             for k, w in spec.state_widths.items()}
    if "t" in state:
        state["t"] = rng.integers(0, 5, (20, 1)).astype(np.float32)
    for k, v in spec.init_state(3, DIM).items():
        assert v.dtype == torch.float32 and v.shape == (3, DIM * spec.state_widths[k] or 1)
    for step in range(2):          # twice: the second from the first's state
        grads = rng.standard_normal((20, DIM)).astype(np.float32)
        got_rows, got_state = UPDATE_FNS[name](
            torch.as_tensor(rows), torch.as_tensor(grads),
            {k: torch.as_tensor(v) for k, v in state.items()}, lr=0.05, **hyper)
        want_rows, want_state = jopt.UPDATE_FNS[name](
            jnp.asarray(rows), jnp.asarray(grads),
            {k: jnp.asarray(v) for k, v in state.items()}, lr=jnp.float32(0.05), **hyper)
        np.testing.assert_allclose(got_rows.numpy(), np.asarray(want_rows), rtol=1e-6,
                                   atol=1e-7)
        assert set(got_state) == set(want_state)
        for k in want_state:
            np.testing.assert_allclose(got_state[k].numpy(), np.asarray(want_state[k]),
                                       rtol=1e-6, atol=1e-7)
        rows = np.asarray(want_rows)
        state = {k: np.asarray(v) for k, v in want_state.items()}


@pytest.mark.parametrize("max_unique", [None, 9])
def test_dedup_ids_grads_matches_jax(max_unique):
    import jax.numpy as jnp

    from cugraph_gnn_tpu.embedding import dedup_ids_grads as jdedup

    ids, grads = _batch(1, n=25)
    got_ids, got = dedup_ids_grads(torch.as_tensor(ids), torch.as_tensor(grads), max_unique)
    want_ids, want = jdedup(jnp.asarray(ids), jnp.asarray(grads), max_unique)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert got.shape == (max_unique or B, DIM)
    empty_ids, empty = dedup_ids_grads(torch.zeros(0, dtype=torch.int32),
                                       torch.zeros((0, DIM)))
    assert empty_ids.shape == (0,) and empty.shape == (0, DIM)


# -- DistEmbedding ---------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A one-rank gloo mesh in this process, left at the end of the module."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    m = D.init(init_method=f"file://{store}", rank=0, world_size=1, device="cpu")
    yield m
    D.finalize()


def _jax_embedding(world, host, optimizer):
    from cugraph_gnn_tpu.embedding import DistEmbedding as JaxDistEmbedding
    from cugraph_gnn_tpu.parallel.mesh import create_store_mesh
    from cugraph_gnn_tpu.store.dist_array import DistArray as JaxDistArray

    return JaxDistEmbedding(JaxDistArray.from_array(host.copy(), create_store_mesh(world)),
                            optimizer=optimizer, hyper=HYPER)


def _rows(table, ids):
    """numpy lookup: zero rows at -1."""
    return np.where((ids >= 0)[:, None], table[np.maximum(ids, 0)], 0)


def _jax_state(emb, n=N):
    return {k: np.asarray(v)[:n] for k, v in emb._state.items()}


@pytest.mark.parametrize("optimizer", ["sgd", "lazy_adam"])
def test_dist_embedding_world_1_matches_jax(mesh, optimizer):
    import jax.numpy as jnp

    host = np.random.default_rng(2).standard_normal((N, DIM)).astype(np.float32)
    jemb = _jax_embedding(1, host, optimizer)
    emb = DistEmbedding(DistArray.from_array(host, mesh), optimizer=optimizer, hyper=HYPER)
    touched = np.zeros(N, bool)
    table_before = host
    for step in range(2):
        ids, grads = _batch(10 + step)
        touched[ids[ids >= 0]] = True
        # the tap's gradient is the rows' gradient: loss = sum(rows * grads)
        tap = emb.make_tap(B)
        rows = emb.lookup(tap, torch.as_tensor(ids))
        np.testing.assert_array_equal(rows.detach().numpy(), _rows(table_before, ids))
        (rows * torch.as_tensor(grads)).sum().backward()
        np.testing.assert_array_equal(tap.grad.numpy(), grads)
        emb.add_gradients(torch.as_tensor(ids), tap.grad)
        emb.apply_gradients(lr=0.05)
        jemb.add_gradients(jnp.asarray(ids), jnp.asarray(grads))
        jemb.apply_gradients(lr=0.05)
        table = table_before = emb.table.to_global().numpy()
        np.testing.assert_allclose(table, np.asarray(jemb.table.to_global()), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(table[~touched], host[~touched])
        for k, v in _jax_state(jemb).items():
            np.testing.assert_allclose(emb._state[k].numpy()[:N], v, rtol=1e-6, atol=1e-6)
            assert not emb._state[k].numpy()[~touched].any()
    assert emb[torch.tensor([3, -1])].shape == (2, DIM)
    # the same state carried from JAX's arrays
    again = embedding_from_jax_arrays(np.asarray(jemb.table.to_global()), _jax_state(jemb),
                                      optimizer, HYPER, mesh=mesh)
    for k, v in emb._state.items():
        np.testing.assert_allclose(again._state[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-6)


def _world_2_worker(rank, world, store, host, ids, grads, want_rows, want_table, want_state):
    torch.set_num_threads(1)
    mesh = D.init(init_method=f"file://{store}", rank=rank, world_size=world, device="cpu")
    try:
        emb = DistEmbedding(DistArray.from_array(host, mesh), optimizer="lazy_adam",
                            hyper=HYPER)
        # rank r holds the r-th half of the batch, as JAX's shard_map splits it
        half = slice(rank * B // world, (rank + 1) * B // world)
        mine = torch.as_tensor(ids[half])
        np.testing.assert_array_equal(emb.gather(mine).numpy(), want_rows[half])
        emb.add_gradients(mine, torch.as_tensor(grads[half]))
        emb.apply_gradients(lr=0.05)
        np.testing.assert_allclose(emb.table.to_global().numpy(), want_table, rtol=1e-6,
                                   atol=1e-6)
        for k, v in want_state.items():
            got = DistArray(emb._state[k], emb.table.book, mesh).to_global().numpy()
            np.testing.assert_allclose(got, v, rtol=1e-6, atol=1e-6)
    finally:
        D.finalize()


def test_dist_embedding_world_2_matches_jax(tmp_path):
    """One lazy_adam step over a spawned gloo world of 2 against JAX on two
    devices: the ids and gradients cross to their owners."""
    import jax.numpy as jnp

    host = np.random.default_rng(3).standard_normal((N + 1, DIM)).astype(np.float32)
    ids, grads = _batch(20, n=N + 1)
    jemb = _jax_embedding(2, host, "lazy_adam")
    want_rows = _rows(host, ids)
    jemb.add_gradients(jnp.asarray(ids), jnp.asarray(grads))
    jemb.apply_gradients(lr=0.05)
    mp.spawn(_world_2_worker,
             args=(2, os.path.join(tmp_path, "store"), host, ids, grads, want_rows,
                   np.asarray(jemb.table.to_global()), _jax_state(jemb, N + 1)),
             nprocs=2, join=True)


def test_dist_embedding_create(mesh):
    emb = DistEmbedding.create(N, DIM, mesh, optimizer="adagrad", init_scale=0.5, seed=4)
    again = DistEmbedding.create(N, DIM, mesh, optimizer="adagrad", init_scale=0.5, seed=4)
    t = emb.table.to_global()
    assert t.shape == (N, DIM) and torch.equal(t, again.table.to_global())
    assert 0.3 < float(t.std()) < 0.7
    assert set(emb._state) == {"state_sum"} and not emb._state["state_sum"].any()
    with pytest.raises(ValueError, match="without an optimizer"):
        DistEmbedding(emb.table).apply_gradients(0.1)


# -- checkpoint ------------------------------------------------------------------

def _files(prefix, world):
    return [f"{prefix}_meta.json"] + [f"{prefix}_part_{r}_of_{world}" for r in range(world)]


@pytest.mark.parametrize("dtype,tail", [(np.float32, (DIM,)), (np.int64, ())])
def test_shard_files_byte_identical_to_jax(tmp_path, dtype, tail):
    from cugraph_gnn_tpu.store.partition import PartitionBook as JaxPartitionBook
    from cugraph_gnn_tpu.utils import checkpoint as jckpt

    arr = np.random.default_rng(5).standard_normal((N + 3,) + tail).astype(dtype)
    for world in (1, 3):
        a, b = str(tmp_path / f"port{world}"), str(tmp_path / f"jax{world}")
        ckpt.store_shard_files(a, torch.as_tensor(arr), PartitionBook.even(N + 3, world))
        jckpt.store_shard_files(b, arr, JaxPartitionBook.even(N + 3, world))
        for fa, fb in zip(_files(a, world), _files(b, world)):
            with open(fa, "rb") as x, open(fb, "rb") as y:
                assert x.read() == y.read(), fa
        np.testing.assert_array_equal(ckpt.load_shard_files(b), arr)
        np.testing.assert_array_equal(jckpt.load_shard_files(a), arr)


def test_load_filelist_matches_jax(tmp_path):
    from cugraph_gnn_tpu.store.partition import PartitionBook as JaxPartitionBook
    from cugraph_gnn_tpu.store.partition import RoundRobinBook
    from cugraph_gnn_tpu.utils import checkpoint as jckpt

    arr = np.arange(23 * 3, dtype=np.float32).reshape(23, 3)
    files = [str(tmp_path / f"f{i}") for i in range(3)]
    for f, part in zip(files, np.array_split(arr, 3)):
        part.tofile(f)
    for world, rank, stride in ((None, None, None), (4, 1, None), (4, 3, 5)):
        book = None if world is None else PartitionBook.even(23, world)
        jbook = None if world is None else JaxPartitionBook.even(23, world)
        np.testing.assert_array_equal(
            ckpt.load_filelist(files, np.float32, 3, book, rank, stride),
            jckpt.load_filelist(files, np.float32, 3, jbook, rank, stride))
    # a round-robin book: every rank's rows, in local order, re-strided
    from cugraph_gnn_tpu_torch.store.partition import RoundRobinBook as PortRoundRobinBook

    for rank in range(4):
        for stride in (None, 5):
            np.testing.assert_array_equal(
                ckpt.load_filelist(files, np.float32, 3, PortRoundRobinBook(23, 4), rank,
                                   stride),
                jckpt.load_filelist(files, np.float32, 3, RoundRobinBook(23, 4), rank, stride))


def test_embedding_checkpoint_crosses_packages(tmp_path, mesh):
    """JAX (world 2) saves, the port (world 1) loads; the port saves, JAX
    (world 4) loads; table and every optimizer state equal."""
    import jax.numpy as jnp

    from cugraph_gnn_tpu.utils import checkpoint as jckpt

    host = np.random.default_rng(6).standard_normal((N, DIM)).astype(np.float32)
    jemb = _jax_embedding(2, host, "lazy_adam")
    ids, grads = _batch(30)
    jemb.add_gradients(jnp.asarray(ids), jnp.asarray(grads))
    jemb.apply_gradients(lr=0.05)
    jckpt.save_embedding(str(tmp_path / "jax"), jemb)

    emb = DistEmbedding(DistArray.from_array(np.zeros_like(host), mesh), optimizer="lazy_adam")
    ckpt.load_embedding(str(tmp_path / "jax"), emb)
    np.testing.assert_array_equal(emb.table.to_global().numpy(),
                                  np.asarray(jemb.table.to_global()))
    for k, v in _jax_state(jemb).items():
        np.testing.assert_array_equal(emb._state[k].numpy(), v)

    ckpt.save_embedding(str(tmp_path / "port"), emb)
    back = _jax_embedding(4, np.zeros_like(host), "lazy_adam")
    jckpt.load_embedding(str(tmp_path / "port"), back)
    np.testing.assert_array_equal(np.asarray(back.table.to_global()),
                                  emb.table.to_global().numpy())
    for k, v in _jax_state(back).items():
        np.testing.assert_array_equal(v, emb._state[k].numpy())
