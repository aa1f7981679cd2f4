"""Port parity: the embedding caches and the host-located feature store,
PyTorch port against the JAX package on the same numpy inputs, on the CPU.

- ``DeviceLFUCache``: gathered rows exact after every batch; tags, counters,
  hits and misses equal.  When more than ``ways`` misses land in one set,
  or a miss lands in set 0 or in the set of id -1 (where the JAX insert
  also writes its non-miss entries back), which of two writes to one slot
  wins is unspecified in XLA; the ids here avoid those sets and no set gets
  more than ``ways`` entries a batch, so the metadata is comparable.
- ``DeviceLFUCache`` with an overfilled set and -1 pads: gathered rows and
  a later hit exact against the host rows, the (set, way) pairs a batch
  writes distinct.
- ``HostManagedCache``: batches that evict, a prefetch with matching ids and
  one with other ids, ``update`` (cached and written-through ids), then
  ``flush``: tags, counters, modified bits, hits and misses exactly JAX's
  after each call; gathered rows and the host rows exact.  A stress run of
  prefetches against gathers and updates with the interpreter switching
  threads every microsecond.
- ``CachedHostEmbedding``: three adagrad steps; host table after ``flush``
  and optimizer state within 1e-6.
- ``FeatureStore(location="host")``: a float table (kind ``host``), an int64
  label column (``host1d``) and a table without a cache, gathered and read
  whole, against the JAX store (values compared: JAX holds int64 labels as
  int32).
- The slice as a whole: the example's loop (``examples/
  cached_embedding_training.py``) of GraphSAGE + ``CachedHostEmbedding``
  (adagrad) + Adam for three steps on a small graph, with the JAX sampler's
  draws fed to the port's sampler, at the example's default learning rate
  (3e-3); losses within 1e-5 relative, the gathered rows and the flushed
  tables within 1e-5 (AdaGrad's first step, lr * g / (|g| + 1e-8), turns
  sum-order noise in a gradient near 1e-8 into up to lr).
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.nn import functional as F

from cugraph_gnn_tpu.data import FeatureStore as JaxFeatureStore
from cugraph_gnn_tpu.embedding import CachedHostEmbedding as JaxCachedHostEmbedding
from cugraph_gnn_tpu.embedding import HostManagedCache as JaxHostManagedCache
from cugraph_gnn_tpu.embedding.cache import CachePolicy as JaxCachePolicy
from cugraph_gnn_tpu.embedding.cache import DeviceLFUCache as JaxDeviceLFUCache
from cugraph_gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from cugraph_gnn_tpu.native import build_csr
from cugraph_gnn_tpu.sampler import NeighborSampler as JaxNeighborSampler
from cugraph_gnn_tpu_torch.data import FeatureStore
from cugraph_gnn_tpu_torch.embedding import CachedHostEmbedding, HostManagedCache
from cugraph_gnn_tpu_torch.embedding.cache import CachePolicy, DeviceLFUCache
from cugraph_gnn_tpu_torch.embedding.convert import embedding_from_jax_arrays
from cugraph_gnn_tpu_torch.models.convert import graphsage_from_flax
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import NeighborSampler

N, DIM = 300, 16


def _table(seed=0, n=N, dim=DIM):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def _expected_rows(table, ids):
    ok = (ids >= 0) & (ids < len(table))
    return np.where(ok[:, None], table[np.clip(ids, 0, len(table) - 1)], 0)


# -- DeviceLFUCache ----------------------------------------------------------------

def test_device_lfu_cache_matches_jax():
    host = _table(1)
    port = DeviceLFUCache(host, capacity=64, ways=4, device="cpu")
    ref = JaxDeviceLFUCache(host, capacity=64, ways=4)
    assert port.sets == ref.sets == 16
    sets = port._set_of(torch.arange(N)).numpy()
    avoid = {0, int(port._set_of(torch.tensor(-1)))}
    pool = np.array([i for i in range(N) if sets[i] not in avoid])
    rng = np.random.default_rng(2)
    for batch in range(6):
        # at most `ways` entries a set, a few repeats and -1 pads
        ids = []
        for s in rng.permutation(16):
            cand = pool[sets[pool] == s]
            ids += list(rng.choice(cand, min(len(cand), rng.integers(0, 4)), replace=True))
        ids = np.array((ids + [-1] * 42)[:42], np.int64)     # one shape: one JAX compile
        got = port.gather(torch.as_tensor(ids))
        want = ref.gather(jnp.asarray(ids, jnp.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), _expected_rows(host, ids))
        np.testing.assert_array_equal(port.tags.numpy(), np.asarray(ref.tags))
        np.testing.assert_array_equal(port.freq.numpy(), np.asarray(ref.freq))
        assert (port.hits, port.misses) == (ref.hits, ref.misses)
    assert port.hits > 0 and port.hit_rate == ref.hit_rate
    port.drop_all()
    assert (port.tags == -1).all() and port.hits == port.misses == 0
    assert CachePolicy("none").capacity_for(100) == JaxCachePolicy("none").capacity_for(100) == 0
    assert CachePolicy().capacity_for(1000) == JaxCachePolicy().capacity_for(1000)


def overfilled_batches(cache, n, rng):
    """Batches that send more than ``ways`` distinct misses into one set
    (set 0 among them), with repeats and -1 pads between them."""
    sets = cache._set_of(torch.arange(n)).numpy()
    crowded = np.nonzero(sets == 0)[0]
    assert len(crowded) > 2 * cache.ways
    out = []
    for _ in range(3):
        ids = np.concatenate([rng.choice(crowded, 2 * cache.ways, replace=False),
                              rng.integers(0, n, 20), [-1] * 7])
        ids[::6] = -1
        out.append(rng.permutation(ids).astype(np.int64))
    return out


def test_device_lfu_cache_overfilled_set():
    """More than ``ways`` misses a set and -1 pads: every gathered row is the
    host row, no two inserts of a batch share a (set, way) (a repeated miss
    takes two ways, as in JAX), and a later gather of the cached ids hits with the host rows."""
    host = _table(5)
    cache = DeviceLFUCache(host, capacity=16, ways=4, device="cpu")
    slots = []
    choose = cache._insert_slots

    def spy(ids):
        eligible, es, ew = choose(ids)
        slots.append((es.numpy(), ew.numpy()))
        return eligible, es, ew

    cache._insert_slots = spy
    rng = np.random.default_rng(6)
    for ids in overfilled_batches(cache, N, rng):
        got = cache.gather(torch.as_tensor(ids))
        np.testing.assert_array_equal(got.numpy(), _expected_rows(host, ids))
        es, ew = slots[-1]
        pairs = set(zip(es.tolist(), ew.tolist()))
        assert len(pairs) == len(es) > 0
        assert (np.bincount(es, minlength=cache.sets) <= cache.ways).all()
        tags = cache.tags.numpy()
        cached = tags[tags >= 0]
        hits = cache.hits
        again = cache.gather(torch.as_tensor(cached))
        assert cache.hits == hits + len(cached)
        np.testing.assert_array_equal(again.numpy(), host[cached])
        np.testing.assert_array_equal(
            cache.rows.numpy()[tags >= 0], host[cached])


# -- HostManagedCache --------------------------------------------------------------

def _assert_same_meta(port, ref):
    np.testing.assert_array_equal(port.tags, ref.tags)
    np.testing.assert_array_equal(port.freq, ref.freq)
    np.testing.assert_array_equal(port.modified, ref.modified)
    assert (port.hits, port.misses) == (ref.hits, ref.misses)


def test_host_managed_cache_matches_jax():
    host = _table(3)
    port = HostManagedCache(host.copy(), capacity=64, ways=8, device="cpu")
    ref = JaxHostManagedCache(host.copy(), capacity=64, ways=8)
    rng = np.random.default_rng(4)
    evicted = 0

    def batch(n=70):
        ids = rng.integers(0, N // 2, n)          # half the rows: hits recur
        ids[::9] = -1
        ids[1] = N + 5                            # past the end: a zero row
        return ids

    def gather(ids, prefetch=None):
        nonlocal evicted
        if prefetch is not None:
            port.prefetch(torch.as_tensor(prefetch))
            ref.prefetch(prefetch)
        got = port.gather(torch.as_tensor(ids))
        want = ref.gather(ids)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), _expected_rows(truth, ids))
        _assert_same_meta(port, ref)
        evicted = port.written_back

    truth = host.copy()          # the rows a gather must see
    for _ in range(3):
        gather(batch())
    for step in range(3):
        ids = np.unique(rng.integers(0, N // 2, 30))
        new = rng.standard_normal((len(ids), DIM)).astype(np.float32)
        port.update(ids, torch.as_tensor(new))
        ref.update(ids, jnp.asarray(new))
        truth[ids] = new
        _assert_same_meta(port, ref)
        np.testing.assert_array_equal(port.host_rows, ref.host_rows)   # written through
        nxt = batch()
        gather(nxt, prefetch=nxt)                 # the prefetched plan is taken
        gather(batch(), prefetch=batch())         # other ids: applied, then re-planned
    assert evicted > 0 and port.modified.any()
    assert port.uploaded > 0 and port.hits > 0 and port.misses > 0
    port.flush()
    ref.flush()
    _assert_same_meta(port, ref)
    assert not port.modified.any()
    np.testing.assert_array_equal(port.host_rows, ref.host_rows)
    np.testing.assert_array_equal(port.host_rows, truth)
    port.drop_all()
    assert (port.tags == -1).all() and port.hits == 0


def test_host_managed_cache_prefetch_stress():
    """The prefetch thread plans while the caller runs: with the interpreter
    switching threads every microsecond, 40 rounds of prefetch, gather
    (the prefetched ids or others) and update keep every gathered row equal
    to the store's, and the metadata to a cache that never prefetched."""
    host = _table(9)
    cache = HostManagedCache(host.copy(), capacity=48, ways=4, device="cpu")
    plain = HostManagedCache(host.copy(), capacity=48, ways=4, device="cpu")
    truth = host.copy()
    rng = np.random.default_rng(10)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t0 = time.perf_counter()
    try:
        for i in range(40):
            nxt = rng.integers(-1, N // 3, 60)
            cache.prefetch(nxt)
            ids = nxt if i % 3 else rng.integers(-1, N // 3, 60)
            if i % 3 == 0:                 # the prefetched plan is applied first
                plain.gather(nxt)
            np.testing.assert_array_equal(cache.gather(ids).numpy(), _expected_rows(truth, ids))
            plain.gather(ids)
            upd = np.unique(rng.integers(0, N // 3, 10))
            new = rng.standard_normal((len(upd), DIM)).astype(np.float32)
            for c in (cache, plain):
                c.update(upd, torch.as_tensor(new))
            truth[upd] = new
            _assert_same_meta(cache, plain)
    finally:
        sys.setswitchinterval(old)
    assert time.perf_counter() - t0 < 60
    cache.flush()
    np.testing.assert_array_equal(cache.host_rows, truth)


def test_cached_host_embedding_matches_jax():
    host = _table(5)
    hyper = {"weight_decay": 0.01}
    port = CachedHostEmbedding(host.copy(), optimizer="adagrad", hyper=hyper, capacity=64,
                               ways=8, device="cpu")
    ref = JaxCachedHostEmbedding(host.copy(), optimizer="adagrad", hyper=hyper, capacity=64,
                                 ways=8)
    rng = np.random.default_rng(6)
    for step in range(3):
        ids = rng.integers(0, N, 80)
        ids[::11] = -1
        grads = rng.standard_normal((80, DIM)).astype(np.float32)
        np.testing.assert_array_equal(port.gather(torch.as_tensor(ids)).numpy(),
                                      np.asarray(ref.gather(ids)))
        port.add_gradients(torch.as_tensor(ids), torch.as_tensor(grads))
        ref.add_gradients(ids, grads)
        port.apply_gradients(0.1)
        ref.apply_gradients(0.1)
        _assert_same_meta(port.cache, ref.cache)
    assert port.cache.written_back > 0
    port.flush()
    ref.flush()
    np.testing.assert_allclose(port.host_table, ref.host_table, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port._state["state_sum"], ref._state["state_sum"], rtol=1e-6,
                               atol=1e-6)
    again = embedding_from_jax_arrays(ref.host_table, ref._state, "adagrad", hyper,
                                      capacity=64, device="cpu")
    np.testing.assert_array_equal(again.host_table, ref.host_table)
    np.testing.assert_array_equal(again._state["state_sum"], ref._state["state_sum"])
    tap = port.make_tap(5)
    assert tap.requires_grad and tap.shape == (5, DIM) and port.hit_rate == ref.hit_rate


# -- FeatureStore(location="host") -------------------------------------------------

def test_feature_store_host_matches_jax():
    rng = np.random.default_rng(7)
    x = _table(8, dim=6)
    y = rng.integers(0, 2**40, N)             # int64 labels (JAX holds them in int32)
    y_small = y % 1000
    policy = (CachePolicy(cache_ratio=0.1, ways=4), JaxCachePolicy(cache_ratio=0.1, ways=4))
    port = FeatureStore(pad_features_to=4, device="cpu")
    ref = JaxFeatureStore(pad_features_to=4)
    for fs, pol in ((port, policy[0]), (ref, policy[1])):
        fs.put_tensor(x, "", "x", location="host", cache_policy=pol)
        fs.put_tensor(y_small, "", "y", location="host", cache_policy=pol)
        fs.put_tensor(x, "", "raw", location="host",
                      cache_policy=type(pol)(kind="none"))
    port.put_tensor(y, "", "y64", location="host")
    for _ in range(3):
        ids = rng.integers(-1, N, 50)
        ids[0] = N + 2
        port.prefetch("", "x", torch.as_tensor(ids))
        ref.prefetch("", "x", ids)
        for attr in ("x", "y", "raw"):
            got = port.get_tensor("", attr, ids=torch.as_tensor(ids))
            want = np.asarray(ref.get_tensor("", attr, ids=jnp.asarray(ids)))
            np.testing.assert_array_equal(got.numpy(), want)
        got = port.get_tensor("", "y64", ids=torch.as_tensor(ids))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.where(
            (ids >= 0) & (ids < N), y[np.clip(ids, 0, N - 1)], 0))
    _, (_, cache) = port._store[("", "x")]
    _assert_same_meta(cache, ref._store[("", "x")][1][1])
    assert cache.rows.shape[-1] == 8 and cache.hits > 0
    for attr in ("x", "y", "raw"):
        np.testing.assert_array_equal(port[attr].numpy(), np.asarray(ref[attr]))
        assert port.get_tensor_size("", attr) == ref.get_tensor_size("", attr)
    np.testing.assert_array_equal(port["y64"].numpy(), y)
    with pytest.raises(ValueError, match="location"):
        port.put_tensor(x, "", "z", location="disk")
    port.remove_tensor("", "x")
    assert "x" not in port


# -- the slice as a whole ---------------------------------------------------------

def test_cached_embedding_training_matches_jax():
    """examples/cached_embedding_training.py's loop at a small size."""
    n, e, dim, hidden, classes, batch, fanouts, lr = 400, 2400, 16, 16, 8, 32, (4, 3), 3e-3
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    indptr, indices, _ = build_csr(dst, src, n)
    labels = rng.integers(0, classes, n).astype(np.int32)
    host = (0.05 * rng.standard_normal((n, dim))).astype(np.float32)
    ref = JaxCachedHostEmbedding(host.copy(), optimizer="adagrad", cache_ratio=0.1, ways=8)
    port = CachedHostEmbedding(host.copy(), optimizer="adagrad", cache_ratio=0.1, ways=8,
                               device="cpu")
    jsampler = JaxNeighborSampler(jnp.asarray(indptr), jnp.asarray(indices), fanouts)
    psampler = NeighborSampler(indptr, indices, fanouts, device="cpu")

    def both(key, seeds):
        """The JAX sample and the port's from the same draws."""
        caps = psampler.level_caps(len(seeds))
        u = [np.array(jax.random.uniform(jax.random.fold_in(key, h), (caps[h], k)))
             for h, k in enumerate(fanouts)]
        return (jsampler.sample(key, jnp.asarray(seeds)),
                psampler.sample(torch.as_tensor(seeds), u=u))

    model = JaxGraphSAGE(hidden_features=hidden, out_features=classes, num_layers=2)
    key = jax.random.PRNGKey(0)
    js0, ps0 = both(key, np.arange(batch, dtype=np.int32))
    params = model.init(key, ref.gather(js0.input_nodes) + ref.make_tap(
        int(js0.input_nodes.shape[0])), js0)
    port.gather(ps0.input_nodes)                  # the example's init gather
    tx = optax.adam(lr)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, rows, tap, sample, y):
        def loss_fn(p, t):
            logits = model.apply(p, rows + t, sample)
            valid = sample.levels[0] >= 0
            ls = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return jnp.sum(jnp.where(valid, ls, 0)) / jnp.maximum(jnp.sum(valid), 1)
        loss, (gp, gt) = jax.value_and_grad(loss_fn, argnums=(0, 1))(params, tap)
        u, opt = tx.update(gp, opt)
        return optax.apply_updates(params, u), opt, loss, gt

    pmodel = graphsage_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    popt = torch.optim.Adam(pmodel.parameters(), lr=lr)
    for i in range(3):
        kk = jax.random.fold_in(jax.random.fold_in(key, 0), i)
        seeds = np.asarray(jax.random.randint(kk, (batch,), 0, n, jnp.int32))
        js, ps = both(kk, seeds)
        np.testing.assert_array_equal(ps.input_nodes.numpy(), np.asarray(js.input_nodes))
        rows = ref.gather(js.input_nodes)
        y = jnp.asarray(labels)[jnp.clip(jnp.asarray(seeds), 0)]
        params, opt, loss, g_tap = step(params, opt, rows, ref.make_tap(
            int(js.input_nodes.shape[0])), js, y)
        ref.add_gradients(js.input_nodes, g_tap)
        ref.apply_gradients(lr=lr)

        prows = port.gather(ps.input_nodes)
        np.testing.assert_allclose(prows.numpy(), np.asarray(rows), rtol=0, atol=1e-5)
        tap = port.make_tap(prows.shape[0])
        popt.zero_grad(set_to_none=True)
        logits = pmodel(prows + tap, ps).float()
        valid = ps.levels[0] >= 0
        ls = F.cross_entropy(logits, torch.as_tensor(labels[seeds]).long(), reduction="none")
        ploss = torch.where(valid, ls, 0).sum() / valid.sum().clamp(min=1)
        ploss.backward()
        popt.step()
        port.add_gradients(ps.input_nodes, tap.grad)
        port.apply_gradients(lr=lr)
        np.testing.assert_allclose(float(ploss.detach()), float(loss), rtol=1e-5)
        _assert_same_meta(port.cache, ref.cache)
    port.flush()
    ref.flush()
    np.testing.assert_allclose(port.host_table, ref.host_table, rtol=1e-5, atol=1e-5)
    assert not np.array_equal(port.host_table, host)
