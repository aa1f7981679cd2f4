"""Port parity: temporal sampling, PyTorch port against the JAX package on
small graphs, on the CPU.

- ``NeighborSampler(edge_times=)`` (the time-masked uniform sampler) and
  ``NeighborSampler(weights=, edge_times=)`` (weighted, time-filtered), in
  the deduplicated and the static layout, with seed times, on JAX's draws
  replayed (uniforms, and key words ``key_data(fold_in(fold_in(key, h), 0 |
  1))``): levels, maps, edge ids and counts exact.  The propagated seed times
  (``propagate_times``, a scatter-min) equal a numpy loop over the JAX batch,
  and every sampled edge is no newer than its target's time.
- ``NeighborLoader(time_attr=, input_time=)`` over a shuffled epoch with a
  padded last batch: exact.
- ``LinkNeighborLoader(time_attr=, edge_label_time=)`` over a shuffled epoch,
  binary (with true-edge rejection) and triplet, with the JAX loader's
  negatives and draws replayed: seeds, per-slot times, levels and maps
  exact.
- The options' errors: ``time_attr`` without seed times and the other way
  round.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_gnn_tpu.data import FeatureStore as JaxFeatureStore
from cugraph_gnn_tpu.data import GraphStore as JaxGraphStore
from cugraph_gnn_tpu.loader import LinkNeighborLoader as JaxLinkNeighborLoader
from cugraph_gnn_tpu.loader import NeighborLoader as JaxNeighborLoader
from cugraph_gnn_tpu.sampler import negative as jax_neg
from cugraph_gnn_tpu.sampler import neighbor_sampler as jax_ns
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader, NeighborLoader
from cugraph_gnn_tpu_torch.loader.link_loader import draw_negatives
from cugraph_gnn_tpu_torch.sampler import negative as port_neg
from cugraph_gnn_tpu_torch.sampler import neighbor_sampler as port_ns

N, FANOUTS, BATCH, SEED, T_MAX = 70, (4, 3), 12, 7, 30
ET = ("n", "to", "n")
NO_TIME = 2**31 - 1


def key_words(key, fold: int):
    return np.asarray(jax.random.key_data(jax.random.fold_in(key, fold)))[-2:]


def replayed(key, caps, fanouts, fold):
    """Hop h's uniforms and key words as the JAX sampler draws them."""
    u, words = [], []
    for h, k in enumerate(fanouts):
        hkey = jax.random.fold_in(key, h)
        u.append(np.array(jax.random.uniform(hkey, (caps[h], k))))
        words.append(key_words(hkey, fold))
    return u, words


def _graph(seed=0, n=N, e=900):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    dst[:60] = 2                                            # a hub row
    t = rng.integers(0, T_MAX, e).astype(np.int64)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    w[rng.random(e) < 0.2] = 0
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = rng.integers(0, 3, n)
    return src, dst, t, w, x, y


def _csr(src, dst, t, w):
    order = np.argsort(dst, kind="stable")
    indptr = np.searchsorted(dst[order], np.arange(N + 1)).astype(np.int32)
    return indptr, src[order].astype(np.int32), t[order], w[order]


def times_np(seed_time, batch):
    """Seed times of every level: targets keep theirs, a new node the
    minimum over the targets that drew it (JAX ``_sample``'s scatter-min)."""
    out = [np.asarray(seed_time).astype(np.int64)]
    for hop, nxt in zip(batch.hops, batch.levels[1:]):
        t = out[-1]
        full = np.full(nxt.shape[-1], NO_TIME, np.int64)
        full[:len(t)] = t
        for i, row in enumerate(np.asarray(hop.neigh_local)):
            for j in row[row >= 0]:
                full[j] = min(full[j], t[i])
        out.append(full)
    return out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dedup", [True, False])
def test_neighbor_sampler_temporal_matches_jax(weighted, dedup):
    src, dst, t, w, _, _ = _graph()
    indptr, indices, et, ew = _csr(src, dst, t, w)
    maxdeg = int(np.diff(indptr).max())
    rng = np.random.default_rng(2)
    seeds = rng.integers(0, N, BATCH).astype(np.int32)
    seeds[[3, 8]] = -1
    seeds[0] = 2
    seed_time = rng.integers(0, T_MAX, BATCH).astype(np.int32)
    key = jax.random.PRNGKey(4)
    wkw = dict(weights=ew) if weighted else {}
    ref = jax_ns.NeighborSampler(indptr, indices, FANOUTS, edge_times=et.astype(np.int32),
                                 max_degree=maxdeg, dedup=dedup, **wkw).sample(
        key, jnp.asarray(seeds), jnp.asarray(seed_time))
    sampler = port_ns.NeighborSampler(indptr, indices, FANOUTS, edge_times=et, dedup=dedup,
                                      device="cpu", **wkw)
    assert sampler.key_based(True) and sampler.key_based(False) == weighted
    u, words = replayed(key, sampler.level_caps(BATCH), FANOUTS, 0 if weighted else 1)
    got = sampler.sample(seeds, seed_time, u=u, hash_keys=words)
    for a, b in zip(got.levels + got.level_counts, ref.levels + ref.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for hp, hr in zip(got.hops, ref.hops):
        for a, b in zip(hp[:3], hr[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the propagated times, and the constraint on every sampled edge
    want_t = times_np(seed_time, ref)
    tt = torch.as_tensor(seed_time)[None]
    sampled = 0
    for h, hop in enumerate(got.hops):
        np.testing.assert_array_equal(tt[0].numpy(), want_t[h])
        e = hop.edge_ids.numpy()
        ok = e >= 0
        assert (et[e[ok]] <= want_t[h][np.nonzero(ok)[0]]).all()
        sampled += int(ok.sum())
        tt = port_ns.propagate_times(tt, hop.neigh_local[None], got.levels[h + 1].shape[0])
    np.testing.assert_array_equal(tt[0].numpy(), want_t[-1])
    assert sampled > 20


def _stores(jax_side, src, dst, x, y=None, **attrs):
    gs, fs = ((JaxGraphStore(), JaxFeatureStore()) if jax_side
              else (GraphStore(device="cpu"), FeatureStore(device="cpu")))
    gs.put_edge_index((src, dst), ET, num_nodes=(N, N))
    fs["x"] = x
    if y is not None:
        fs["y"] = y
    for name, v in attrs.items():
        fs[name] = v
    return fs, gs


class Replay:
    """The port node loader's sampler fed the JAX loader's draws for batch i:
    ``fold_in(fold_in(fold_in(PRNGKey(seed), epoch), i), h)``."""

    def __init__(self, inner, seed):
        self.inner, self.calls = inner, 0
        self.key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)

    def sample(self, seeds, node_times=None, generator=None):
        skey = jax.random.fold_in(self.key, self.calls)
        self.calls += 1
        u, words = replayed(skey, self.inner.level_caps(seeds.shape[0]), self.inner.fanouts,
                            0 if self.inner.weights is not None else 1)
        return self.inner.sample(seeds, node_times, u=u, hash_keys=words)


def _assert_sample_equal(p, r):
    for a, b in zip(p.levels + p.level_counts, r.levels + r.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for hp, hr in zip(p.hops, r.hops):
        for a, b in zip(hp[:3], hr[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_neighbor_loader_time_attr_matches_jax():
    src, dst, t, _, x, y = _graph(3)
    input_time = np.random.default_rng(5).integers(0, T_MAX, N)
    kw = dict(num_neighbors=FANOUTS, batch_size=16, shuffle=True, seed=SEED,
              time_attr="t", input_time=input_time)
    jl = JaxNeighborLoader(_stores(True, src, dst, x, y, t=t), **kw)
    pl = NeighborLoader(_stores(False, src, dst, x, y, t=t), **kw)
    pl.sampler = Replay(pl.sampler, SEED)
    ref, port = list(jl), list(pl)
    assert len(port) == len(ref) == -(-N // 16)
    et = pl.sampler.inner.edge_times.numpy()
    for p, r in zip(port, ref):
        for a, b in ((p.seeds, r.seeds), (p.input_id, r.input_id), (p.x, r.x), (p.y, r.y)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _assert_sample_equal(p.sample, r.sample)
        st = np.where(p.input_id.numpy() >= 0, input_time[p.input_id.numpy()], 0)
        lt = times_np(st, r.sample)
        for h, hop in enumerate(p.sample.hops):
            e = hop.edge_ids.numpy()
            ok = e >= 0
            assert (et[e[ok]] <= lt[h][np.nonzero(ok)[0]]).all()


# -- the temporal link loader -------------------------------------------------------------

def jax_draws(key, n, count, config, *, pinned, rejection):
    """The candidates JAX's ``sample_negative_edges(key, ...)`` draws."""
    k1, k2, k3, _ = jax.random.split(key, 4)

    def choice(k):
        return torch.as_tensor(np.array(jax_neg._weighted_choice(k, n, (count,), None)))

    return port_neg.NegativeDraws(None if pinned else choice(k1), choice(k2),
                                  choice(k3) if rejection else None)


class LinkReplay:
    """The port link loader's negatives and sampler fed the JAX loader's
    keys: ``fold_in(fold_in(PRNGKey(seed), epoch), i)``, then 1 for the
    negatives and 2 for the sampler."""

    def __init__(self, loader, seed):
        self.loader, self.inner = loader, loader.sampler
        self.key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
        self.calls = [0, 0]
        self.times = []
        loader.sampler = self
        loader._negatives = self.negatives

    def _key(self, which):
        key = jax.random.fold_in(jax.random.fold_in(self.key, self.calls[which - 1]), which)
        self.calls[which - 1] += 1
        return key

    def negatives(self, ps, n_neg):
        lo = self.loader
        draws = jax_draws(self._key(1), N, n_neg, lo.neg, pinned=lo.neg.mode == "triplet",
                          rejection=lo._edge_key_sorted is not None)
        return draw_negatives(ps, n_neg, N, N, lo.neg, lo._edge_key_sorted, draws=draws,
                              device="cpu")

    def sample(self, seeds, node_times=None, generator=None):
        self.times.append(node_times)
        u, words = replayed(self._key(2), self.inner.level_caps(seeds.shape[0]),
                            self.inner.fanouts, 1)
        return self.inner.sample(seeds, node_times, u=u, hash_keys=words)


@pytest.mark.parametrize("mode", ["binary", "triplet"])
def test_link_loader_edge_label_time_matches_jax(mode, monkeypatch):
    src, dst, t, _, x, _ = _graph(6)
    rng = np.random.default_rng(8)
    pick = rng.choice(len(src), 40, replace=False)
    eli = np.stack([src[pick], dst[pick]])
    label_time = t[pick] + rng.integers(0, 5, 40)
    neg = "binary" if mode == "binary" else dict(mode="triplet", amount=2)
    kw = dict(num_neighbors=FANOUTS, edge_label_index=eli, batch_size=BATCH, shuffle=True,
              seed=SEED, neg_sampling=neg, reject_true_edges=mode == "binary",
              time_attr="t", edge_label_time=label_time)
    seen = []
    inner_sample = jax_ns.NeighborSampler.sample
    monkeypatch.setattr(jax_ns.NeighborSampler, "sample",
                        lambda self, key, seeds, node_times=None: seen.append(node_times)
                        or inner_sample(self, key, seeds, node_times))
    jl = JaxLinkNeighborLoader(_stores(True, src, dst, x, t=t), **kw)
    pl = LinkNeighborLoader(_stores(False, src, dst, x, t=t), **kw)
    rep = LinkReplay(pl, SEED)
    ref, port = list(jl), list(pl)
    assert len(port) == len(ref) == -(-40 // BATCH)
    for p, r, pt, rt in zip(port, ref, rep.times, seen):
        for a, b in ((p.seeds, r.seeds), (p.edge_label_index, r.edge_label_index),
                     (p.edge_label, r.edge_label), (p.input_id, r.input_id), (p.x, r.x),
                     (pt, rt)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _assert_sample_equal(p.sample, r.sample)
    b = BATCH
    last = rep.times[-1].numpy()
    n_last = 40 - b * (len(port) - 1)
    assert (last[n_last:b] == label_time[jl_order(len(port) - 1)].max()).all()   # pads
    if mode == "triplet":
        np.testing.assert_array_equal(last[2 * b:2 * b + 2 * b], np.repeat(last[:b], 2))


def jl_order(i):
    order = np.arange(40)
    np.random.default_rng(0 + 999).shuffle(order)
    return order[i * BATCH:(i + 1) * BATCH]


def test_temporal_options_refuse_missing_times():
    src, dst, t, _, x, y = _graph(9)
    data = _stores(False, src, dst, x, y, t=t)
    with pytest.raises(ValueError, match="requires input_time"):
        NeighborLoader(data, FANOUTS, time_attr="t")
    eli = np.stack([src[:20], dst[:20]])
    with pytest.raises(ValueError, match="requires edge_label_time"):
        LinkNeighborLoader(data, FANOUTS, eli, time_attr="t")
    with pytest.raises(ValueError, match="requires time_attr"):
        LinkNeighborLoader(data, FANOUTS, eli, edge_label_time=np.zeros(20))
    # without a replay: the generator's draws, reproducible, constraint held
    loaders = [NeighborLoader(data, FANOUTS, batch_size=16, time_attr="t", seed=3,
                              input_time=np.full(N, 10)) for _ in range(2)]
    a, b = (next(iter(ld)) for ld in loaders)
    _assert_sample_equal(a.sample, b.sample)
    et = loaders[0].sampler.edge_times.numpy()
    e = a.sample.hops[0].edge_ids.numpy()
    assert (et[e[e >= 0]] <= 10).all()
