"""Port parity: weighted sampling, PyTorch port against the JAX package on
small graphs, on the CPU.

- The per-edge hash (``threefry_hash`` / ``edge_uniform``) bit-exact against
  ``edge_uniform_np``, ids near 2**31 included, with one key and per-row keys.
- The top-k order: ``_keyed_topk`` (one stable sort of (row, score
  descending)) against JAX's ``_chunked_topk`` (a running ``lax.top_k``) on
  scores with many ties and -inf entries; exact positions, in order.
- ``weighted_sample`` and ``masked_uniform_sample`` on JAX's key words
  (``key_data(fold_in(key, 0 | 1))``), at max_degree 40 and chunk 8 and with
  a ``max_degree`` below the largest degree: neighbors, edge ids, counts and
  positions exact.  Gumbel scores involve two logs, where ``torch.log`` and
  XLA's may differ in the last ulp: a row is compared in order where JAX's
  top k + 1 scores are more than 1e-5 apart, as a set where only its k-th
  and (k+1)-th are, and not at all otherwise (the test requires 90% of rows
  in order).  The masked sampler has no log: exact everywhere.
- ``NeighborSampler(weights=)`` in both layouts, ``NeighborLoader(weight_attr=)``
  over a shuffled epoch and ``GraphStructure``'s weighted samplers, on
  replayed draws: exact.
- ``max_unique_per_hop="auto"``: the heuristics and the loader with the
  memory size pinned on both sides; exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_gnn_tpu import graph_structure as jax_gs
from cugraph_gnn_tpu.data import FeatureStore as JaxFeatureStore
from cugraph_gnn_tpu.data import GraphStore as JaxGraphStore
from cugraph_gnn_tpu.loader import NeighborLoader as JaxNeighborLoader
from cugraph_gnn_tpu.ops import sample as jax_sample
from cugraph_gnn_tpu.sampler import heuristics as jax_heur
from cugraph_gnn_tpu.sampler import neighbor_sampler as jax_ns
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.graph_structure import GraphStructure
from cugraph_gnn_tpu_torch.loader import NeighborLoader
from cugraph_gnn_tpu_torch.ops import sample as port_sample
from cugraph_gnn_tpu_torch.sampler import heuristics as port_heur
from cugraph_gnn_tpu_torch.sampler import neighbor_sampler as port_ns

N, K, MAXDEG, CHUNK = 60, 5, 40, 8
FANOUTS, BATCH, SEED = (4, 3), 12, 5
ET = ("n", "to", "n")


def key_words(key, fold: int):
    """The two words JAX's hash is seeded with: 0 weighted, 1 masked."""
    return np.asarray(jax.random.key_data(jax.random.fold_in(key, fold)))[-2:]


def _graph(seed=0, n=N):
    """Rows of degree 0, < K, = MAXDEG; zero weights; a row of equal weights."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, MAXDEG + 1, n)
    deg[::7] = 0
    deg[1::9] = rng.integers(1, K, deg[1::9].shape[0])
    deg[2] = MAXDEG
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(indptr[-1])
    indices = rng.integers(0, n, e).astype(np.int32)
    w = rng.uniform(0.05, 3.0, e).astype(np.float32)
    w[rng.random(e) < 0.3] = 0.0
    w[indptr[2]:indptr[3]] = 1.0
    times = rng.integers(0, 20, e).astype(np.int32)
    return indptr, indices, w, times


def _seeds(n=N, count=40, seed=1):
    s = np.random.default_rng(seed).integers(0, n, count).astype(np.int32)
    s[:4] = [0, 1, 2, 9]
    return s


# -- the hash ---------------------------------------------------------------------

def test_edge_uniform_bit_exact():
    ids = np.concatenate([np.arange(300), 2**31 - 1 - np.arange(300),
                          np.random.default_rng(0).integers(0, 2**31, 2000)])
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        want = jax_sample.edge_uniform_np(key, ids)
        k0, k1 = key_data = np.asarray(jax.random.key_data(key))[-2:]
        got = port_sample.edge_uniform(torch.as_tensor(ids), torch.tensor(int(k0)),
                                       torch.tensor(int(k1)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(port_sample.edge_uniform_np(key_data, ids), want)
    # per-row keys broadcast row by row
    keys = [jax.random.PRNGKey(s) for s in range(4)]
    kd = np.stack([np.asarray(jax.random.key_data(k))[-2:] for k in keys]).astype(np.int64)
    got = port_sample.edge_uniform(torch.as_tensor(ids[:50])[None],
                                   torch.as_tensor(kd[:, :1]), torch.as_tensor(kd[:, 1:]))
    for r, k in enumerate(keys):
        np.testing.assert_array_equal(got[r].numpy(), jax_sample.edge_uniform_np(k, ids[:50]))


# -- the top-k order -----------------------------------------------------------------

def test_keyed_topk_matches_chunked_topk_with_ties(monkeypatch):
    indptr, _, _, _ = _graph(2)
    seeds = _seeds()
    start = indptr[seeds]
    deg = indptr[seeds + 1] - start

    def jax_score(eids, valid):     # few distinct values: ties everywhere
        s = ((eids * 7919) % 5).astype(jnp.float32)
        return jnp.where(eids % 11 == 0, -jnp.inf, s)

    def port_score(eids, rows):
        s = ((eids * 7919) % 5).to(torch.float32)
        return torch.where(eids % 11 == 0, float("-inf"), s)

    for k in (1, K, 12):
        want, _ = jax_sample._chunked_topk(jax_score, jnp.asarray(start), jnp.asarray(deg), k,
                                           MAXDEG, CHUNK)
        got = port_sample._keyed_topk(port_score, torch.as_tensor(start).long(),
                                      torch.as_tensor(deg).long(), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a hop past the flat pass's edge budget is split into seed blocks
    monkeypatch.setattr(port_sample, "_FLAT_EDGES", 50)
    got = port_sample._keyed_topk(port_score, torch.as_tensor(start).long(),
                                  torch.as_tensor(deg).long(), K)
    want, _ = jax_sample._chunked_topk(jax_score, jnp.asarray(start), jnp.asarray(deg), K,
                                       MAXDEG, CHUNK)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the one-hop samplers -------------------------------------------------------------

def _gumbel_scores(key, indptr, w, seeds, times=None, seed_time=None):
    """JAX's scores of each seed's edges (XLA's log), -inf where excluded."""
    e = np.concatenate([np.arange(indptr[s], indptr[s + 1]) for s in seeds])
    g = np.asarray(jax_sample._gumbel_from_uniform(
        jax_sample._edge_uniform(jax.random.fold_in(key, 0), jnp.asarray(e, jnp.int32))))
    sc = np.where(w[e] > 0, np.asarray(jnp.log(jnp.maximum(jnp.asarray(w[e]), 1e-38))) + g,
                  -np.inf)
    if times is not None:
        row_time = np.repeat(seed_time, indptr[seeds + 1] - indptr[seeds])
        sc = np.where(times[e] <= row_time, sc, -np.inf)
    return np.split(sc, np.cumsum(indptr[seeds + 1] - indptr[seeds])[:-1])


def _compare_gumbel(got, want, scores, k):
    """Exact rows where JAX's top k + 1 scores are separated by > 1e-5; sets
    where only the k-th / (k+1)-th are.  Returns the share compared in order."""
    in_order = 0
    for r, sc in enumerate(scores):
        top = np.sort(sc[np.isfinite(sc)])[::-1][:k + 1]
        gaps = -np.diff(top)
        if (gaps > 1e-5).all():
            in_order += 1
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a[r].numpy(), np.asarray(b)[r])
        elif len(top) <= k or gaps[k - 1] > 1e-5:
            for a, b in zip(got[:2], want[:2]):
                assert set(a[r].tolist()) == set(np.asarray(b)[r].tolist())
    return in_order / len(scores)


@pytest.mark.parametrize("case", ["weighted", "weighted_timed", "masked", "masked_filter",
                                  "short_max_degree"])
def test_one_hop_samplers_match_jax(case):
    indptr, indices, w, times = _graph()
    seeds = _seeds()
    seed_time = np.random.default_rng(3).integers(0, 20, len(seeds)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    maxdeg = 17 if case == "short_max_degree" else MAXDEG    # JAX scans 24 positions
    jargs = (jnp.asarray(indptr), jnp.asarray(indices))
    kw = dict(max_degree=maxdeg, chunk=CHUNK)
    tkw = {}
    if case in ("weighted_timed", "masked"):
        tkw = dict(edge_times=times, seed_time=seed_time)
    jtkw = {k: jnp.asarray(v) for k, v in tkw.items()}
    if case == "masked_filter":    # a callable on edge ids, in either framework
        tkw, jtkw = {"time_filter": lambda e: e % 3 != 0}, {"time_filter": lambda e: e % 3 != 0}
    if case.startswith("masked"):
        want = jax_sample.masked_uniform_sample(key, *jargs, jnp.asarray(seeds), K, **kw, **jtkw)
        got = port_sample.masked_uniform_sample(indptr, indices, seeds, K, **kw, **tkw,
                                                hash_key=key_words(key, 1), device="cpu")
        share = 1.0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        want = jax_sample.weighted_sample(key, *jargs, jnp.asarray(w), jnp.asarray(seeds), K,
                                          **kw, **jtkw)
        got = port_sample.weighted_sample(indptr, indices, w, seeds, K, **kw, **tkw,
                                          hash_key=key_words(key, 0), device="cpu")
        share = _compare_gumbel(got, want, _gumbel_scores(key, indptr, w, seeds, times
                                                          if tkw else None, seed_time), K)
        np.testing.assert_array_equal(got.num_sampled.numpy(), np.asarray(want.num_sampled))
    assert share >= 0.9
    for a in got:
        assert a.dtype == torch.int32
    eids = got.edge_ids.numpy()
    ok = eids >= 0
    rows = np.nonzero(ok)[0]
    if not case.startswith("masked"):
        assert (w[eids[ok]] > 0).all()                     # zero weights never
    if "edge_times" in tkw:
        assert (times[eids[ok]] <= seed_time[rows]).all()
    if case == "masked_filter":
        assert (eids[ok] % 3 != 0).all()
    if case == "short_max_degree":
        assert (eids[ok] - indptr[seeds][rows] < 24).all()
    # -1 seeds give -1 / -1 / 0; the generator's draws are reproducible
    pad = seeds.copy()
    pad[::3] = -1
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(4)
        if case.startswith("masked"):
            runs.append(port_sample.masked_uniform_sample(indptr, indices, pad, K, **kw, **tkw,
                                                          generator=g, device="cpu"))
        else:
            runs.append(port_sample.weighted_sample(indptr, indices, w, pad, K, **kw, **tkw,
                                                    generator=g, device="cpu"))
    a, b = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (a.neighbors[::3] == -1).all() and (a.num_sampled[::3] == 0).all()


def test_empty_graph_and_fanout_zero():
    indptr = np.zeros(5, np.int32)
    out = port_sample.weighted_sample(indptr, np.zeros(0, np.int32), np.zeros(0, np.float32),
                                      [0, 1, -1], 3, max_degree=0, hash_key=(1, 2), device="cpu")
    want = jax_sample._empty_output(3, 3)
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    indptr, indices, w, _ = _graph()
    out = port_sample.weighted_sample(indptr, indices, w, _seeds(), 0, max_degree=MAXDEG,
                                      hash_key=(1, 2), device="cpu")
    assert out.neighbors.shape == (40, 0) and int(out.num_sampled.sum()) == 0


# -- NeighborSampler, the loader, GraphStructure ------------------------------------------

def replayed(key, caps, fanouts, fold):
    """Hop h's uniforms and key words as the JAX sampler draws them."""
    u, words = [], []
    for h, k in enumerate(fanouts):
        hkey = jax.random.fold_in(key, h)
        u.append(np.array(jax.random.uniform(hkey, (caps[h], k))))
        words.append(key_words(hkey, fold))
    return u, words


@pytest.mark.parametrize("dedup", [True, False])
def test_neighbor_sampler_weighted_matches_jax(dedup):
    indptr, indices, w, _ = _graph(4)
    seeds = _seeds(count=BATCH, seed=6)
    seeds[5] = -1
    key = jax.random.PRNGKey(3)
    ref = jax_ns.NeighborSampler(indptr, indices, FANOUTS, weights=w, max_degree=MAXDEG,
                                 dedup=dedup).sample(key, jnp.asarray(seeds))
    sampler = port_ns.NeighborSampler(indptr, indices, FANOUTS, weights=w, dedup=dedup,
                                      device="cpu")
    assert sampler.max_degree == MAXDEG and sampler.key_based(False)
    u, words = replayed(key, sampler.level_caps(BATCH), FANOUTS, 0)
    got = sampler.sample(seeds, u=u, hash_keys=words)
    assert got.static_layout == (not dedup)
    for a, b in zip(got.levels + got.level_counts, ref.levels + ref.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for hp, hr in zip(got.hops, ref.hops):
        for a, b in zip(hp[:3], hr[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    eids = got.hops[1].edge_ids.numpy()
    assert (w[eids[eids >= 0]] > 0).all()


def _stores(jax_side, src, dst, x, y, **attrs):
    gs, fs = ((JaxGraphStore(), JaxFeatureStore()) if jax_side
              else (GraphStore(device="cpu"), FeatureStore(device="cpu")))
    gs.put_edge_index((src, dst), ET, num_nodes=(N, N))
    fs["x"] = x
    fs["y"] = y
    for name, v in attrs.items():
        fs[name] = v
    return fs, gs


def loader_graph(seed=8, n=N, e=700):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    dst[:50] = 4                                            # a hub row
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = rng.integers(0, 3, n)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    w[rng.random(e) < 0.25] = 0
    return src, dst, x, y, w


class Replay:
    """The port loader's sampler fed the JAX loader's draws for batch i:
    ``fold_in(fold_in(fold_in(PRNGKey(seed), epoch), i), h)``."""

    def __init__(self, inner, seed, epoch=0):
        self.inner, self.calls = inner, 0
        self.key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
        self.fanouts = inner.fanouts

    def sample(self, seeds, node_times=None, generator=None):
        skey = jax.random.fold_in(self.key, self.calls)
        self.calls += 1
        fold = 0 if self.inner.weights is not None else 1
        u, words = replayed(skey, self.inner.level_caps(seeds.shape[0]), self.fanouts, fold)
        return self.inner.sample(seeds, node_times, u=u, hash_keys=words)


def assert_batches_equal(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        for a, b in ((p.seeds, r.seeds), (p.input_id, r.input_id), (p.x, r.x), (p.y, r.y)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        s, rs = p.sample, r.sample
        for a, b in zip(s.levels + s.level_counts, rs.levels + rs.level_counts):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for hp, hr in zip(s.hops, rs.hops):
            for a, b in zip(hp[:3], hr[:3]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dedup", [True, False])
def test_neighbor_loader_weight_attr_matches_jax(dedup):
    src, dst, x, y, w = loader_graph()
    kw = dict(num_neighbors=FANOUTS, batch_size=BATCH, shuffle=True, seed=SEED,
              weight_attr="w", dedup=dedup)
    jl = JaxNeighborLoader(_stores(True, src, dst, x, y, w=w), **kw)
    pl = NeighborLoader(_stores(False, src, dst, x, y, w=w), **kw)
    pl.sampler = Replay(pl.sampler, SEED)
    port, ref = list(pl), list(jl)
    assert_batches_equal(port, ref)
    # sampled edge ids index the weights in CSR order: never a zero weight
    perm = pl.sampler.inner.weights.numpy()
    for b in port:
        e = b.sample.hops[0].edge_ids.numpy()
        assert (perm[e[e >= 0]] > 0).all()


def test_graph_structure_weighted_matches_jax():
    indptr, indices, w, _ = _graph(5)
    gs, jgs = GraphStructure(device="cpu"), jax_gs.GraphStructure()
    for g in (gs, jgs):
        g.set_csr_graph(indptr, indices)
        g.set_edge_attribute("w", w)
    seeds = _seeds(count=16, seed=9)
    key = jax.random.PRNGKey(21)
    got = gs.weighted_sample_without_replacement_one_hop(seeds, K, "w",
                                                         hash_key=key_words(key, 0))
    want = jgs.weighted_sample_without_replacement_one_hop(seeds, K, "w", key=key)
    share = _compare_gumbel(got, want, _gumbel_scores(key, indptr, w, seeds), K)
    assert share >= 0.9
    caps = port_ns.level_capacities(len(seeds), FANOUTS)
    u, words = replayed(key, caps, FANOUTS, 0)
    got = gs.multilayer_sample_without_replacement(seeds, FANOUTS, "w", u=u, hash_keys=words)
    want = jgs.multilayer_sample_without_replacement(seeds, FANOUTS, "w", key=key)
    for a, b in zip(got.levels + got.level_counts, want.levels + want.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- "auto" level caps -------------------------------------------------------------------

MEM = 120_000   # bytes: the last level's cap binds at these widths


def test_auto_caps_match_jax(monkeypatch):
    for batch, fanouts, fd in ((BATCH, FANOUTS, 6), (1024, (10, 10), 128), (4, (2,), 1)):
        for mem in (MEM, 16 * 2**30):
            want = jax_heur.auto_max_unique_per_hop(batch, fanouts, fd, memory_bytes=mem)
            assert port_heur.auto_max_unique_per_hop(batch, fanouts, fd,
                                                     memory_bytes=mem) == want
    monkeypatch.setattr(jax_heur, "device_memory_bytes", lambda: MEM)
    for fanouts in (FANOUTS, {("a", "r", "b"): [2, 3], ("b", "s", "a"): [1, 1]}):
        want = jax_heur.resolve_max_unique_per_hop("auto", BATCH, fanouts, None)
        assert port_heur.resolve_max_unique_per_hop("auto", BATCH, fanouts, None,
                                                    memory_bytes=MEM) == want
    assert port_heur.resolve_max_unique_per_hop([5, 9], BATCH, FANOUTS, 6) == [5, 9]
    # the card's own memory, never a TPU default; the host's for the CPU
    assert port_heur.device_memory_bytes("cpu") > 2**30
    src, dst, x, y, _ = loader_graph()
    (jfs, jgs), (pfs, pgs) = (_stores(s, src, dst, x, y) for s in (True, False))
    assert port_heur.resolve_feature_dim(pfs, pgs, "x") == jax_heur.resolve_feature_dim(
        jfs, jgs, "x") == 6
    assert port_heur.resolve_feature_dim(pfs, pgs, "z") is None


def test_neighbor_loader_auto_caps_match_jax(monkeypatch):
    monkeypatch.setattr(jax_heur, "device_memory_bytes", lambda: MEM)
    monkeypatch.setattr(port_heur, "device_memory_bytes", lambda device=None: MEM)
    src, dst, x, y, _ = loader_graph(9)
    kw = dict(num_neighbors=FANOUTS, batch_size=BATCH, seed=SEED, dedup=False,
              max_unique_per_hop="auto")
    jl = JaxNeighborLoader(_stores(True, src, dst, x, y), **kw)
    pl = NeighborLoader(_stores(False, src, dst, x, y), **kw)
    caps = pl.sampler.level_caps(BATCH)
    assert pl.sampler.dedup and caps[-1] < port_ns.level_capacities(BATCH, FANOUTS)[-1]
    pl.sampler = Replay(pl.sampler, SEED)
    assert_batches_equal(list(pl), list(jl))


def test_collect_edge_attrs_by_etype_matches_jax():
    """The hetero loaders' edge-attribute collection, on a one-type store
    (the hetero slice wires it in): the attribute in CSR order, None for no
    attribute, KeyError for one no edge type has."""
    from cugraph_gnn_tpu.loader import node_loader as jax_nl
    from cugraph_gnn_tpu_torch.data.graph_store import edge_type_str
    from cugraph_gnn_tpu_torch.loader import node_loader as port_nl

    src, dst, x, y, w = loader_graph(10)
    sides = []
    for jax_side in (True, False):
        fs, gs = _stores(jax_side, src, dst, x, y)
        fs[(edge_type_str(ET), "w")] = w
        nl = jax_nl if jax_side else port_nl
        sides.append((nl, fs, gs, gs.finalize()))
    (jnl, jfs, jgs, jg), (pnl, pfs, pgs, pg) = sides
    got = pnl.collect_edge_attrs_by_etype(pfs, pgs, pg, "w")
    want = jnl.collect_edge_attrs_by_etype(jfs, jgs, jg, "w")
    assert list(got) == list(want) == [ET]
    np.testing.assert_array_equal(got[ET].numpy(), np.asarray(want[ET]))
    assert pnl.collect_edge_attrs_by_etype(pfs, pgs, pg, None) is None
    with pytest.raises(KeyError, match="no edge type"):
        pnl.collect_edge_attrs_by_etype(pfs, pgs, pg, "missing")
