"""Port parity: disjoint sampling (a subgraph per seed), PyTorch port against
the JAX package on small graphs, on the CPU.

- ``DisjointNeighborSampler`` over a uniform, a weighted and a temporal
  ``NeighborSampler`` (capped levels in one case) with -1 and repeated seeds,
  on JAX's per-seed draws replayed (``split(key, B)``, then per seed
  ``fold_in(key_s, h)`` uniforms and key words): every level, count, map and
  edge id exact; ``batch``, ``seed_valid`` and ``to_coo_disjoint`` exact.
- A GraphSAGE over a disjoint batch (``DisjointBatch.flat()``: the seeds'
  blocks one after the other) against JAX's ``vmap`` of ``model.apply`` over
  ``per_seed()``, float32, from the same flax weights: logits within 1e-5.
- ``NeighborLoader(disjoint=True)`` and ``LinkNeighborLoader(disjoint=True)``
  over a shuffled epoch with the JAX loaders' draws replayed: seeds, (B, cap,
  F) features, levels and maps exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_gnn_tpu.data import FeatureStore as JaxFeatureStore
from cugraph_gnn_tpu.data import GraphStore as JaxGraphStore
from cugraph_gnn_tpu.loader import LinkNeighborLoader as JaxLinkNeighborLoader
from cugraph_gnn_tpu.loader import NeighborLoader as JaxNeighborLoader
from cugraph_gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from cugraph_gnn_tpu.sampler import disjoint as jax_dj
from cugraph_gnn_tpu.sampler import neighbor_sampler as jax_ns
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader, NeighborLoader
from cugraph_gnn_tpu_torch.models.convert import graphsage_from_flax
from cugraph_gnn_tpu_torch.sampler import disjoint as port_dj
from cugraph_gnn_tpu_torch.sampler import neighbor_sampler as port_ns

N, FANOUTS, B, SEED = 80, (3, 3), 10, 2
ET = ("n", "to", "n")


def _graph(seed=0, n=N, e=900):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    dst[:50] = 1                                            # a hub row
    order = np.argsort(dst, kind="stable")
    indptr = np.searchsorted(dst[order], np.arange(n + 1)).astype(np.int32)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    w[rng.random(e) < 0.2] = 0
    t = rng.integers(0, 20, e).astype(np.int32)
    return dict(src=src, dst=dst, indptr=indptr, indices=src[order].astype(np.int32),
                w=w[order], t=t[order], x=rng.standard_normal((n, 6)).astype(np.float32),
                y=rng.integers(0, 3, n))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _draws(key, b, caps, fanouts, fold):
    def one(k):
        hks = [jax.random.fold_in(k, h) for h in range(len(fanouts))]
        return ([jax.random.uniform(hk, (c, f)) for hk, c, f in zip(hks, caps, fanouts)],
                [jax.random.key_data(jax.random.fold_in(hk, fold))[-2:] for hk in hks])
    return jax.vmap(one)(jax.random.split(key, b))


def per_seed_draws(key, b, caps, fanouts, fold):
    """JAX's per-seed draws: seed s's hop h uses fold_in(split(key, b)[s], h);
    uniforms seed after seed, key words one row per seed."""
    u, words = _draws(key, b, tuple(caps), tuple(fanouts), fold)
    return ([np.array(a).reshape(-1, a.shape[-1]) for a in u],
            [np.array(w) for w in words])


def assert_disjoint_equal(got, want):
    for a, b in zip(got.levels + got.level_counts, want.levels + want.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for hp, hr in zip(got.hops, want.hops):
        for a, b in zip(hp[:3], hr[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.seed_valid.numpy(), np.asarray(want.seed_valid))
    np.testing.assert_array_equal(got.batch.numpy(), np.asarray(want.batch))


CASES = {"uniform": {}, "weighted": {"weights": "w"}, "temporal": {"edge_times": "t"},
         "capped": {"max_unique_per_hop": (3, 8)}}


@pytest.fixture(scope="module")
def sampled():
    """Each case sampled once by JAX (vmapped) and by the port (replayed)."""
    g = _graph()
    seeds = np.random.default_rng(1).integers(0, N, B).astype(np.int32)
    seeds[[2, 7]] = -1
    seeds[4] = seeds[5] = 1                                 # a repeated hub seed
    times = np.random.default_rng(2).integers(5, 20, B).astype(np.int32)
    key = jax.random.PRNGKey(6)
    maxdeg = int(np.diff(g["indptr"]).max())
    out = {}
    for name, case in CASES.items():
        kw = {k: (g[v] if isinstance(v, str) else v) for k, v in case.items()}
        caps = kw.pop("max_unique_per_hop", None)           # the wrapper's own knob
        nt = times if "edge_times" in kw else None
        jbase = jax_ns.NeighborSampler(g["indptr"], g["indices"], FANOUTS, max_degree=maxdeg,
                                       dedup=True, **kw)
        want = jax.jit(jax_dj.DisjointNeighborSampler(jbase, caps).sample)(
            key, jnp.asarray(seeds), None if nt is None else jnp.asarray(nt))
        sampler = port_dj.DisjointNeighborSampler(
            port_ns.NeighborSampler(g["indptr"], g["indices"], FANOUTS, device="cpu", **kw),
            caps)
        u, words = per_seed_draws(key, B, sampler.level_caps(), FANOUTS,
                                  0 if "weights" in kw else 1)
        got = sampler.sample(seeds, nt, u=u, hash_keys=words)
        out[name] = (got, want)
    return g, seeds, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_disjoint_sampler_matches_jax(sampled, name):
    g, seeds, out = sampled
    got, want = out[name]
    assert_disjoint_equal(got, want)
    caps = [1, 4, 16] if name != "capped" else [1, 3, 8]
    assert [lv.shape[1] for lv in got.levels] == caps
    lv = got.levels
    for s in range(B):                    # per-seed namespaces, prefix property
        if seeds[s] < 0:
            assert (lv[-1][s] == -1).all()
            continue
        assert int(lv[0][s, 0]) == seeds[s]
        for a, b in zip(lv[:-1], lv[1:]):
            assert torch.equal(b[s, :a.shape[1]], a[s])
            v = b[s][b[s] >= 0]
            assert v.unique().numel() == v.numel()
    if name == "uniform":   # the repeated seed's subgraphs are drawn apart
        assert not torch.equal(lv[-1][4], lv[-1][5])
    if name == "weighted":
        e = got.hops[1].edge_ids.numpy()
        assert (g["w"][e[e >= 0]] > 0).all()


@pytest.mark.parametrize("name", ["uniform", "capped"])
def test_to_coo_disjoint_matches_jax(sampled, name):
    _, _, out = sampled
    got, want = out[name]
    c, jc = port_dj.to_coo_disjoint(got), jax_dj.to_coo_disjoint(want)
    for field in c._fields[:-1]:
        np.testing.assert_array_equal(getattr(c, field).numpy(), np.asarray(getattr(jc, field)),
                                      err_msg=field)
    cap = got.levels[-1].shape[1]
    m = c.row >= 0
    assert torch.equal(c.row[m] // cap, c.col[m] // cap)     # inside one seed's block
    per = got.per_seed()
    assert per.seed_count.tolist() == (got.seed_valid.int()).tolist()


def test_model_over_disjoint_batch_matches_jax_vmap(sampled):
    g, _, out = sampled
    got, want = out["uniform"]
    feats = g["x"]
    x = np.where((np.asarray(want.input_nodes) >= 0)[..., None],
                 feats[np.clip(np.asarray(want.input_nodes), 0, None)], 0).astype(np.float32)
    model = JaxGraphSAGE(hidden_features=8, out_features=4, num_layers=2)
    mb = want.per_seed()
    params = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(x[0]),
                                 jax.tree_util.tree_map(lambda a: a[0], mb))
    logits = jax.jit(jax.vmap(model.apply, in_axes=(None, 0, 0)))(params, jnp.asarray(x), mb)
    assert logits.shape == (B, 1, 4)
    pm = graphsage_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    flat = got.flat()
    assert flat.num_shards == B and flat.levels[-1].shape == (B * 16,)
    ours = pm(torch.as_tensor(x).reshape(B * 16, -1), flat)
    assert ours.shape == (B, 4)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(logits)[:, 0], rtol=0,
                               atol=1e-5)


# -- the loaders -------------------------------------------------------------------------

def _stores(jax_side, g, with_y=True):
    gs, fs = ((JaxGraphStore(), JaxFeatureStore()) if jax_side
              else (GraphStore(device="cpu"), FeatureStore(device="cpu")))
    gs.put_edge_index((g["src"], g["dst"]), ET, num_nodes=(N, N))
    fs["x"] = g["x"]
    if with_y:
        fs["y"] = g["y"]
    return fs, gs


class Replay:
    """The port loader's disjoint sampler fed the JAX loader's draws for
    call i: the key ``fold_in(fold_in(fold_in(PRNGKey(seed), epoch), i),
    extra)`` (``extra`` 2 for the link loader's sampler), split per seed."""

    def __init__(self, inner, seed, extra=None):
        self.inner, self.calls, self.extra = inner, 0, extra
        self.key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
        self.fanouts = inner.fanouts

    def sample(self, seeds, node_times=None, generator=None):
        key = jax.random.fold_in(self.key, self.calls)
        if self.extra is not None:
            key = jax.random.fold_in(key, self.extra)
        self.calls += 1
        u, words = per_seed_draws(key, seeds.shape[0], self.inner.level_caps(), self.fanouts, 1)
        return self.inner.sample(seeds, node_times, u=u, hash_keys=words)

    def level_caps(self, batch_size=1):
        return self.inner.level_caps(batch_size)


def test_neighbor_loader_disjoint_matches_jax():
    g = _graph(4)
    kw = dict(num_neighbors=FANOUTS, batch_size=16, shuffle=True, seed=SEED, disjoint=True)
    jl = JaxNeighborLoader(_stores(True, g), **kw)
    jl.sampler.sample = jax.jit(jl.sampler.sample)
    pl = NeighborLoader(_stores(False, g), **kw)
    assert isinstance(pl.sampler, port_dj.DisjointNeighborSampler)
    pl.sampler = Replay(pl.sampler, SEED)
    ref, port = list(jl), list(pl)
    assert len(port) == len(ref) == -(-N // 16)
    for p, r in zip(port, ref):
        assert p.x.shape == (16, 16, 6)
        for a, b in ((p.seeds, r.seeds), (p.input_id, r.input_id), (p.x, r.x), (p.y, r.y)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert_disjoint_equal(p.sample, r.sample)


def test_link_loader_disjoint_matches_jax():
    g = _graph(5)
    eli = np.stack([g["src"][:30], g["dst"][:30]])
    kw = dict(num_neighbors=FANOUTS, edge_label_index=eli, batch_size=8, seed=SEED,
              disjoint=True)
    jl = JaxLinkNeighborLoader(_stores(True, g, False), **kw)
    jl.sampler.sample = jax.jit(jl.sampler.sample)
    pl = LinkNeighborLoader(_stores(False, g, False), **kw)
    pl.sampler = Replay(pl.sampler, SEED, extra=2)
    ref, port = list(jl), list(pl)
    assert len(port) == len(ref) == 4
    for p, r in zip(port, ref):
        for a, b in ((p.seeds, r.seeds), (p.edge_label_index, r.edge_label_index),
                     (p.edge_label, r.edge_label), (p.x, r.x)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert_disjoint_equal(p.sample, r.sample)
        first = p.sample.levels[-1][:, 0]
        ok = p.seeds >= 0
        assert torch.equal(first[ok], p.seeds[ok])


def test_disjoint_refusals():
    g = _graph(6)
    base = port_ns.NeighborSampler(g["indptr"], g["indices"], FANOUTS, dedup=False,
                                   device="cpu")
    with pytest.raises(ValueError, match="dedup=True"):
        port_dj.DisjointNeighborSampler(base)
    with pytest.raises(TypeError, match="HeteroNeighborSampler"):
        port_dj.DisjointNeighborSampler(object())
    # without a replay: each seed its own draws, reproducible
    s = port_dj.DisjointNeighborSampler(
        port_ns.NeighborSampler(g["indptr"], g["indices"], FANOUTS, weights=g["w"],
                                device="cpu"))
    a, b = (s.sample(np.full(6, 1, np.int32), generator=torch.Generator().manual_seed(1))
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.levels, b.levels))
    assert any(not torch.equal(a.levels[-1][0], a.levels[-1][i]) for i in range(1, 6))
