"""Port parity: heterogeneous sampling, PyTorch port against the JAX package
on a small typed graph, on the CPU.

The graph: authors (20), fields (8) and papers (30) with four edge types
(author writes paper, field has paper, paper cites paper, paper written_by
author), so that papers and authors both expand.  Every JAX sampler runs
jitted; the port replays its draws, keyed by (hop, edge type): uniforms
``uniform(fold_in(fold_in(key, h), ei), (targets, k))`` and key words
``key_data(fold_in(that key, 0 | 1))[-2:]``.  Exact, for:

- ``HeteroNeighborSampler`` deduplicated and in the static layout (untyped):
  levels, counts, ``neigh_local``, ``neigh_global``, edge ids with their
  per-type bases, layouts;
- ``hetero_multihop_batched`` typed and untyped at S = 3: the same, plans
  included, and ``gather_neighbors`` as the row gather of ``neigh_local``;
- weighted and temporal hops (deduplicated, and the static timed layout):
  the same, every sampled edge no newer than its target's propagated time;
- fanout dicts (a type left out) and ``max_unique_per_hop`` caps; caps
  without dedup and typed segments with dedup raise, as in JAX;
- ``DisjointNeighborSampler`` over a hetero sampler (per-seed keys
  ``split(key, B)``): levels, counts and per-type blocks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_gnn_tpu.data import GraphStore as JaxGraphStore
from cugraph_gnn_tpu.sampler import disjoint as jax_dj
from cugraph_gnn_tpu.sampler import hetero as jax_het
from cugraph_gnn_tpu_torch.data import GraphStore
from cugraph_gnn_tpu_torch.sampler import disjoint as port_dj
from cugraph_gnn_tpu_torch.sampler import hetero as port_het

NODES = {"author": 20, "field": 8, "paper": 30}
EDGES = {("author", "writes", "paper"): 70, ("field", "has", "paper"): 40,
         ("paper", "cites", "paper"): 90, ("paper", "written_by", "author"): 50}
FANOUTS = (3, 2)
B, SEED = 6, 3


def _edges(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for (st, rel, dt), e in EDGES.items():
        src, dst = rng.integers(0, NODES[st], e), rng.integers(0, NODES[dt], e)
        dst[:12] = 2                                       # a hub row per type
        out[(st, rel, dt)] = (src, dst)
    return out


def _stores(edges):
    jgs, pgs = JaxGraphStore(), GraphStore(device="cpu")
    for et, (src, dst) in edges.items():
        for gs in (jgs, pgs):
            gs.put_edge_index((src, dst), et, num_nodes=(NODES[et[0]], NODES[et[2]]))
    return jgs, pgs


def key_words(key, fold):
    return jax.random.key_data(jax.random.fold_in(key, fold))[-2:]


@functools.partial(jax.jit, static_argnums=(1, 2))
def _hop_draws(key, shapes, fold):
    """shapes: ((h, ei, rows, k), ...) -> uniforms and key words of each."""
    out = []
    for h, ei, rows, k in shapes:
        hk = jax.random.fold_in(jax.random.fold_in(key, h), ei)
        out.append((jax.random.uniform(hk, (rows, k)), key_words(hk, fold)))
    return out


def replay_draws(key, names, hops, fold=0):
    """The port's u and hash_keys for a JAX batch's hops: each block's
    shape (..., t, k) gives its draw's rows."""
    shapes = tuple((h, names.index(n), int(np.prod(b.neigh_local.shape[:-1])),
                    int(b.neigh_local.shape[-1]))
                   for h, hop in enumerate(hops) for n, b in hop.items())
    vals = _hop_draws(key, shapes, fold)
    u = [dict() for _ in hops]
    words = [dict() for _ in hops]
    for (h, ei, _, _), (uu, ww) in zip(shapes, vals):
        u[h][names[ei]] = np.array(uu)
        words[h][names[ei]] = np.array(ww)
    return u, words


def assert_hetero_equal(got, want, layouts=True):
    assert len(got.levels) == len(want.levels)
    for a, b in zip(got.levels + got.level_counts, want.levels + want.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for hp, hr in zip(got.hops, want.hops):
        assert list(hp) == list(hr)
        for name in hp:
            for field, a, b in zip(("neigh_local", "neigh_global", "edge_ids"),
                                   hp[name][:3], hr[name][:3]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{name} {field}")
    if layouts:
        assert got.layouts == want.layouts


@pytest.fixture(scope="module")
def graphs():
    jgs, pgs = _stores(_edges())
    jg, pg = jgs.finalize(), pgs.finalize()
    names = [port_het.etype_str(et) for et in pg.etypes]
    assert names == [jax_het._etype_str(et) for et in jg.etypes]
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, NODES["paper"], B).astype(np.int32) + pgs.node_offset("paper")
    seeds[[1, 4]] = -1
    seeds[3] = 2 + pgs.node_offset("paper")                 # the hub
    weights, times = {}, {}
    for et in pg.etypes:
        e = len(pgs.get_edge_index(et)[0])
        w = rng.uniform(0.1, 2.0, e).astype(np.float32)
        w[rng.random(e) < 0.2] = 0
        weights[et] = w[pg.edge_perm_by_etype[et]]
        times[et] = rng.integers(0, 20, e).astype(np.int32)[pg.edge_perm_by_etype[et]]
    node_times = rng.integers(5, 20, B).astype(np.int32)
    return dict(jg=jg, pg=pg, jgs=jgs, pgs=pgs, names=names, seeds=seeds,
                weights=weights, times=times, node_times=node_times)


def _both(graphs, fold=0, **kw):
    """JAX's and the port's HeteroNeighborSampler with the same options,
    the port on JAX's draws; returns (port batch, JAX batch)."""
    jkw = {k: ({et: jnp.asarray(v) for et, v in val.items()} if isinstance(val, dict)
               and k.endswith("etype") else val) for k, val in kw.items()}
    js = jax_het.HeteroNeighborSampler(graphs["jg"], **jkw)
    ps = port_het.HeteroNeighborSampler(graphs["pg"], **kw)
    key = jax.random.PRNGKey(SEED)
    nt = graphs["node_times"] if "times_by_etype" in kw else None
    want = js.sample(key, jnp.asarray(graphs["seeds"]),
                     None if nt is None else jnp.asarray(nt))
    u, words = replay_draws(key, graphs["names"], want.hops, fold)
    got = ps.sample(graphs["seeds"], nt, u=u, hash_keys=words)
    assert ps.level_caps(B) == js._level_caps(B)
    return got, want, ps


def test_hetero_sampler_dedup_matches_jax(graphs):
    got, want, ps = _both(graphs, fanouts=FANOUTS)
    assert_hetero_equal(got, want)
    assert got.layouts == () and [lv.shape[0] for lv in got.levels] == ps.level_caps(B)
    # edge ids carry their type's base: each names an edge of its own type
    pg = graphs["pg"]
    for hop in got.hops:
        for et in pg.etypes:
            name = port_het.etype_str(et)
            indptr, indices, base = pg.csr_by_etype[et]
            blk = hop[name]
            ok = blk.edge_ids >= 0
            assert bool((blk.edge_ids[ok] - base < indices.shape[0]).all())
            assert torch.equal(indices[(blk.edge_ids[ok] - base).long()], blk.neigh_global[ok])


def test_hetero_sampler_static_layout_matches_jax(graphs):
    got, want, _ = _both(graphs, fanouts=FANOUTS, dedup=False)
    assert_hetero_equal(got, want)
    assert got.static_layout and len(got.layouts[0][0]) == 3
    h1 = torch.randn(got.levels[1].shape[0], 4)
    for name in got.hops[0]:       # the slice equals the row gather
        blk = got.hops[0][name]
        m = blk.mask
        sl = got.gather_neighbors(h1, 0, name)
        assert torch.equal(sl[m], h1[blk.neigh_local[m].long()])


@pytest.mark.parametrize("typed", [False, True], ids=["untyped", "typed"])
def test_hetero_multihop_batched_matches_jax(graphs, typed):
    pg, jg, pgs = graphs["pg"], graphs["jg"], graphs["pgs"]
    names = graphs["names"]
    rng = np.random.default_rng(5)
    seeds = (rng.integers(0, NODES["paper"], (3, 4)) + pgs.node_offset("paper")).astype(np.int32)
    seeds[1, 2] = -1
    fanouts = {n: list(FANOUTS) for n in names}
    fanouts[names[1]] = [2, 1]
    kw = dict(etype_names=names, fanouts=fanouts, caps=[4, 0, 0])
    if typed:
        kw.update(seed_type="paper",
                  dst_types={port_het.etype_str(et): et[2] for et in pg.etypes},
                  src_types={port_het.etype_str(et): et[0] for et in pg.etypes})
    key = jax.random.PRNGKey(7)
    jcsrs = {jax_het._etype_str(et): jg.csr_by_etype[et][:2] for et in jg.etypes}
    want = jax.jit(functools.partial(
        jax_het.hetero_multihop_batched,
        edge_bases={jax_het._etype_str(et): jg.csr_by_etype[et][2] for et in jg.etypes},
        max_degrees={jax_het._etype_str(et): jg.max_degree_by_etype[et] for et in jg.etypes},
        **kw))(key, jcsrs, jnp.asarray(seeds))
    u, _ = replay_draws(key, names, want.hops)
    got = port_het.hetero_multihop_batched(
        seeds, csrs={port_het.etype_str(et): pg.csr_by_etype[et][:2] for et in pg.etypes},
        edge_bases={port_het.etype_str(et): pg.csr_by_etype[et][2] for et in pg.etypes},
        max_degrees={port_het.etype_str(et): pg.max_degree_by_etype[et] for et in pg.etypes},
        u=u, device="cpu", **kw)
    assert_hetero_equal(got, want)
    if typed:
        entries = [e for lay in got.layouts for e in lay]
        assert entries and all(len(e) == 4 for e in entries)
        # the written_by block expands only the author segment of level 1
        wb = [e for e in got.layouts[1] if e[0].endswith("written_by__author")][0]
        assert [c for _, c in wb[3]] == [False] + [n.startswith("author__")
                                                   for n in got.hops[0]]
        # hop 0 samples only from papers: the authors' type expands nothing
        assert "paper__written_by__author" not in got.hops[0]
    st = got.step(1)
    jst = jax.tree_util.tree_map(lambda a: a[1], want)
    assert_hetero_equal(st, jst)
    h2 = torch.randn(st.levels[2].shape[0], 3)
    for name, blk in st.hops[1].items():
        m = blk.mask
        assert torch.equal(st.gather_neighbors(h2, 1, name)[m], h2[blk.neigh_local[m].long()])
    assert st.dst_activations(h2, 1).shape[0] == st.levels[1].shape[0]


@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "static"])
def test_hetero_temporal_matches_jax(graphs, dedup):
    got, want, _ = _both(graphs, fold=1, fanouts=FANOUTS, times_by_etype=graphs["times"],
                         dedup=dedup)
    assert_hetero_equal(got, want)
    # every sampled edge is no newer than its target's propagated time
    pg = graphs["pg"]
    t_all = np.concatenate([graphs["times"][et] for et in pg.etypes])
    seed_t = np.where(graphs["seeds"] >= 0, graphs["node_times"], 2**31 - 1)
    t_lvl = {int(n): int(t) for n, t in zip(graphs["seeds"], seed_t) if n >= 0}
    lv0 = got.levels[0].numpy()
    for name, blk in got.hops[0].items():
        e, m = blk.edge_ids.numpy(), blk.mask.numpy()
        for i, j in zip(*np.nonzero(m)):
            assert t_all[e[i, j]] <= t_lvl[int(lv0[i])]


def test_hetero_weighted_matches_jax(graphs):
    w = {et: v for i, (et, v) in enumerate(graphs["weights"].items()) if i != 2}
    got, want, _ = _both(graphs, fold=0, fanouts=FANOUTS, weights_by_etype=w)
    assert_hetero_equal(got, want)
    w_all = np.concatenate([graphs["weights"][et] for et in graphs["pg"].etypes])
    for hop in got.hops:
        for name, blk in hop.items():
            if not name.startswith("paper__cites"):
                e = blk.edge_ids.numpy()
                assert (w_all[e[e >= 0]] > 0).all()


def test_hetero_weighted_temporal_matches_jax(graphs):
    got, want, _ = _both(graphs, fold=0, fanouts=FANOUTS, weights_by_etype=graphs["weights"],
                         times_by_etype=graphs["times"])
    assert_hetero_equal(got, want)


def test_hetero_fanout_dict_and_caps_match_jax(graphs):
    names = graphs["names"]
    fan = {et: [3, 2] for et in graphs["pg"].etypes}
    del fan[graphs["pg"].etypes[1]]                           # field has paper: not sampled
    fan[graphs["pg"].etypes[0]] = [2, 0]                      # writes: hop 0 only
    got, want, ps = _both(graphs, fanouts=fan, max_unique_per_hop=(15, 40))
    assert_hetero_equal(got, want)
    assert ps.level_caps(B) == [B, 15, 40]
    assert names[1] not in got.hops[0] and names[0] not in got.hops[1]
    with pytest.raises(ValueError, match="dedup=True"):
        port_het.HeteroNeighborSampler(graphs["pg"], FANOUTS, max_unique_per_hop=(9, 9),
                                       dedup=False)
    with pytest.raises(ValueError, match="dedup=False"):
        port_het.HeteroNeighborSampler(graphs["pg"], FANOUTS, seed_type="paper")
    with pytest.raises(ValueError, match="same number of hops"):
        port_het.HeteroNeighborSampler(graphs["pg"], {names[0]: [1], names[1]: [1, 1]})
    jgot, jwant, _ = _both(graphs, fanouts=fan, dedup=False, seed_type="paper")
    assert_hetero_equal(jgot, jwant)


@pytest.mark.parametrize("case", ["uniform", "temporal"])
def test_hetero_disjoint_matches_jax(graphs, case):
    kw = dict(fanouts=FANOUTS)
    if case == "temporal":
        kw["times_by_etype"] = graphs["times"]
    jkw = {k: ({et: jnp.asarray(v) for et, v in val.items()} if isinstance(val, dict)
               else val) for k, val in kw.items()}
    jbase = jax_het.HeteroNeighborSampler(graphs["jg"], **jkw)
    key = jax.random.PRNGKey(11)
    nt = graphs["node_times"] if case == "temporal" else None
    want = jax.jit(jax_dj.DisjointNeighborSampler(jbase).sample)(
        key, jnp.asarray(graphs["seeds"]), None if nt is None else jnp.asarray(nt))
    ps = port_dj.DisjointNeighborSampler(port_het.HeteroNeighborSampler(graphs["pg"], **kw))
    keys = jax.random.split(key, B)
    u = [dict() for _ in want.hops]
    words = [dict() for _ in want.hops]
    for s in range(B):
        per = jax.tree_util.tree_map(lambda a: a[s], want.hops)
        us, ws = replay_draws(keys[s], graphs["names"], per, 1)
        for h in range(len(u)):
            for n in us[h]:
                u[h].setdefault(n, []).append(us[h][n])
                words[h].setdefault(n, []).append(ws[h][n])
    u = [{n: np.concatenate(v) for n, v in d.items()} for d in u]
    words = [{n: np.stack(v) for n, v in d.items()} for d in words]
    got = ps.sample(graphs["seeds"], nt, u=u, hash_keys=words)
    for a, b in zip(got.levels + got.level_counts, want.levels + want.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for hp, hr in zip(got.hops, want.hops):
        for name in hr:
            for a, b in zip(hp[name][:3], hr[name][:3]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.batch.numpy(), np.asarray(want.batch))
    flat = got.flat()
    assert isinstance(flat, port_het.HeteroMultihopBatch) and flat.num_shards == B
    assert ps.level_caps() == ps.base.level_caps(1)
