"""Port parity: the hetero loaders, PyTorch port against the JAX package on a
small typed store, on the CPU, exact on the JAX loaders' draws replayed.

The store: authors (16), fields (6) and papers (24), four edge types; ``x``
for papers and authors only (fields hold none), ``y`` for papers.

- ``NeighborLoader(input_nodes=("paper", ids))`` over a shuffled epoch with
  typed target segments (``dedup=False``) and with deduplicated levels:
  seeds (shifted by the paper offset), input ids, the per-type feature dict
  (each type's rows at its slots, zeros elsewhere), the de-offset labels,
  levels, blocks and layouts.  Draws: batch i's sampler key
  ``fold_in(fold_in(PRNGKey(seed), epoch), i)``, then per (hop, edge type)
  ``fold_in(fold_in(key, h), ei)``.
- ``LinkNeighborLoader(edge_label_index=(("author", "writes", "paper"),
  (2, E)))``, binary negatives with rejection: seeds (the two endpoint
  types' offsets, -1 pads kept), labels, features and samples; then one
  ``train_link.link_loss`` through ``train_hetero.RGCNEncoder`` against the
  loss of ``examples/hetero_link_pred.py``'s step: within 1e-5.
- ``create_gnn_model("rgcn")``: the JAX builder's parameter shapes, and
  logits over the first typed batch from the same weights, within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cugraph_gnn_tpu.data import FeatureStore as JaxFeatureStore
from cugraph_gnn_tpu.data import GraphStore as JaxGraphStore
from cugraph_gnn_tpu.loader import LinkNeighborLoader as JaxLinkNeighborLoader
from cugraph_gnn_tpu.loader import NeighborLoader as JaxNeighborLoader
from cugraph_gnn_tpu.models import RGCN as JaxRGCN
from cugraph_gnn_tpu.models.builder import create_gnn_model as jax_create
from cugraph_gnn_tpu.sampler import negative as jax_neg
from cugraph_gnn_tpu_torch import train_hetero as TH
from cugraph_gnn_tpu_torch import train_link as TL
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader, NeighborLoader
from cugraph_gnn_tpu_torch.loader.link_loader import draw_negatives
from cugraph_gnn_tpu_torch.models.builder import create_gnn_model
from cugraph_gnn_tpu_torch.models.convert import rgcn_from_flax
from cugraph_gnn_tpu_torch.sampler import hetero as port_het
from cugraph_gnn_tpu_torch.sampler import negative as port_neg

NODES = {"author": 16, "field": 6, "paper": 24}
EDGES = {("author", "writes", "paper"): 60, ("field", "has", "paper"): 30,
         ("paper", "cites", "paper"): 70, ("paper", "written_by", "author"): 40}
WRITES = ("author", "writes", "paper")
FANOUTS, SEED, F_IN = (3, 2), 4, 5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    edges = {et: (rng.integers(0, NODES[et[0]], e), rng.integers(0, NODES[et[2]], e))
             for et, e in EDGES.items()}
    x = {nt: rng.standard_normal((NODES[nt], F_IN)).astype(np.float32)
         for nt in ("author", "paper")}
    y = rng.integers(0, 3, NODES["paper"])
    return edges, x, y


def _stores(jax_side, data):
    edges, x, y = data
    gs, fs = ((JaxGraphStore(), JaxFeatureStore()) if jax_side
              else (GraphStore(device="cpu"), FeatureStore(device="cpu")))
    for et, (src, dst) in edges.items():
        gs.put_edge_index((src, dst), et, num_nodes=(NODES[et[0]], NODES[et[2]]))
    for nt, v in x.items():
        fs[(nt, "x")] = v
    fs[("paper", "y")] = y
    return fs, gs


@functools.partial(jax.jit, static_argnums=(1,))
def _hop_draws(key, shapes):
    return [jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, h), ei), (rows, k))
            for h, ei, rows, k in shapes]


class Replay:
    """The port loader's sampler (and negatives) fed the JAX loader's draws:
    batch i's sampler key ``fold_in(fold_in(PRNGKey(seed), epoch), i)``
    (then ``fold_in(.., 2)`` for the link loader, whose negatives take ``..,
    1)``); each (hop, edge type)'s uniforms shaped as the JAX batch's
    block."""

    def __init__(self, loader, seed, ref, link=False):
        self.loader, self.inner, self.ref, self.link = loader, loader.sampler, ref, link
        self.names = [port_het.etype_str(et) for et in self.inner.etypes]
        self.key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
        self.calls = self.neg_calls = 0
        loader.sampler = self
        if link:
            loader._negatives = self.negatives

    def sample(self, seeds, node_times=None, generator=None):
        key = jax.random.fold_in(self.key, self.calls)
        if self.link:
            key = jax.random.fold_in(key, 2)
        hops = self.ref[self.calls].sample.hops
        self.calls += 1
        shapes = tuple((h, self.names.index(n), int(np.prod(b.neigh_local.shape[:-1])),
                        int(b.neigh_local.shape[-1]))
                       for h, hop in enumerate(hops) for n, b in hop.items())
        u = [dict() for _ in hops]
        for (h, ei, _, _), uu in zip(shapes, _hop_draws(key, shapes)):
            u[h][self.names[ei]] = np.array(uu)
        return self.inner.sample(seeds, node_times, u=u)

    def negatives(self, ps, n_neg):
        lo = self.loader
        key = jax.random.fold_in(jax.random.fold_in(self.key, self.neg_calls), 1)
        self.neg_calls += 1
        k1, k2, k3, _ = jax.random.split(key, 4)

        def choice(k, n):
            return torch.as_tensor(np.array(jax_neg._weighted_choice(k, n, (n_neg,), None)))

        draws = port_neg.NegativeDraws(choice(k1, lo.num_src), choice(k2, lo.num_dst),
                                       choice(k3, lo.num_dst), None)
        return draw_negatives(ps, n_neg, lo.num_src, lo.num_dst, lo.neg, lo._edge_key_sorted,
                              draws=draws, device="cpu")


def assert_sample_equal(got, want):
    for a, b in zip(got.levels + got.level_counts, want.levels + want.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for hp, hr in zip(got.hops, want.hops):
        assert list(hp) == list(hr)
        for name in hp:
            for a, b in zip(hp[name][:3], hr[name][:3]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert got.layouts == want.layouts


def assert_x_equal(got, want):
    assert sorted(got) == sorted(want) == ["author", "paper"]
    for nt in got:
        np.testing.assert_array_equal(got[nt].numpy(), np.asarray(want[nt]))


@pytest.fixture(scope="module")
def node_epochs():
    data = _data()
    ids = np.arange(NODES["paper"] - 3)
    out = {}
    for dedup in (False, True):
        kw = dict(num_neighbors=FANOUTS, input_nodes=("paper", ids), batch_size=8,
                  shuffle=True, seed=SEED, dedup=dedup)
        jl = JaxNeighborLoader(_stores(True, data), **kw)
        ref = list(jl)
        pl = NeighborLoader(_stores(False, data), **kw)
        assert isinstance(pl.sampler, port_het.HeteroNeighborSampler)
        assert pl.sampler.seed_type == (None if dedup else "paper")
        Replay(pl, SEED, ref)
        out[dedup] = (pl, ref, list(pl))
    return data, out


@pytest.mark.parametrize("dedup", [False, True], ids=["typed", "dedup"])
def test_hetero_neighbor_loader_matches_jax(node_epochs, dedup):
    data, out = node_epochs
    pl, ref, port = out[dedup]
    assert len(port) == len(ref) == 3
    off = pl.graph_store.node_offset("paper")
    for p, r in zip(port, ref):
        for a, b in ((p.seeds, r.seeds), (p.input_id, r.input_id), (p.y, r.y)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert_x_equal(p.x, r.x)
        assert_sample_equal(p.sample, r.sample)
        ok = p.seeds >= 0
        np.testing.assert_array_equal(p.y[ok].numpy(), data[2][(p.seeds[ok] - off).numpy()])
        inp = p.sample.input_nodes
        slot_type = torch.full_like(inp, -1)
        for i, nt in enumerate(pl.graph_store.node_types):
            lo = pl.graph_store.node_offset(nt)
            slot_type[(inp >= lo) & (inp < lo + NODES[nt])] = i
        # each type's rows at its own slots, zero rows elsewhere
        for i, nt in enumerate(pl.graph_store.node_types):
            if nt in p.x:
                assert bool((p.x[nt][slot_type != i] == 0).all())
    if not dedup:
        assert all(len(e) == 4 for lay in port[0].sample.layouts for e in lay)


def test_hetero_loader_step_and_builder_match_jax(node_epochs):
    """``create_gnn_model("rgcn")`` against the JAX builder, and its logits
    over the first typed batch (``train_hetero.input_features``)."""
    _, out = node_epochs
    pl, ref, port = out[False]
    names = [port_het.etype_str(et) for et in pl.graph_store.finalize().etypes]
    jm = jax_create("rgcn", class_count=3, hidden_feat_dim=8, num_relations=len(names))
    r = ref[0]
    x_j = sum(r.x.values())
    params = jax.jit(functools.partial(jm.init, method=JaxRGCN.batch_call),
                     static_argnums=3)(jax.random.PRNGKey(0), x_j, r.sample, tuple(names))
    pm = create_gnn_model("rgcn", in_feat_dim=F_IN, class_count=3, hidden_feat_dim=8,
                          num_relations=len(names), device="cpu")
    # flax makes a relation's weights only where its block is present: the
    # last layer (hop 0, paper targets) lacks paper -> author
    for i, conv in enumerate(pm.convs):
        tree = params["params"][f"conv_{i}"]
        assert len(conv.lin_rel) == len(names)
        assert tree["lin_root"]["kernel"].shape[::-1] == conv.lin_root.weight.shape
        for ri, lin in enumerate(conv.lin_rel):
            if f"lin_rel_{ri}" in tree:
                assert tree[f"lin_rel_{ri}"]["kernel"].shape[::-1] == lin.weight.shape
            else:
                assert i == 1 and names[ri].endswith("__author")
    rgcn_from_flax(jax.tree_util.tree_map(np.asarray, params), model=pm)
    with torch.no_grad():
        assert float(pm.convs[1].lin_rel[names.index("paper__written_by__author")].weight
                     .abs().sum()) == 0
    want = jm.apply(params, x_j, r.sample, names, method=JaxRGCN.batch_call)
    got = pm.batch_call(TH.input_features(port[0].x), port[0].sample, names)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    opt = torch.optim.Adam(pm.parameters(), lr=1e-3)
    loss = TH.loader_step(pm, opt, port[0], names, dtype=torch.float32)
    assert torch.isfinite(loss)


@pytest.fixture(scope="module")
def link_epoch():
    data = _data(1)
    src, dst = data[0][WRITES]
    kw = dict(num_neighbors=FANOUTS, edge_label_index=(WRITES, np.stack([src[:20], dst[:20]])),
              neg_sampling="binary", batch_size=8, shuffle=True, seed=SEED,
              reject_true_edges=True)
    jl = JaxLinkNeighborLoader(_stores(True, data), **kw)
    ref = list(jl)
    pl = LinkNeighborLoader(_stores(False, data), **kw)
    Replay(pl, SEED, ref, link=True)
    return pl, jl, ref, list(pl)


def test_hetero_link_loader_matches_jax(link_epoch):
    pl, jl, ref, port = link_epoch
    assert len(port) == len(ref) == 3
    assert (pl.num_src, pl.num_dst) == (NODES["author"], NODES["paper"])
    a_off, p_off = (pl.graph_store.node_offset(t) for t in ("author", "paper"))
    assert (pl.src_offset, pl.dst_offset) == (jl.src_offset, jl.dst_offset) == (a_off, p_off)
    for p, r in zip(port, ref):
        for a, b in ((p.seeds, r.seeds), (p.edge_label_index, r.edge_label_index),
                     (p.edge_label, r.edge_label), (p.input_id, r.input_id)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert_x_equal(p.x, r.x)
        assert_sample_equal(p.sample, r.sample)
        b = 8
        src, dst = p.seeds[:b], p.seeds[b:2 * b]
        assert bool(((src == -1) | ((src >= a_off) & (src < a_off + NODES["author"]))).all())
        assert bool(((dst == -1) | ((dst >= p_off) & (dst < p_off + NODES["paper"]))).all())
    assert int((port[-1].seeds[:8] < 0).sum()) == 4          # the last batch's pads


def test_hetero_link_step_matches_example(link_epoch):
    """One step of ``examples/hetero_link_pred.py`` (RGCN encoder over the
    summed per-type features, dot-product decoder) on the first batch."""
    pl, _, ref, port = link_epoch
    names = [port_het.etype_str(et) for et in pl.graph_store.finalize().etypes]
    model = JaxRGCN(num_relations=len(names), hidden_features=8, out_features=8)
    r = ref[0]
    rel = [[(hop[n].neigh_local, hop[n].mask) if n in hop else None for n in names]
           for hop in reversed(r.sample.hops)]
    x_j = sum(r.x.values())
    params = jax.jit(model.init)(jax.random.PRNGKey(2), x_j, rel)

    def loss_fn(p):
        h = model.apply(p, x_j, rel)
        eli = r.edge_label_index
        score = jnp.sum(h[eli[0]] * h[eli[1]], axis=-1)
        valid = (r.seeds[eli[0]] >= 0) & (r.seeds[eli[1]] >= 0)
        ls = optax.sigmoid_binary_cross_entropy(score, r.edge_label)
        return jnp.sum(jnp.where(valid, ls, 0)) / jnp.maximum(jnp.sum(valid), 1)

    want = float(jax.jit(loss_fn)(params))
    pm = rgcn_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    enc = TH.RGCNEncoder(pm, names)
    got = float(TL.link_loss(enc(port[0].x, port[0].sample), port[0]).detach())
    assert abs(got - want) <= 1e-5
    opt = torch.optim.Adam(pm.parameters(), lr=1e-3)
    assert torch.isfinite(TL.link_step(enc, opt, port[0]))
