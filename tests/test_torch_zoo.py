"""Port parity: the rest of the homogeneous model zoo, PyTorch port against
the JAX package on small graphs, on the CPU (the JAX full-graph path runs
its Pallas kernels in interpret mode; each JAX reference is computed once,
in a module fixture).

- ``GIN`` (2 layers, 6 -> 16 -> 5) and a ``GINConv`` with a trainable
  ``eps`` (set to 0.25), from ``gin_from_flax`` weights: the sampled path
  (a deduplicated batch with repeated and -1 seeds), ``full`` (COO) and
  ``full_graph`` (the slab SpMM, 'sum'); within 1e-5 in float32.
- ``deg_input`` through ``GCN``'s sampled path: within 1e-5.
- Dropout: at ``train=False`` GraphSAGE with dropout 0.5 equals flax's
  GraphSAGE (flax refuses the JAX model's dropout > 0, see the test); at
  ``train=True`` every hidden entry is 0 or its ReLU scaled by 1 / (1 - p),
  the kept share of 40,000 entries lies within 0.5 +- 0.02 (the binomial's
  standard deviation is 0.0025), equal generators give equal outputs, and
  ``train=True`` without a generator raises.
- ``create_gnn_model``: per type, ``model_from_flax`` loads the JAX builder's
  flax tree into the port's model, every leaf by shape (a mismatch raises)
  and one port parameter per leaf; ``rgcn`` raises.
- ``GraphStructure``'s unweighted one-hop and multilayer samplers with the
  JAX draws replayed: exact; the weighted ones on JAX's key words: the same
  edges and nodes.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_gnn_tpu.graph_structure import GraphStructure as JaxGraphStructure
from cugraph_gnn_tpu.models import GCN as JaxGCN
from cugraph_gnn_tpu.models import GIN as JaxGIN
from cugraph_gnn_tpu.models import GINConv as JaxGINConv
from cugraph_gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from cugraph_gnn_tpu.models import create_gnn_model as jax_create_gnn_model
from cugraph_gnn_tpu.ops import FullBatchGraph as JaxFullBatchGraph
from cugraph_gnn_tpu.sampler import output as jax_out
from cugraph_gnn_tpu_torch import train_full as TF
from cugraph_gnn_tpu_torch.graph_structure import GraphStructure
from cugraph_gnn_tpu_torch.models import conv as conv_mod
from cugraph_gnn_tpu_torch.models.builder import MODEL_TYPES, create_gnn_model, model_from_args
from cugraph_gnn_tpu_torch.models.conv import GINConv
from cugraph_gnn_tpu_torch.models.convert import (
    gcn_from_flax,
    gin_from_flax,
    graphsage_from_flax,
    model_from_flax,
)
from cugraph_gnn_tpu_torch.models.zoo import MultihopModel
from cugraph_gnn_tpu_torch.ops.csr import coo_to_csr_np
from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import NeighborSampler

N, F_IN, HIDDEN, OUT = 400, 6, 16, 5
FANOUTS = (4, 3)


def _to_jax(batch):
    """A port MultihopBatch as the JAX package's."""
    def j(t):
        return jnp.asarray(t.numpy())

    return jax_out.MultihopBatch(
        levels=[j(a) for a in batch.levels], level_counts=[j(a) for a in batch.level_counts],
        hops=[jax_out.HopBlock(j(h.neigh_local), j(h.neigh_global), j(h.edge_ids))
              for h in batch.hops],
        seed_count=j(batch.seed_count), static_layout=batch.static_layout)


@pytest.fixture(scope="module")
def data():
    """A banded graph with far edges (both frameworks' FullBatchGraph), and a
    deduplicated sampled batch over its reversed CSR."""
    g = TF.make_synthetic_banded(6, "cpu", num_nodes=N, deg=5, band=50,
                                 feat_dim=F_IN, classes=OUT)
    kw = dict(reorder="none", block_rows=128)
    fbg = FullBatchGraph.from_coo(g.src, g.dst, N, device="cpu", **kw)
    jfbg = JaxFullBatchGraph.from_coo(g.src, g.dst, N, **kw)
    assert 0.5 < fbg.band_fraction < 1.0
    (indptr, indices), _ = coo_to_csr_np(g.dst, g.src, N)
    sampler = NeighborSampler(indptr, indices, FANOUTS, device="cpu")
    rng = np.random.default_rng(7)
    seeds = rng.integers(0, N, 24).astype(np.int32)
    seeds[::5] = seeds[0]            # repeated seeds
    seeds[-3:] = -1                  # a padded tail
    caps = sampler.level_caps(24)
    u = [rng.random((caps[h], k), dtype=np.float32) for h, k in enumerate(FANOUTS)]
    batch = sampler.sample(torch.as_tensor(seeds), u=u)
    x_in = g.feats[batch.input_nodes.clamp(min=0).long()]
    deg = torch.as_tensor(np.diff(indptr)).float()[batch.input_nodes.clamp(min=0).long()]
    return dict(g=g, fbg=fbg, jfbg=jfbg, batch=batch, jbatch=_to_jax(batch), x_in=x_in,
                deg=deg, indptr=indptr, indices=indices)


def _gin_refs(d):
    """JAX outputs of GIN (model) and a GINConv with eps, on each path."""
    g, n = d["g"], N
    src, dst = jnp.asarray(g.src), jnp.asarray(g.dst)
    x, x_in = jnp.asarray(g.feats.numpy()), jnp.asarray(d["x_in"].numpy())
    jb, jfbg = d["jbatch"], d["jfbg"]
    out = {}
    model = JaxGIN(hidden_features=HIDDEN, out_features=OUT, num_layers=2)
    params = jax.jit(lambda z: model.init(jax.random.PRNGKey(0), z, jb))(x_in)
    out["gin"] = (params, jax.jit(lambda p: {
        "sampled": model.apply(p, x_in, jb),
        "full": model.apply(p, x, src, dst, n, method=JaxGIN.full),
        "full_graph": model.apply(p, x, jfbg, method=JaxGIN.full_graph)})(params))
    conv = JaxGINConv(OUT, hidden_features=12, train_eps=True)
    hop = jb.hops[0]
    s_l = hop.neigh_local.shape[0]
    x_dst, x_neigh = x_in[:s_l], x_in[jnp.maximum(hop.neigh_local, 0)]
    cparams = jax.jit(lambda a, b, m: conv.init(jax.random.PRNGKey(1), a, b, m))(
        x_dst, x_neigh, hop.mask)
    cparams = {"params": {**cparams["params"], "eps": jnp.float32(0.25)}}
    out["gin_conv_eps"] = (cparams, jax.jit(lambda p: {
        "sampled": conv.apply(p, x_dst, x_neigh, hop.mask),
        "full": conv.apply(p, x, src, dst, n, method=JaxGINConv.full),
        "full_graph": conv.apply(p, x, jfbg, method=JaxGINConv.full_graph)})(cparams))
    return out


@pytest.fixture(scope="module")
def gin_refs(data):
    return _gin_refs(data)


@pytest.mark.parametrize("path", ["sampled", "full", "full_graph"])
@pytest.mark.parametrize("which", ["gin", "gin_conv_eps"])
def test_gin_matches_flax(data, gin_refs, which, path):
    params, want = gin_refs[which]
    tree = jax.tree_util.tree_map(np.asarray, params)
    g, batch, x_in = data["g"], data["batch"], data["x_in"]
    if which == "gin":
        model = gin_from_flax(tree, device="cpu")
        assert model.convs[0].eps is None
    else:
        conv = GINConv(F_IN, OUT, hidden_features=12, train_eps=True)
        gin_from_flax({"params": {"conv_0": tree["params"]}}, MultihopModel([conv]))
        assert float(conv.eps.detach()) == 0.25
    with torch.no_grad():
        if path == "full":
            got = (model.full if which == "gin" else conv.full)(
                g.feats, torch.as_tensor(g.src), torch.as_tensor(g.dst), N)
        elif path == "full_graph":
            got = (model if which == "gin" else conv).full_graph(g.feats, data["fbg"])
        elif which == "gin":
            got = model(x_in, batch)
        else:
            hop = batch.hops[0]
            got = conv(batch.dst_activations(x_in, 0), batch.gather_neighbors(x_in, 0),
                       hop.mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[path]), rtol=1e-5, atol=1e-5)


def test_gin_sum_rounds_as_flax_at_bf16(data, monkeypatch):
    """At bf16 activations without eps, (1 + 0) * x_dst + agg stays in bf16,
    as in flax; with a float32 eps it is formed in float32."""
    x_dst = data["x_in"][:8].to(torch.bfloat16)
    agg = data["x_in"][8:16].to(torch.bfloat16)
    seen = []
    dense = conv_mod.dense

    def spy(lin, x, dtype):
        seen.append(x.dtype)
        return dense(lin, x, dtype)

    monkeypatch.setattr(conv_mod, "dense", spy)
    for train_eps in (False, True):
        with torch.no_grad():
            GINConv(F_IN, OUT, train_eps=train_eps)._mlp(x_dst, agg)
    # mlp_1's input of each conv (then mlp_2's)
    assert seen[0::2] == [torch.bfloat16, torch.float32]


def test_gcn_deg_input_matches_flax(data):
    jb, x_in, deg = data["jbatch"], jnp.asarray(data["x_in"].numpy()), data["deg"]
    model = JaxGCN(hidden_features=HIDDEN, out_features=OUT, num_layers=2)
    params = jax.jit(lambda z: model.init(jax.random.PRNGKey(2), z, jb))(x_in)
    want, want_plain = jax.jit(lambda p, dg: (
        model.apply(p, x_in, jb, deg_input=dg), model.apply(p, x_in, jb)))(
            params, jnp.asarray(deg.numpy()))
    pm = gcn_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    with torch.no_grad():
        got = pm(data["x_in"], data["batch"], deg_input=deg)
        got_plain = pm(data["x_in"], data["batch"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_plain.numpy(), np.asarray(want_plain), rtol=1e-5, atol=1e-5)
    assert not np.allclose(np.asarray(want), np.asarray(want_plain), atol=1e-3)


def test_dropout_matches_flax_and_keeps_its_contract(data):
    jb, x_in = data["jbatch"], jnp.asarray(data["x_in"].numpy())
    # the JAX MultihopModel builds nn.Dropout inside a setup-style __call__,
    # which flax refuses (AssignSubModuleError) for any dropout > 0, so
    # train=False is held against its dropout=0 model: the same function
    model = JaxGraphSAGE(hidden_features=HIDDEN, out_features=OUT, num_layers=2)
    with pytest.raises(Exception, match="Dropout"):
        JaxGraphSAGE(hidden_features=HIDDEN, out_features=OUT, num_layers=2,
                     dropout=0.5).init(jax.random.PRNGKey(3), x_in, jb)
    params = jax.jit(lambda z: model.init(jax.random.PRNGKey(3), z, jb))(x_in)
    want = jax.jit(lambda p: model.apply(p, x_in, jb, train=False))(params)
    pm = graphsage_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    pm.dropout = 0.5
    with torch.no_grad():
        got = pm(data["x_in"], data["batch"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        # train=True: the contract, on a hidden activation of 40,000 entries
        h = torch.randn((200, 200), generator=torch.Generator().manual_seed(0))
        out = pm._hidden(h, True, torch.Generator().manual_seed(1))
        r = torch.relu(h)
        assert bool(((out == 0) | (out == r / 0.5)).all())
        pos = r > 0
        kept = float((out[pos] != 0).float().mean())
        assert abs(kept - 0.5) < 0.02
        assert torch.equal(out, pm._hidden(h, True, torch.Generator().manual_seed(1)))
        assert torch.equal(pm._hidden(h, False, None), r)
        a, b = (pm(data["x_in"], data["batch"], train=True,
                   generator=torch.Generator().manual_seed(s)) for s in (4, 4))
        assert torch.equal(a, b) and not torch.allclose(a, got)
        # as flax's apply wants a dropout key, train=True wants a generator
        with pytest.raises(ValueError, match="generator"):
            pm(data["x_in"], data["batch"], train=True)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_create_gnn_model_matches_jax_builder(data, model_type):
    kw = dict(class_count=OUT, hidden_feat_dim=HIDDEN, num_layers=2, num_heads=4)
    jb, x_in = data["jbatch"], jnp.asarray(data["x_in"].numpy())
    batch = data["batch"]
    if model_type == "rgcn":    # its 2 relations over the batch's blocks, input side first
        jb = [[(h.neigh_local, h.mask)] * 2 for h in reversed(jb.hops)]
        batch = [[(h.neigh_local, h.mask)] * 2 for h in reversed(batch.hops)]
    jm = jax_create_gnn_model(model_type, **kw)
    params = jax.jit(lambda z: jm.init(jax.random.PRNGKey(5), z, jb))(x_in)
    tree = jax.tree_util.tree_map(np.asarray, params)
    pm = create_gnn_model(model_type, in_feat_dim=F_IN, device="cpu", **kw)
    assert model_from_flax(model_type.upper(), tree, pm) is pm
    assert len(list(pm.parameters())) == len(jax.tree_util.tree_leaves(tree))
    with torch.no_grad():
        got = pm(data["x_in"], batch)
    want = jax.jit(jm.apply)(params, x_in, jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    args = argparse.Namespace(model=model_type, hidden_dim=HIDDEN, num_layers=2, heads=4)
    again = model_from_args(args, OUT, F_IN, device="cpu")
    assert [p.shape for p in again.parameters()] == [p.shape for p in pm.parameters()]
    with pytest.raises(ValueError):
        model_from_flax("mlp", tree)
    if model_type != "rgcn":    # another model's tree is not an RGCN's
        with pytest.raises(KeyError):
            model_from_flax("rgcn", tree)


def test_graph_structure_matches_jax(data):
    indptr, indices = data["indptr"], data["indices"]
    gs, jgs = GraphStructure(device="cpu"), JaxGraphStructure()
    gs.set_csr_graph(indptr, indices)
    jgs.set_csr_graph(indptr, indices)
    assert (gs.num_nodes, gs.num_edges) == (jgs.num_nodes, jgs.num_edges)
    gs.set_node_attribute("x", data["g"].feats)
    w = np.random.default_rng(2).uniform(0, 2, gs.num_edges).astype(np.float32)
    gs.set_edge_attribute("w", w)
    jgs.set_edge_attribute("w", w)
    assert gs.node_attrs["x"].shape == (N, F_IN) and gs.edge_attrs["w"].dtype == torch.float32
    # the one-hop samplers differ on -1 seeds (ROADMAP: -1 / -1 / 0 here)
    seeds = np.array([3, 17, 0, 3, 250, 399], np.int32)
    key = jax.random.PRNGKey(9)
    u = np.array(jax.random.uniform(key, (len(seeds), 4)))
    got = gs.unweighted_sample_without_replacement_one_hop(seeds, 4, u=u)
    want = jgs.unweighted_sample_without_replacement_one_hop(seeds, 4, key=key)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    seeds[2] = -1
    caps = NeighborSampler(indptr, indices, FANOUTS, device="cpu").level_caps(len(seeds))
    us = [np.array(jax.random.uniform(jax.random.fold_in(key, h), (caps[h], k)))
          for h, k in enumerate(FANOUTS)]
    got = gs.multilayer_sample_without_replacement(seeds, FANOUTS, u=us)
    want = jgs.multilayer_sample_without_replacement(seeds, FANOUTS, key=key)
    for a, b in zip(got.levels + got.level_counts, want.levels + want.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for hp, hr in zip(got.hops, want.hops):
        for a, b in zip(hp[:3], hr[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the weighted samplers on JAX's key words (tests/test_torch_weighted.py
    # holds the order too): the same edges for every seed
    seeds[2] = 0
    words = [np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.fold_in(key, h),
                                                               0)))[-2:] for h in range(2)]
    got = gs.weighted_sample_without_replacement_one_hop(seeds, 4, "w", hash_key=words[0])
    want = jgs.weighted_sample_without_replacement_one_hop(seeds, 4, "w",
                                                          key=jax.random.fold_in(key, 0))
    np.testing.assert_array_equal(got.num_sampled.numpy(), np.asarray(want.num_sampled))
    for a, b in zip(got.edge_ids.numpy(), np.asarray(want.edge_ids)):
        assert sorted(a) == sorted(b)
    got = gs.multilayer_sample_without_replacement(seeds, FANOUTS, "w", u=us, hash_keys=words)
    want = jgs.multilayer_sample_without_replacement(seeds, FANOUTS, "w", key=key)
    for a, b in zip(got.level_counts, want.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.levels, want.levels):
        assert sorted(a.tolist()) == sorted(np.asarray(b).tolist())
