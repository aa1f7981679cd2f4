"""Port parity: the host builders (CSR, RCM, reorder), FullBatchGraph and its
differentiable slab SpMM, the full-batch SAGEConv / GCNConv / models, sampled
GCNConv, and three chained full-batch training steps, against the JAX
package on the CPU (its Pallas kernels in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cugraph_gnn_tpu import native as jax_native
from cugraph_gnn_tpu.models import GCN as JaxGCN
from cugraph_gnn_tpu.models import GCNConv as JaxGCNConv
from cugraph_gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from cugraph_gnn_tpu.ops import FullBatchGraph as JaxFullBatchGraph
from cugraph_gnn_tpu.ops.reorder import bandwidth_stats as jax_bandwidth_stats
from cugraph_gnn_tpu.ops.reorder import reorder_csr as jax_reorder_csr
from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch import train_full as TF
from cugraph_gnn_tpu_torch.models.conv import GCNConv
from cugraph_gnn_tpu_torch.models.convert import gcn_from_flax, graphsage_from_flax
from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph
from cugraph_gnn_tpu_torch.ops.reorder import bandwidth_stats, reorder_csr


def scrambled_band_coo(n, deg, band, rng):
    """``deg`` sources within +-band per node, node ids then scrambled."""
    scram = rng.permutation(n)
    dst = np.repeat(np.arange(n), deg)
    src = np.clip(dst + rng.integers(-band, band + 1, n * deg), 0, n - 1)
    return scram[src].astype(np.int32), scram[dst].astype(np.int32)


def test_host_builders_match_jax():
    """The same C++ gives the same CSR, RCM order and relabeled CSR; the
    NumPy versions give the same CSR and relabeling."""
    rng = np.random.default_rng(0)
    n = 300
    src, dst = scrambled_band_coo(n, 4, 6, rng)
    got = _native.build_csr(dst, src, n)
    for g, w in zip(got, jax_native.build_csr(dst, src, n)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, _native.build_csr_np(dst, src, n)):
        np.testing.assert_array_equal(g, w)
    indptr, indices, _ = got
    order = _native.rcm_order(indptr, indices)
    np.testing.assert_array_equal(order, jax_native.rcm_order(indptr, indices))
    assert sorted(_native.rcm_order_np(indptr, indices)) == list(range(n))
    for g, w in zip(_native.apply_order_csr(indptr, indices, order),
                    _native.apply_order_csr_np(indptr, indices, order)):
        np.testing.assert_array_equal(g, w)
    for method in ("rcm", "none"):
        rg, jrg = reorder_csr(indptr, indices, method), jax_reorder_csr(
            indptr, indices, method)
        for field in rg._fields:
            np.testing.assert_array_equal(getattr(rg, field), getattr(jrg, field))
        assert bandwidth_stats(rg.indptr, rg.indices) == jax_bandwidth_stats(
            rg.indptr, rg.indices)


@pytest.mark.parametrize("reorder", ["auto", "rcm", "none"])
def test_full_batch_graph_matches_jax(reorder):
    """Orders, degrees, band fraction, slab choice and both slab splits
    (graph and transpose) equal the JAX package's; off the slab path
    ('none' on a scrambled graph), the plain SpMMs agree too."""
    rng = np.random.default_rng(1)
    n = 1200
    src, dst = scrambled_band_coo(n, 4, 20, rng)
    got = FullBatchGraph.from_coo(src, dst, n, reorder=reorder, block_rows=128,
                                  device="cpu")
    want = JaxFullBatchGraph.from_coo(src, dst, n, reorder=reorder, block_rows=128)
    for name in ("order", "inv_order"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.degrees.numpy(), np.asarray(want.degrees))
    assert got.band_fraction == want.band_fraction
    assert got.use_slab == want.use_slab == (reorder != "none")
    for mine, theirs in ((got.slab, want.slab), (got.slab_t, want._slab_t)):
        for field in ("ell", "fb_src", "fb_dst", "degrees"):
            np.testing.assert_array_equal(getattr(mine, field).numpy(),
                                          np.asarray(getattr(theirs, field)))
    x = rng.standard_normal((n, 8)).astype(np.float32)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    np.testing.assert_array_equal(got.to_graph_order(xt).numpy(),
                                  np.asarray(want.to_graph_order(xj)))
    assert torch.equal(got.to_input_order(got.to_graph_order(xt)), xt)
    ids = np.array([0, 5, -1, n - 1], np.int32)
    np.testing.assert_array_equal(got.map_ids(torch.as_tensor(ids)).numpy(),
                                  np.asarray(want.map_ids(jnp.asarray(ids))))
    if not got.use_slab:
        for reduce in ("sum", "mean", "max"):
            np.testing.assert_allclose(
                got.spmm(xt, reduce).numpy(), np.asarray(want.spmm(xj, reduce)),
                rtol=1e-6, atol=1e-6)


def _banded(seed=2, n=500, f=16, classes=5):
    """A small banded graph with far edges, both frameworks' graphs and the
    same features."""
    g = TF.make_synthetic_banded(seed, "cpu", num_nodes=n, deg=6, band=60,
                                 feat_dim=f, classes=classes)
    kw = dict(reorder="none", block_rows=128)
    fbg = FullBatchGraph.from_coo(g.src, g.dst, n, device="cpu", **kw)
    jfbg = JaxFullBatchGraph.from_coo(g.src, g.dst, n, **kw)
    assert 0.5 < fbg.band_fraction < 1.0        # the fallback does work
    return g, fbg, jfbg


@pytest.mark.parametrize("reduce,weighted", [("mean", False), ("sum", True)])
def test_spmm_gradient_matches_jax(reduce, weighted):
    """Forward over the graph and backward over its transpose (with the
    fallback edges, and the 'mean' divide by the graph's total degree)
    against jax.grad through the custom VJP, within 1e-5."""
    g, _, _ = _banded()
    n = g.num_nodes
    rng = np.random.default_rng(3)
    w = rng.uniform(0.5, 2.0, g.num_edges).astype(np.float32) if weighted else None
    kw = dict(reorder="none", block_rows=128)
    fbg = FullBatchGraph.from_coo(g.src, g.dst, n, w, device="cpu", **kw)
    jfbg = JaxFullBatchGraph.from_coo(g.src, g.dst, n, w, **kw)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    tgt = rng.standard_normal((n, 16)).astype(np.float32)

    def loss(z):
        out = jfbg.spmm(z, reduce)
        return jnp.sum(out * tgt), out

    want_grad, want_out = jax.jit(jax.grad(loss, has_aux=True))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = fbg.spmm(xt, reduce)
    (out * torch.as_tensor(tgt)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_full_batch_models_match_flax(model):
    """GraphSAGE / GCN ``full`` (COO) and ``full_graph`` (slab), weights
    carried by graphsage_from_flax / gcn_from_flax, within 3e-4 (the JAX
    package's own full-vs-full_graph tolerance)."""
    g, fbg, jfbg = _banded()
    n = g.num_nodes
    x = g.feats.numpy()
    src, dst = jnp.asarray(g.src), jnp.asarray(g.dst)
    cls, load = {"sage": (JaxGraphSAGE, graphsage_from_flax),
                 "gcn": (JaxGCN, gcn_from_flax)}[model]
    jm = cls(hidden_features=32, out_features=5, num_layers=2)
    params = jax.jit(lambda z: jm.init(jax.random.PRNGKey(0), z, src, dst, n,
                                       method=cls.full))(jnp.asarray(x))
    pm = load(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    xt = torch.as_tensor(x)
    with torch.no_grad():
        got_full = pm.full(xt, torch.as_tensor(g.src), torch.as_tensor(g.dst), n)
        got_graph = pm.full_graph(xt, fbg)
    want_full, want_graph = jax.jit(lambda p, z: (
        jm.apply(p, z, src, dst, n, method=cls.full),
        jm.apply(p, z, jfbg, method=cls.full_graph)))(params, jnp.asarray(x))
    np.testing.assert_allclose(got_full.numpy(), np.asarray(want_full),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got_graph.numpy(), np.asarray(want_graph),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("degrees", [False, True])
def test_gcn_conv_sampled_matches_flax(degrees):
    """The sampled GCNConv: exact symmetric normalization from global
    degrees, or the mean-aggregation approximation, with self-loops."""
    rng = np.random.default_rng(4)
    b, k, f = 20, 6, 8
    x_dst = rng.standard_normal((b, f)).astype(np.float32)
    x_neigh = rng.standard_normal((b, k, f)).astype(np.float32)
    mask = rng.random((b, k)) < 0.7
    mask[::5] = False
    deg = (rng.integers(0, 9, b).astype(np.float32),
           rng.integers(0, 9, (b, k)).astype(np.float32)) if degrees else ()
    conv = JaxGCNConv(12)
    args = [jnp.asarray(a) for a in (x_dst, x_neigh, mask, *deg)]
    params = jax.jit(lambda *a: conv.init(jax.random.PRNGKey(1), *a))(*args)
    want = jax.jit(conv.apply)(params, *args)
    port = GCNConv(f, 12)
    lin = params["params"]["lin"]
    with torch.no_grad():
        port.lin.weight.copy_(torch.as_tensor(np.array(lin["kernel"]).T))
        port.lin.bias.copy_(torch.as_tensor(np.array(lin["bias"])))
        got = port(*[torch.as_tensor(a) for a in (x_dst, x_neigh, mask, *deg)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4, atol=3e-4)


def test_make_synthetic_banded_small():
    g = TF.make_synthetic_banded(7, "cpu", num_nodes=300, deg=4, band=20, far=2,
                                 feat_dim=8, classes=3)
    assert g.num_edges == 300 * 6 and g.src.dtype == np.int32
    np.testing.assert_array_equal(np.bincount(g.dst, minlength=300), np.full(300, 6))
    near = np.repeat(np.arange(300), 4)
    assert (np.abs(g.src[:1200] - near) <= 20).all()
    np.testing.assert_array_equal(g.dst[:1200], near)
    assert g.feats.shape == (300, 8) and g.feats.dtype == torch.float32
    assert 0 <= int(g.labels.min()) and int(g.labels.max()) < 3


def test_full_batch_train_steps_match_optax():
    """Three chained float32 full-batch GraphSAGE steps (Adam 5e-3): loss and
    parameters within 1e-5 of the optax step of
    examples/full_batch_training.py."""
    g, fbg, jfbg = _banded(seed=5)
    x, y = jnp.asarray(g.feats.numpy()), jnp.asarray(g.labels.numpy())
    jm = JaxGraphSAGE(hidden_features=32, out_features=5, num_layers=2)
    params = jax.jit(lambda z: jm.init(
        jax.random.PRNGKey(2), z, jnp.asarray(g.src), jnp.asarray(g.dst),
        g.num_nodes, method=JaxGraphSAGE.full))(x)
    tx = optax.adam(TF.LR)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            logits = jm.apply(p, x, jfbg, method=JaxGraphSAGE.full_graph)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, upd), opt_state, loss

    pm = graphsage_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    opt = torch.optim.Adam(pm.parameters(), lr=TF.LR)
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state)
        ploss = TF.full_batch_step(pm, opt, g.feats, fbg, g.labels)
        np.testing.assert_allclose(float(ploss), float(loss), rtol=0, atol=1e-5)
        for i, conv in enumerate(pm.convs):
            p = params["params"][f"conv_{i}"]
            for mine, theirs in ((conv.lin_self.weight, p["lin_self"]["kernel"].T),
                                 (conv.lin_self.bias, p["lin_self"]["bias"]),
                                 (conv.lin_neigh.weight, p["lin_neigh"]["kernel"].T)):
                np.testing.assert_allclose(mine.detach().numpy(), np.asarray(theirs),
                                           rtol=0, atol=1e-5)
