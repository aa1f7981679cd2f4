"""Port parity: GATConv (sampled, ``full`` and ``full_graph``), GAT,
``gat_from_flax`` and three chained full-batch GAT training steps, against
the JAX package on the CPU (its Pallas kernels in interpret mode, jitted)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cugraph_gnn_tpu.models import GAT as JaxGAT
from cugraph_gnn_tpu.models import GATConv as JaxGATConv
from cugraph_gnn_tpu.ops import FullBatchGraph as JaxFullBatchGraph
from cugraph_gnn_tpu_torch import train_full as TF
from cugraph_gnn_tpu_torch.models.conv import GATConv
from cugraph_gnn_tpu_torch.models.convert import gat_from_flax
from cugraph_gnn_tpu_torch.models.zoo import GAT
from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph


def _banded(seed, n=500, f=16, classes=5):
    """A small banded graph with far edges, both frameworks' graphs and the
    same features."""
    g = TF.make_synthetic_banded(seed, "cpu", num_nodes=n, deg=6, band=60,
                                 feat_dim=f, classes=classes)
    kw = dict(reorder="none", block_rows=128)
    fbg = FullBatchGraph.from_coo(g.src, g.dst, n, device="cpu", **kw)
    jfbg = JaxFullBatchGraph.from_coo(g.src, g.dst, n, **kw)
    assert 0.5 < fbg.band_fraction < 1.0        # the fallback does work
    return g, fbg, jfbg


def _load_conv(port, params):
    p = params["params"]
    with torch.no_grad():
        port.lin.weight.copy_(torch.as_tensor(np.array(p["lin"]["kernel"]).T))
        for name in ("att_src", "att_dst", "bias"):
            getattr(port, name).copy_(torch.as_tensor(np.array(p[name])))


@pytest.mark.parametrize("heads,concat", [(3, True), (1, False)])
def test_gat_conv_sampled_matches_flax(heads, concat):
    """The sampled GATConv (fanout softmax per head, rows without neighbors
    included) within 1e-5 of flax, float32."""
    rng = np.random.default_rng(heads)
    b, k, f = 20, 6, 8
    x_dst = rng.standard_normal((b, f)).astype(np.float32)
    x_neigh = rng.standard_normal((b, k, f)).astype(np.float32)
    mask = rng.random((b, k)) < 0.7
    mask[::5] = False
    conv = JaxGATConv(4, heads=heads, concat=concat)
    args = [jnp.asarray(a) for a in (x_dst, x_neigh, mask)]
    params = jax.jit(lambda *a: conv.init(jax.random.PRNGKey(1), *a))(*args)
    want = jax.jit(conv.apply)(params, *args)
    port = GATConv(f, 4, heads=heads, concat=concat, device="cpu")
    _load_conv(port, params)
    with torch.no_grad():
        got = port(*[torch.as_tensor(a) for a in (x_dst, x_neigh, mask)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gat_conv_full_and_full_graph_match_flax():
    """One 2-head GATConv: ``full`` (plain COO chain) within 1e-5 of flax's
    ``full``, and ``full_graph`` (attention plain versions) within 1e-5 of
    both; the JAX package's own full-vs-full_graph tolerance is 3e-4."""
    g, fbg, _ = _banded(seed=1)
    n = g.num_nodes
    x = g.feats.numpy()
    src, dst = jnp.asarray(g.src), jnp.asarray(g.dst)
    conv = JaxGATConv(4, heads=2)
    params = jax.jit(lambda z: conv.init(jax.random.PRNGKey(2), z, src, dst, n,
                                         method=JaxGATConv.full))(jnp.asarray(x))
    want = jax.jit(lambda p, z: conv.apply(p, z, src, dst, n, method=JaxGATConv.full))(
        params, jnp.asarray(x))
    port = GATConv(16, 4, heads=2, device="cpu")
    _load_conv(port, params)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        got_full = port.full(xt, torch.as_tensor(g.src), torch.as_tensor(g.dst), n)
        got_graph = port.full_graph(xt, fbg)
    np.testing.assert_allclose(got_full.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_graph.numpy(), got_full.numpy(), rtol=1e-5, atol=1e-5)


def test_gat_from_flax_builds_model():
    """gat_from_flax reads widths and heads from the tree: GAT(16 -> 4 x 8
    -> 5) and a one-layer GAT; kernels transposed, att and bias copied."""
    jm = JaxGAT(hidden_features=32, out_features=5, num_layers=2, heads=4)
    g, _, _ = _banded(seed=2, n=300)
    src, dst = jnp.asarray(g.src), jnp.asarray(g.dst)
    params = jax.jit(lambda z: jm.init(jax.random.PRNGKey(3), z, src, dst, 300,
                                       method=JaxGAT.full))(jnp.asarray(g.feats.numpy()))
    pm = gat_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    assert [(c.heads, c.features, c.concat) for c in pm.convs] == [(4, 8, True),
                                                                   (1, 5, False)]
    p0 = params["params"]["conv_0"]
    np.testing.assert_array_equal(pm.convs[0].lin.weight.detach().numpy(),
                                  np.asarray(p0["lin"]["kernel"]).T)
    np.testing.assert_array_equal(pm.convs[0].att_dst.detach().numpy(),
                                  np.asarray(p0["att_dst"]))
    one = {"params": {"conv_0": params["params"]["conv_1"]}}
    pm1 = gat_from_flax(jax.tree_util.tree_map(np.asarray, one), device="cpu")
    assert len(pm1.convs) == 1 and pm1.convs[0].lin.weight.shape == (5, 32)
    with pytest.raises(ValueError, match="convs"):
        gat_from_flax(jax.tree_util.tree_map(np.asarray, one), model=pm)


def test_full_batch_gat_steps_match_optax():
    """GAT (4 heads of 4, then 5 classes) ``full`` within 1e-5 of flax, then
    three chained float32 full-batch Adam steps (5e-3) through
    ``full_graph``: loss within 1e-5 and parameters within 1e-5 of the
    optax steps through the JAX package's attention kernels."""
    g, fbg, jfbg = _banded(seed=5)
    n = g.num_nodes
    x, y = jnp.asarray(g.feats.numpy()), jnp.asarray(g.labels.numpy())
    src, dst = jnp.asarray(g.src), jnp.asarray(g.dst)
    jm = JaxGAT(hidden_features=16, out_features=5, num_layers=2, heads=4)
    params = jax.jit(lambda z: jm.init(jax.random.PRNGKey(4), z, src, dst, n,
                                       method=JaxGAT.full))(x)
    pm = gat_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    want_full = jax.jit(lambda p, z: jm.apply(p, z, src, dst, n, method=JaxGAT.full))(
        params, x)
    with torch.no_grad():
        got_full = pm.full(g.feats, torch.as_tensor(g.src), torch.as_tensor(g.dst), n)
    np.testing.assert_allclose(got_full.numpy(), np.asarray(want_full), rtol=1e-5,
                               atol=1e-5)

    tx = optax.adam(TF.LR)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            logits = jm.apply(p, x, jfbg, method=JaxGAT.full_graph)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, upd), opt_state, loss

    opt = torch.optim.Adam(pm.parameters(), lr=TF.LR)
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state)
        ploss = TF.full_batch_step(pm, opt, g.feats, fbg, g.labels)
        np.testing.assert_allclose(float(ploss), float(loss), rtol=0, atol=1e-5)
        for i, conv in enumerate(pm.convs):
            p = params["params"][f"conv_{i}"]
            for mine, theirs in ((conv.lin.weight, p["lin"]["kernel"].T),
                                 (conv.att_src, p["att_src"]),
                                 (conv.att_dst, p["att_dst"]),
                                 (conv.bias, p["bias"])):
                np.testing.assert_allclose(mine.detach().numpy(), np.asarray(theirs),
                                           rtol=0, atol=1e-5)
