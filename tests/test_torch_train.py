"""Port parity: the sampled GraphSAGE train step (forward, masked mean
cross-entropy, backward, Adam 1e-3) in float32, PyTorch port against a JAX
step built as bench.py builds it, from the same weights and sample."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from cugraph_gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from cugraph_gnn_tpu.sampler.neighbor_sampler import multihop_uniform_batched
from cugraph_gnn_tpu_torch import train as T
from cugraph_gnn_tpu_torch.models.convert import graphsage_from_flax
from cugraph_gnn_tpu_torch.sampler import neighbor_sampler as port_ns

N, F, HIDDEN, CLASSES = 80, 16, 32, 5
STEPS, BATCH, FANOUTS = 3, 12, (4, 3)


def test_make_synthetic_products_small():
    g = T.make_synthetic_products(5, "cpu", num_nodes=N, feat_dim=F,
                                  classes=CLASSES)
    rng = np.random.default_rng(5)   # bench.py's host degree draw
    deg = np.minimum(np.floor(25.0 * rng.random(N) ** -0.5), 17_000)
    np.testing.assert_array_equal(np.diff(g.indptr.numpy()), deg)
    assert g.max_degree == int(deg.max())
    assert g.indices.dtype == torch.int32 and g.indices.shape[0] == deg.sum()
    assert 0 <= int(g.indices.min()) and int(g.indices.max()) < N
    assert g.feats.shape == (N, F) and g.feats.dtype == torch.float32
    assert 0 <= int(g.labels.min()) and int(g.labels.max()) < CLASSES


def _jax_step(model):
    tx = optax.adam(1e-3)

    @jax.jit
    def step(params, opt_state, x, sample, y):
        # bench.py:178-193
        def loss_fn(p):
            logits = model.apply(p, x, sample).astype(jnp.float32)
            valid = sample.levels[0] >= 0
            ls = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return jnp.sum(jnp.where(valid, ls, 0)) / jnp.maximum(
                jnp.sum(valid), 1)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return tx, step


def _pairs(port_model, tree):
    """(port tensor, flax array in torch layout) for every parameter."""
    for i, conv in enumerate(port_model.convs):
        p = tree["params"][f"conv_{i}"]
        yield conv.lin_self.weight, p["lin_self"]["kernel"].T
        yield conv.lin_self.bias, p["lin_self"]["bias"]
        yield conv.lin_neigh.weight, p["lin_neigh"]["kernel"].T


def test_train_steps_match_jax():
    g = T.make_synthetic_products(1, "cpu", num_nodes=N, feat_dim=F,
                                  classes=CLASSES)
    indptr, indices = g.indptr.numpy(), g.indices.numpy()
    feats, labels = g.feats.numpy(), g.labels.numpy().astype(np.int32)
    seeds = np.random.default_rng(2).integers(0, N, (STEPS, BATCH)).astype(np.int32)
    seeds[:, ::5] = -1
    key = jax.random.PRNGKey(3)
    ref = multihop_uniform_batched(key, jnp.asarray(indptr), jnp.asarray(indices),
                                   jnp.asarray(seeds), FANOUTS)
    us, t = [], STEPS * BATCH
    for h, k in enumerate(FANOUTS):
        us.append(np.array(jax.random.uniform(jax.random.fold_in(key, h), (t, k))))
        t *= k + 1
    sample = port_ns.multihop_uniform_batched(indptr, indices, seeds, FANOUTS,
                                              u=us, device="cpu")

    model = JaxGraphSAGE(hidden_features=HIDDEN, out_features=CLASSES,
                         num_layers=2)
    step0 = jax.tree_util.tree_map(lambda a: a[0], ref)
    params = model.init(jax.random.PRNGKey(4), jnp.asarray(feats)[
        jnp.clip(step0.input_nodes, 0)], step0)
    tx, jax_step = _jax_step(model)
    opt_state = tx.init(params)
    port_model = graphsage_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                     device="cpu")
    opt = torch.optim.Adam(port_model.parameters(), lr=1e-3)

    for s in range(STEPS):   # one step, then two more chained on its state
        jstep = jax.tree_util.tree_map(lambda a: a[s], ref)
        x = jnp.asarray(feats)[jnp.clip(jstep.input_nodes, 0)]
        y = jnp.asarray(labels)[jnp.clip(jstep.levels[0], 0)]
        params, opt_state, loss, grads = jax_step(params, opt_state, x, jstep, y)

        pstep = sample.step(s)
        xt = T.gather_features(pstep, g.feats, torch.float32)
        ploss = T.train_step(port_model, opt, xt, pstep, g.labels)

        np.testing.assert_allclose(float(ploss), float(loss), rtol=0, atol=1e-5)
        for (w, gw), (_, pw) in zip(_pairs(port_model, grads),
                                    _pairs(port_model, params)):
            np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw),
                                       rtol=1e-4, atol=1e-6)
            # a tenth of one Adam step at lr 1e-3
            np.testing.assert_allclose(w.detach().numpy(), np.asarray(pw),
                                       rtol=0, atol=1e-4)
