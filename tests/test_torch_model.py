"""Port parity: fanout aggregation, SAGEConv and GraphSAGE, PyTorch port
against the JAX package (and the PyG-semantics goldens)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from cugraph_gnn_tpu.ops.spmm import fanout_aggregate as jax_fanout_aggregate
from cugraph_gnn_tpu.sampler.neighbor_sampler import multihop_uniform_batched
from cugraph_gnn_tpu_torch.models.conv import SAGEConv
from cugraph_gnn_tpu_torch.models.convert import graphsage_from_flax
from cugraph_gnn_tpu_torch.models.zoo import GraphSAGE
from cugraph_gnn_tpu_torch.ops.spmm import fanout_aggregate
from cugraph_gnn_tpu_torch.sampler import neighbor_sampler as port_ns
from cugraph_gnn_tpu_torch.train import gather_features

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "conv_golden.npz")


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_fanout_aggregate_matches_jax(reduce):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 6, 16)).astype(np.float32)
    mask = rng.random((40, 6)) < 0.6
    mask[::7] = False           # rows with no valid neighbor
    want = jax_fanout_aggregate(jnp.asarray(x), jnp.asarray(mask), reduce)
    got = fanout_aggregate(torch.as_tensor(x), torch.as_tensor(mask), reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_sage_conv_matches_golden_on_saturating_fanout():
    """The sampled SAGEConv path equals PyG's full-neighborhood SAGEConv
    (tests/golden/conv_golden.npz) when the fanout covers every in-edge; the
    CSR is built in numpy and sampled with the port's static layout."""
    g = np.load(GOLDEN)
    src, dst, x = g["src"], g["dst"], g["x"]
    n = x.shape[0]
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    indices = src[order]
    max_deg = int(np.diff(indptr).max())
    batch = port_ns.multihop_uniform(indptr, indices, np.arange(n), [max_deg],
                                     dedup=False, device="cpu")
    conv = SAGEConv(x.shape[1], g["sage_out"].shape[1])
    with torch.no_grad():
        conv.lin_self.weight.copy_(torch.as_tensor(g["sage_w_self"].T))
        conv.lin_self.bias.copy_(torch.as_tensor(g["sage_b"]))
        conv.lin_neigh.weight.copy_(torch.as_tensor(g["sage_w_neigh"].T))
    x_all = gather_features(batch, torch.as_tensor(x), torch.float32)
    out = conv(batch.dst_activations(x_all, 0), batch.gather_neighbors(x_all, 0),
               batch.hops[0].mask)
    np.testing.assert_allclose(out.detach().numpy(), g["sage_out"],
                               rtol=1e-4, atol=1e-4)


def _sampled_inputs(seed=0, n=120, f=16, steps=2, b=10, fanouts=(4, 3)):
    """A small graph sampled by the JAX package, the same sample in the
    port (replayed draws), and the feature table."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 12, n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    seeds = rng.integers(0, n, (steps, b)).astype(np.int32)
    seeds[:, ::4] = -1
    key = jax.random.PRNGKey(seed)
    ref = multihop_uniform_batched(key, jnp.asarray(indptr), jnp.asarray(indices),
                                   jnp.asarray(seeds), fanouts)
    us, t = [], steps * b
    for h, k in enumerate(fanouts):
        us.append(np.array(jax.random.uniform(jax.random.fold_in(key, h), (t, k))))
        t *= k + 1
    port = port_ns.multihop_uniform_batched(indptr, indices, seeds, fanouts, u=us,
                                            device="cpu")
    return feats, seeds, ref, port


# bf16: both frameworks round to bf16 after each product, sum and bias, but
# XLA's and PyTorch's CPU bf16 products accumulate in different orders; one
# bf16 ulp is 2^-8 (~0.4%), and two layers compound a few of them.
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_graphsage_forward_matches_flax(dtype, tol):
    feats, seeds, ref, port = _sampled_inputs()
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    model = JaxGraphSAGE(hidden_features=32, out_features=7, num_layers=2,
                         dtype=jdt)
    step0 = jax.tree_util.tree_map(lambda a: a[0], ref)
    params = model.init(jax.random.PRNGKey(1),
                        jnp.asarray(feats)[jnp.clip(step0.input_nodes, 0)], step0)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    port_model = graphsage_from_flax(params_np, dtype=tdt, device="cpu")
    # loading into an existing module gives the same weights
    again = graphsage_from_flax(params_np, GraphSAGE(16, 32, 7, device="cpu"),
                                dtype=tdt)
    for a, b in zip(port_model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    for s in range(seeds.shape[0]):
        jstep = jax.tree_util.tree_map(lambda a: a[s], ref)
        # bench.py's gather: -1 slots read row 0 (garbage, masked)
        x = jnp.asarray(feats)[jnp.clip(jstep.input_nodes, 0)]
        want = np.asarray(model.apply(params, x.astype(jdt or jnp.float32), jstep),
                          np.float32)
        pstep = port.step(s)
        xt = gather_features(pstep, torch.as_tensor(feats), tdt or torch.float32)
        got = port_model(xt, pstep).detach().float().numpy()
        valid = seeds[s] >= 0
        assert got.shape == want.shape
        np.testing.assert_allclose(got[valid], want[valid], rtol=tol, atol=tol)
