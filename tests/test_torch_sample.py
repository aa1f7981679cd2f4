"""Port parity: Floyd positions and one-hop uniform sampling, PyTorch port
against the JAX package, given the same uniform draws.  Exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cugraph_gnn_tpu.ops import sample as jax_sample
from cugraph_gnn_tpu.ops.pallas.sample_kernel import window_select_neighbors
from cugraph_gnn_tpu.ops.window_gather import (
    hub_fraction,
    pad_to_lines,
)
from cugraph_gnn_tpu_torch.ops import sample as port_sample
from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import fused_uniform_sample

K = 10


def _graph(seed, n=300, max_hub=400):
    """CSR with rows of degree 0, <= K, between K and 128, and above 128."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 40, n)
    deg[::13] = 0
    deg[1::7] = rng.integers(1, K + 1, deg[1::7].shape[0])
    if max_hub > 128:
        deg[2::61] = rng.integers(129, max_hub, deg[2::61].shape[0])
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return indptr, indices


def test_floyd_positions_match_jax():
    rng = np.random.default_rng(0)
    s = 500
    deg = rng.integers(0, 300, s).astype(np.int32)
    deg[::5] = rng.integers(0, K + 1, deg[::5].shape[0])
    u = np.array(jax.random.uniform(jax.random.PRNGKey(3), (s, K)))
    want = np.asarray(jax_sample.floyd_positions(jnp.asarray(u),
                                                 jnp.asarray(deg), K))
    got = port_sample.floyd_positions(torch.as_tensor(u), torch.as_tensor(deg), K)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_sample.floyd_positions_np(u, deg, K), want)


@pytest.mark.parametrize("path", ["plain", "window"])
def test_uniform_sample_matches_jax(path):
    indptr, indices = _graph(1)
    n = indptr.shape[0] - 1
    seeds = np.random.default_rng(2).integers(0, n, 700).astype(np.int32)
    key = jax.random.PRNGKey(7)
    deg = indptr[1:] - indptr[:-1]
    if path == "plain":
        kw = {}
        jax_indices = jnp.asarray(indices)
    else:
        # as bench.py calls it: line view of the padded indices, static
        # max degree and hub fraction
        jax_indices = jnp.asarray(pad_to_lines(indices))
        kw = dict(indices2d=jax_indices.reshape(-1, 128),
                  max_degree=int(deg.max()), hub_frac=hub_fraction(indptr))
    want = jax_sample.uniform_sample(key, jnp.asarray(indptr), jax_indices,
                                     jnp.asarray(seeds), K, **kw)
    u = np.array(jax.random.uniform(key, (seeds.shape[0], K)))
    got = port_sample.uniform_sample(indptr, indices, seeds, K, u=u,
                                     device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_neighbor_read_matches_window_select_kernel():
    """The port's fused neighbor read against the Pallas neighbor-select
    kernel (interpret mode), on a graph with max degree <= 128."""
    indptr, indices = _graph(3, n=200, max_hub=0)
    n = indptr.shape[0] - 1
    seeds = np.random.default_rng(4).integers(0, n, 150).astype(np.int32)
    u = np.random.default_rng(5).random((seeds.shape[0], K), dtype=np.float32)
    got = fused_uniform_sample(*(torch.as_tensor(a) for a in
                                 (indptr, indices, seeds, u)), K)
    start = indptr[seeds]
    pos = port_sample.floyd_positions_np(u, indptr[seeds + 1] - start, K)
    with pltpu.force_tpu_interpret_mode():
        nbr = window_select_neighbors(jnp.asarray(indices), jnp.asarray(start),
                                      jnp.asarray(np.maximum(pos, 0)))
    want = np.where(pos >= 0, np.asarray(nbr), -1)
    np.testing.assert_array_equal(got.neighbors.numpy(), want)


def test_padded_seeds_and_empty_graph():
    indptr, indices = _graph(6, n=50)
    seeds = np.array([3, -1, 7, -1], np.int32)
    u = np.random.default_rng(0).random((4, K), dtype=np.float32)
    out = port_sample.uniform_sample(indptr, indices, seeds, K, u=u,
                                     device="cpu")
    for t in (out.neighbors, out.edge_ids):
        assert (t[1] == -1).all() and (t[3] == -1).all()
    assert out.num_sampled[1] == 0 and out.num_sampled[3] == 0
    empty = port_sample.uniform_sample(np.zeros(5, np.int32), np.zeros(0, np.int32),
                                       seeds, K, u=u, device="cpu")
    want = jax_sample._empty_output(4, K)
    for g, w in zip(empty, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
