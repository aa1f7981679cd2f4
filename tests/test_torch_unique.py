"""Port parity: ``append_unique`` (sort-based renumbering with static
shapes) against the JAX package's and against the ragged host reference
``append_unique_np``.  Integer outputs: exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_gnn_tpu.ops import unique as jax_unique
from cugraph_gnn_tpu_torch.ops import unique as port_unique

# jitted: eager JAX compiles each of its ops once per shape
_jax_append_unique = jax.jit(jax_unique.append_unique, static_argnames="max_unique")


def _case(name):
    """targets (unique; padded with -1 in "padded_targets"), raw neighbors
    with -1 padding, duplicates and targets among them, and a budget."""
    rng = np.random.default_rng(len(name))
    targets = rng.choice(500, 40, replace=False).astype(np.int32)
    neighbors = rng.integers(0, 500, 400).astype(np.int32)
    neighbors[::7] = -1
    neighbors[1::9] = targets[rng.integers(0, 40, neighbors[1::9].shape[0])]
    neighbors[2::13] = neighbors[3]
    full = 40 + 400
    if name == "padded_targets":   # a capped level's -1 tail as targets
        targets[30:] = -1
    budget = {"full": full, "padded_targets": full, "clamped": 120, "tiny": 41,
              "below_targets": 25}[name]
    return targets, neighbors, budget


@pytest.mark.parametrize("name", ["full", "padded_targets", "clamped", "tiny",
                                  "below_targets"])
def test_append_unique_matches_jax(name):
    targets, neighbors, budget = _case(name)
    want = _jax_append_unique(jnp.asarray(targets), jnp.asarray(neighbors),
                                    max_unique=budget)
    got = port_unique.append_unique(torch.as_tensor(targets), torch.as_tensor(neighbors),
                                    max_unique=budget)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_append_unique_matches_host_reference():
    targets, neighbors, budget = _case("full")
    got = port_unique.append_unique(torch.as_tensor(targets), torch.as_tensor(neighbors),
                                    max_unique=budget)
    nodes, nmap = port_unique.append_unique_np(targets, neighbors)
    want_nodes, want_map = jax_unique.append_unique_np(targets, neighbors)
    np.testing.assert_array_equal(nodes, want_nodes)
    np.testing.assert_array_equal(nmap, want_map)
    n = int(got.num_unique)
    assert n == len(nodes)
    np.testing.assert_array_equal(got.unique_nodes[:n].numpy(), nodes)
    assert bool((got.unique_nodes[n:] == -1).all())
    np.testing.assert_array_equal(got.neighbor_map[neighbors >= 0].numpy(), nmap)
    assert bool((got.neighbor_map[neighbors < 0] == -1).all())
