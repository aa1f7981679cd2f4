"""Port parity: multi-hop uniform sampling in the static (dedup=False) and
the deduplicated layout, the ``NeighborSampler`` class (with capped levels)
and the COO / CSC views of its batches, PyTorch port against the JAX
package, replaying the JAX draws (one ``fold_in(key, h)`` stream per hop).
Exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_gnn_tpu.ops.window_gather import (
    hub_fraction,
    hub_fraction_edgewise,
    pad_to_lines,
)
from cugraph_gnn_tpu.sampler import neighbor_sampler as jax_ns
from cugraph_gnn_tpu.sampler import output as jax_out
from cugraph_gnn_tpu_torch.sampler import neighbor_sampler as port_ns
from cugraph_gnn_tpu_torch.sampler import output as port_out

FANOUTS = (4, 3)
S, B = 3, 12


def _graph(seed=0, n=250):
    """Rows of degree 0, <= fanout, and above 128."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 30, n)
    deg[::11] = 0
    deg[1::9] = rng.integers(1, 4, deg[1::9].shape[0])
    deg[2::71] = 200
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return indptr, indices


def _seeds(shape, n, seed=1):
    seeds = np.random.default_rng(seed).integers(0, n, shape).astype(np.int32)
    seeds.reshape(-1)[::5] = -1
    return seeds


def _replayed_draws(key, batch, fanouts, caps=None):
    """The uniforms the JAX sampler draws for hop h: fold_in(key, h) over
    the flattened frontier of that hop (``caps[h]`` targets when given)."""
    caps = caps or jax_ns.level_capacities(batch, fanouts)
    return [np.array(jax.random.uniform(jax.random.fold_in(key, h), (caps[h], k)))
            for h, k in enumerate(fanouts)]


def _assert_same(port, ref):
    assert port.static_layout == ref.static_layout
    for a, b in zip(port.levels, ref.levels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(port.level_counts, ref.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(port.seed_count.numpy(),
                                  np.asarray(ref.seed_count))
    for hp, hr in zip(port.hops, ref.hops):
        for name in ("neigh_local", "neigh_global", "edge_ids"):
            np.testing.assert_array_equal(getattr(hp, name).numpy(),
                                          np.asarray(getattr(hr, name)))
        np.testing.assert_array_equal(hp.mask.numpy(), np.asarray(hr.mask))


@pytest.mark.parametrize("path", ["plain", "window"])
def test_multihop_batched_matches_jax(path):
    indptr, indices = _graph()
    n = indptr.shape[0] - 1
    seeds = _seeds((S, B), n)
    key = jax.random.PRNGKey(11)
    if path == "plain":
        jax_indices, kw = jnp.asarray(indices), {}
    else:
        # bench.py's call: line view, static max degree, hub fractions
        jax_indices = jnp.asarray(pad_to_lines(indices))
        deg = indptr[1:] - indptr[:-1]
        kw = dict(indices2d=jax_indices.reshape(-1, 128),
                  max_degree=int(deg.max()),
                  hub_frac=(hub_fraction(indptr), hub_fraction_edgewise(indptr)))
    ref = jax_ns.multihop_uniform_batched(key, jnp.asarray(indptr), jax_indices,
                                          jnp.asarray(seeds), FANOUTS, **kw)
    port = port_ns.multihop_uniform_batched(
        indptr, indices, seeds, FANOUTS,
        u=_replayed_draws(key, S * B, FANOUTS), device="cpu")
    _assert_same(port, ref)
    for s in range(S):
        _assert_same(port.step(s), jax.tree_util.tree_map(lambda a: a[s], ref))


def test_multihop_single_matches_jax():
    indptr, indices = _graph(2)
    seeds = _seeds((B,), indptr.shape[0] - 1, seed=3)
    key = jax.random.PRNGKey(5)
    ref = jax_ns.multihop_uniform(key, jnp.asarray(indptr), jnp.asarray(indices),
                                  jnp.asarray(seeds), FANOUTS, dedup=False)
    port = port_ns.multihop_uniform(indptr, indices, seeds, FANOUTS, dedup=False,
                                    u=_replayed_draws(key, B, FANOUTS),
                                    device="cpu")
    _assert_same(port, ref)
    assert port_ns.level_capacities(B, FANOUTS) == jax_ns.level_capacities(
        B, FANOUTS)


# NeighborSampler configurations: (dedup, max_unique_per_hop); (30, 60)
# caps both levels below their 36 and 144 slots, so new nodes are dropped
SAMPLER_CASES = {"dedup": (True, None), "static": (False, None),
                 "capped": (True, (30, 60))}


@pytest.fixture(scope="module")
def sampled():
    """The graph, seeds and key, and each configuration's JAX sample and the
    port's on the same draws, computed once."""
    indptr, indices = _graph(7)
    seeds = _seeds((B,), indptr.shape[0] - 1, seed=8)
    key = jax.random.PRNGKey(21)
    out = {}
    for name, (dedup, caps) in SAMPLER_CASES.items():
        ref = jax_ns.NeighborSampler(indptr, indices, FANOUTS, dedup=dedup,
                                     max_unique_per_hop=caps).sample(key, jnp.asarray(seeds))
        sampler = port_ns.NeighborSampler(indptr, indices, FANOUTS, dedup=dedup,
                                          max_unique_per_hop=caps, device="cpu")
        lv = sampler.level_caps(B)
        assert lv == [int(a.shape[0]) for a in ref.levels]
        out[name] = ref, sampler.sample(seeds, u=_replayed_draws(key, B, FANOUTS, lv))
    return (indptr, indices, seeds, key), out


def test_multihop_dedup_and_generator_draws(sampled):
    (indptr, indices, seeds, key), out = sampled
    # JAX's multihop_uniform(dedup=True) is its uncapped NeighborSampler
    port = port_ns.multihop_uniform(indptr, indices, seeds, FANOUTS, device="cpu",
                                    u=_replayed_draws(key, B, FANOUTS))
    assert not port.static_layout
    _assert_same(port, out["dedup"][0])
    # without u, the draws come from the generator: same seed, same sample
    for dedup in (False, True):
        a, b = (port_ns.multihop_uniform(
            indptr, indices, seeds, FANOUTS, dedup=dedup, device="cpu",
            generator=torch.Generator().manual_seed(9)) for _ in range(2))
        for x, y in zip(a.levels, b.levels):
            assert torch.equal(x, y)


@pytest.mark.parametrize("name", sorted(SAMPLER_CASES))
def test_neighbor_sampler_matches_jax(sampled, name):
    ref, port = sampled[1][name]
    _assert_same(port, ref)
    if name == "capped":   # the caps really dropped nodes
        assert bool((port.hops[1].neigh_global >= 0).sum() > port.hops[1].mask.sum())


@pytest.mark.parametrize("name", sorted(SAMPLER_CASES))
def test_to_coo_and_csc_match_jax(sampled, name):
    ref, port = sampled[1][name]
    for got, want in ((port_out.to_coo(port), jax_out.to_coo(ref)),
                      (port_out.to_csc(port), jax_out.to_csc(ref))):
        assert got.edge_hi is None and want.edge_hi is None
        for field in got._fields[:-1]:
            g, w = getattr(got, field), getattr(want, field)
            for a, b in (zip(g, w) if isinstance(g, list) else [(g, w)]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=field)


def test_neighbor_sampler_refuses_what_waits():
    """Since weighted and temporal sampling are ported, what the sampler
    still refuses: per-edge arrays of the wrong length, and caps that break
    the levels' prefix invariant or need the static layout deduplicated."""
    indptr, indices = _graph(1)
    for kw in ({"weights": np.ones(len(indices) - 1)}, {"edge_times": np.ones(3)}):
        with pytest.raises(ValueError, match="one entry per edge"):
            port_ns.NeighborSampler(indptr, indices, FANOUTS, device="cpu", **kw)
    with pytest.raises(ValueError, match="dedup=True"):
        port_ns.NeighborSampler(indptr, indices, FANOUTS, dedup=False, max_unique_per_hop=(20, 60),
                                device="cpu")
    with pytest.raises(ValueError, match="smaller than"):
        port_ns.NeighborSampler(indptr, indices, FANOUTS, max_unique_per_hop=(5, 60),
                                device="cpu").sample(np.zeros(B, np.int32))
