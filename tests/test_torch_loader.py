"""Port parity: the user-facing loader path (``GraphStore`` -> ``FeatureStore``
-> ``NeighborLoader`` with deduplicated sampling), PyTorch port against the
JAX package on small graphs.

- ``GraphStore.finalize``: the reversed CSR per edge type (indptr, indices,
  the COO permutation, edge bases, offsets), homogeneous and typed; exact.
- ``FeatureStore`` id gathers with -1 and past-the-end ids, local and over a
  one-rank gloo mesh (``DistArray``); exact.
- ``DistArray`` at world 1 against numpy indexing; exact.
- One shuffled epoch of ``NeighborLoader`` with a padded last batch: the
  test replaces the port loader's sampler by a thin wrapper that hands batch
  i the JAX loader's draws (``fold_in(fold_in(fold_in(PRNGKey(seed),
  epoch), i), h)``); seeds, ``input_id``, every level, map and count, x and
  y exact.
- The slice as a whole: two float32 GraphSAGE train steps (Adam 1e-3) on the
  first two loader batches from the same flax weights; losses within 1e-5,
  gradients within 1e-5 + 1e-5 * |gradient|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.nn import functional as F

from cugraph_gnn_tpu.data import FeatureStore as JaxFeatureStore
from cugraph_gnn_tpu.data import GraphStore as JaxGraphStore
from cugraph_gnn_tpu.loader import NeighborLoader as JaxNeighborLoader
from cugraph_gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.loader import NeighborLoader
from cugraph_gnn_tpu_torch.sampler.hetero import HeteroNeighborSampler
from cugraph_gnn_tpu_torch.models.convert import graphsage_from_flax
from cugraph_gnn_tpu_torch.store.dist_array import DistArray
from cugraph_gnn_tpu_torch.utils import distributed as D

N, F_IN, HIDDEN, CLASSES = 150, 6, 16, 4
BATCH, FANOUTS, SEED = 32, (4, 3), 5
ET = ("n", "to", "n")


def _graph(seed=0, n=N, e=1200):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    dst[:40] = 3                  # a hub row
    x = rng.standard_normal((n, F_IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, n)
    return src, dst, x, y


def _stores(jax_side, src, dst, x, y, **fs_kw):
    if jax_side:
        gs, fs = JaxGraphStore(), JaxFeatureStore(**fs_kw)
    else:
        gs, fs = GraphStore(device="cpu"), FeatureStore(device="cpu", **fs_kw)
    gs.put_edge_index((src, dst), ET, num_nodes=(N, N))
    fs["x"] = x
    fs["y"] = y
    return fs, gs


def _assert_sample_equal(port, ref):
    assert port.static_layout == ref.static_layout
    for a, b in zip(port.levels + port.level_counts, ref.levels + ref.level_counts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for hp, hr in zip(port.hops, ref.hops):
        for name in ("neigh_local", "neigh_global", "edge_ids"):
            np.testing.assert_array_equal(getattr(hp, name).numpy(),
                                          np.asarray(getattr(hr, name)))


# -- GraphStore ---------------------------------------------------------------

def test_graph_store_finalize_matches_jax():
    rng = np.random.default_rng(1)
    stores = []
    for side in (True, False):
        gs = JaxGraphStore() if side else GraphStore(device="cpu")
        # typed: two node types, two edge types (lexicographic offsets)
        gs.put_edge_index((rng.integers(0, 30, 200), rng.integers(0, 20, 200)),
                          ("paper", "cites", "author"), num_nodes=(30, 20))
        gs.put_edge_index((rng.integers(0, 20, 90), rng.integers(0, 30, 90)),
                          ("author", "writes", "paper"))
        stores.append(gs.finalize())
        rng = np.random.default_rng(1)
    ref, port = stores
    assert port.num_nodes_total == ref.num_nodes_total
    assert port.node_offsets == ref.node_offsets and port.etypes == ref.etypes
    assert port.max_degree_by_etype == ref.max_degree_by_etype
    assert not port.is_homogeneous
    for et in ref.etypes:
        ip, ix, base = port.csr_by_etype[et]
        jip, jix, jbase = ref.csr_by_etype[et]
        assert base == jbase and ip.dtype == ix.dtype == torch.int32
        np.testing.assert_array_equal(ip.numpy(), np.asarray(jip))
        # the JAX indices carry line padding past the edges
        np.testing.assert_array_equal(ix.numpy(), np.asarray(jix)[:ix.shape[0]])
        np.testing.assert_array_equal(port.edge_perm_by_etype[et],
                                      ref.edge_perm_by_etype[et])
        attr = np.arange(len(port.edge_perm_by_etype[et])) * 3
        np.testing.assert_array_equal(port.edge_attr_to_csr_order(et, attr).numpy(),
                                      np.asarray(ref.edge_attr_to_csr_order(et, attr)))

    src, dst, x, y = _graph()
    (_, jgs), (_, pgs) = (_stores(s, src, dst, x, y) for s in (True, False))
    for a, b in zip(pgs.finalize().homogeneous_csr(), jgs.finalize().homogeneous_csr()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:a.shape[0]])
    # a rank-local slice is the distributed loaders' (tests/test_torch_dist_loader.py):
    # the one-device sampling graph refuses it
    pgs.put_local_edge_index((src, dst), ET, num_nodes=(N, N))
    assert pgs.has_local_edges
    with pytest.raises(ValueError, match="rank-local"):
        pgs.finalize()


# -- FeatureStore and DistArray ------------------------------------------------

@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A one-rank gloo mesh in this process, left at the end of the module."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    m = D.init(init_method=f"file://{store}", rank=0, world_size=1, device="cpu")
    yield m
    D.finalize()


IDS = np.array([5, -1, 0, N + 4, 149, -1, 17, 17], np.int64)   # N + 4: past the end


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_feature_store_gathers_match_jax(mesh, where):
    src, dst, x, y = _graph(2)
    jfs, _ = _stores(True, src, dst, x, y, pad_features_to=4)
    pfs, _ = _stores(False, src, dst, x, y, pad_features_to=4,
                     **({"mesh": mesh} if where == "mesh" else {}))
    for attr in ("x", "y"):
        got = pfs.get_tensor("", attr, ids=torch.as_tensor(IDS))
        want = np.array(jfs.get_tensor("", attr, ids=jnp.asarray(IDS)))
        if where == "mesh":   # the exchange gives fill rows for ids no rank holds
            want[IDS >= N] = 0
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(pfs[attr].numpy(), np.asarray(jfs[attr]))
        assert pfs[attr].device == got.device == torch.device(pfs.device)
        assert pfs.get_tensor_size("", attr) == jfs.get_tensor_size("", attr)
    assert ("", "x") in pfs and "z" not in pfs
    # host-located tensors (tests/test_torch_cache.py holds them against JAX)
    pfs.put_tensor(x, "", "h", location="host")
    np.testing.assert_array_equal(pfs.get_tensor("", "h", ids=torch.as_tensor(IDS)).numpy(),
                                  np.asarray(jfs.get_tensor("", "x", ids=jnp.asarray(IDS)))
                                  * ((IDS < N)[:, None]))


def test_dist_array_world_1(mesh):
    rng = np.random.default_rng(3)
    host = rng.standard_normal((11, 3)).astype(np.float32)
    arr = DistArray.from_array(host, mesh)
    assert arr.shape == (11, 3) and arr.dtype == torch.float32 and arr.world == 1
    np.testing.assert_array_equal(arr.to_global().numpy(), host)
    np.testing.assert_array_equal(arr.local_shard(0).numpy(), host)
    ids = torch.tensor([3, -1, 10, 0, 3])
    got = arr.gather(ids, fill=-2)
    want = np.where((ids >= 0).numpy()[:, None], host[ids.clamp(min=0).numpy()], -2)
    np.testing.assert_array_equal(got.numpy(), want)
    arr.scatter(torch.tensor([1, -1, 4]), torch.ones(3, 3))
    host[[1, 4]] = 1
    arr.scatter_add(torch.tensor([2, 2, -1, 7]), torch.full((4, 3), 0.5))
    host[2] += 1.0
    host[7] += 0.5
    np.testing.assert_array_equal(arr.to_global().numpy(), host)
    zeros = DistArray.create((5, 2), torch.int64, mesh)
    assert zeros.shape == (5, 2) and zeros.dtype == torch.int64
    assert int(zeros.to_global().abs().sum()) == 0


# -- NeighborLoader over one epoch, and two train steps --------------------------

class _ReplaySampler:
    """The port loader's sampler with batch i's draws taken from the JAX
    loader's key for that batch."""

    def __init__(self, inner, key):
        self.inner, self.key, self.calls = inner, key, 0

    def sample(self, seeds, generator=None):
        skey = jax.random.fold_in(self.key, self.calls)
        self.calls += 1
        caps = self.inner.level_caps(seeds.shape[0])
        u = [np.array(jax.random.uniform(jax.random.fold_in(skey, h), (caps[h], k)))
             for h, k in enumerate(self.inner.fanouts)]
        return self.inner.sample(seeds, u=u)


@pytest.fixture(scope="module")
def epoch():
    """One shuffled epoch of each loader (dedup=True) over the same stores."""
    src, dst, x, y = _graph(4)
    kw = dict(num_neighbors=FANOUTS, batch_size=BATCH, shuffle=True, seed=SEED)
    jl = JaxNeighborLoader(_stores(True, src, dst, x, y), **kw)
    pl = NeighborLoader(_stores(False, src, dst, x, y), **kw)
    pl.sampler = _ReplaySampler(pl.sampler, jax.random.fold_in(jax.random.PRNGKey(SEED), 0))
    return list(jl), list(pl)


def test_neighbor_loader_epoch_matches_jax(epoch):
    ref, port = epoch
    assert len(port) == len(ref) == -(-N // BATCH)
    assert int((port[-1].seeds < 0).sum()) == BATCH * len(port) - N   # padded
    for p, r in zip(port, ref):
        assert p.batch_size == r.batch_size == BATCH
        for a, b in ((p.seeds, r.seeds), (p.input_id, r.input_id), (p.x, r.x), (p.y, r.y),
                     (p.num_valid, r.num_valid)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _assert_sample_equal(p.sample, r.sample)
        assert not p.sample.static_layout


def test_loader_train_steps_match_jax(epoch):
    ref, port = epoch
    model = JaxGraphSAGE(hidden_features=HIDDEN, out_features=CLASSES, num_layers=2)
    params = jax.jit(model.init)(jax.random.PRNGKey(7), ref[0].x, ref[0].sample)
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, batch):
        def loss_fn(p):
            logits = model.apply(p, batch.x, batch.sample).astype(jnp.float32)
            valid = batch.seeds >= 0
            ls = optax.softmax_cross_entropy_with_integer_labels(logits, batch.y)
            return jnp.sum(jnp.where(valid, ls, 0)) / jnp.maximum(jnp.sum(valid), 1)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    port_model = graphsage_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    opt = torch.optim.Adam(port_model.parameters(), lr=1e-3)
    for p, r in zip(port[:2], ref[:2]):
        params, opt_state, loss, grads = jax_step(params, opt_state, r)
        opt.zero_grad(set_to_none=True)
        logits = port_model(p.x, p.sample).float()
        valid = p.seeds >= 0
        ls = F.cross_entropy(logits, p.y.long(), reduction="none")
        ploss = torch.where(valid, ls, 0).sum() / valid.sum().clamp(min=1)
        ploss.backward()
        opt.step()
        np.testing.assert_allclose(float(ploss.detach()), float(loss), rtol=0, atol=1e-5)
        for i, conv in enumerate(port_model.convs):
            g = grads["params"][f"conv_{i}"]
            for w, gw in ((conv.lin_self.weight, g["lin_self"]["kernel"].T),
                          (conv.lin_self.bias, g["lin_self"]["bias"]),
                          (conv.lin_neigh.weight, g["lin_neigh"]["kernel"].T)):
                np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw),
                                           rtol=1e-5, atol=1e-5)


def test_loader_refuses_what_waits():
    """Weighted, temporal, disjoint, "auto" and hetero loading are ported
    (tests/test_torch_weighted.py, test_torch_temporal.py,
    test_torch_disjoint.py, test_torch_hetero_loader.py); rank-local edge
    shards are the distributed loaders' (tests/test_torch_dist_loader.py): a
    one-device loader refuses them."""
    src, dst, x, y = _graph(5)
    data = _stores(False, src, dst, x, y)
    # typed input nodes on a one-type store: offset 0, the untyped batch
    typed = next(iter(NeighborLoader(data, FANOUTS, input_nodes=("n", np.arange(10)),
                                     batch_size=BATCH, seed=1)))
    plain = next(iter(NeighborLoader(data, FANOUTS, input_nodes=np.arange(10),
                                     batch_size=BATCH, seed=1)))
    _assert_sample_equal(typed.sample, plain.sample)
    assert torch.equal(typed.x, plain.x)
    # typed labels are read under (node_type, "y"), as in JAX: this store has none
    assert typed.y is None and plain.y is not None
    gs = GraphStore(device="cpu")
    gs.put_edge_index((src, dst), ET, num_nodes=(N, N))
    gs.put_edge_index((dst, src), ("n", "from", "n"), num_nodes=(N, N))
    assert isinstance(NeighborLoader((data[0], gs), FANOUTS).sampler,
                      HeteroNeighborSampler)
    gs.put_local_edge_index((src, dst), ET, num_nodes=(N, N))
    with pytest.raises(ValueError, match="rank-local"):
        NeighborLoader((data[0], gs), FANOUTS)
    # without the replay, the generator's draws: same seed, same batches
    a, b = (next(iter(NeighborLoader(data, FANOUTS, batch_size=BATCH, seed=1)))
            for _ in range(2))
    _assert_sample_equal(a.sample, b.sample)
