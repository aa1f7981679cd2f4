"""Port parity: the distributed loaders and trainer against the JAX package's.

- At a gloo world of 2 ranks against JAX's ``DistNeighborLoader`` and
  ``DistLinkNeighborLoader`` on a 2-device CPU mesh (shuffled, the JAX
  draws replayed in each owner's frame as in ``test_torch_dist_sampler.py``,
  the link loader's negatives taken from the JAX batch): each rank's seeds,
  input ids, levels, blocks, features and labels are JAX's shard r; the
  link batch's seed layout, ``edge_label_index`` and ``edge_label`` are
  JAX's, exactly.  Three steps of ``train_dist.dist_train_step`` from the
  flax parameters against ``examples/multichip_training.py``'s update
  (GraphSAGE, optax Adam 1e-2, the global masked mean): losses and
  parameters within 1e-5 (float32).
- At a gloo world of 4 ranks: the rank-local mode (``put_local_edge_index``,
  its node count agreed over the ranks, weighted) equal to the global
  mode's batches bit for bit, an epoch of each; the bounded multi-round
  gather (a forced ``recv_cap``, through ``DistArray.gather`` and
  ``_dist_gather_shard`` with ``read_rows``) equal to the one exchange; ``GraphStore.finalize`` refuses a
  rank-local store; ``auto_mesh`` of two hosts is the (node, device) mesh,
  and a store of two edge types loads through the hetero sampler.

The JAX package is imported inside fixtures only: the spawned ranks import
this file and run torch alone.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

N, E, F, CLASSES = 120, 1500, 8, 4
FANOUTS = (3, 2)
BATCH = 45                # padded to 46 at world 2 (23 seeds a rank)
LINK_BATCH, LINK_EDGES = 16, 40
SEED, LR, STEPS, HIDDEN = 3, 1e-2, 3, 16
ET = ("n", "e", "n")


def _data():
    rng = np.random.default_rng(5)
    src = rng.integers(0, N, E).astype(np.int64)
    dst = rng.integers(0, N, E).astype(np.int64)
    dst[:150] = 9                               # a hub: uneven edge-balanced shards
    dst[-1] = N - 1                             # the largest id appears (agreed node count)
    x = rng.standard_normal((N, F)).astype(np.float32)
    y = rng.integers(0, CLASSES, N).astype(np.int32)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32)
    pick = rng.choice(E, LINK_EDGES, replace=False)
    return src, dst, x, y, w, np.stack([src[pick], dst[pick]])


def _port_stores(device="cpu", local=None):
    """Port stores: the whole graph, or (``local`` = (rank, world)) this
    rank's slice of the edges and of the weights."""
    from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore

    src, dst, x, y, w, _ = _data()
    gs, fs = GraphStore(device=device), FeatureStore(device=device)
    if local is None:
        gs.put_edge_index((src, dst), ET, num_nodes=(N, N))
        fs["w"] = w
    else:
        mine = np.array_split(np.arange(E), local[1])[local[0]]
        gs.put_local_edge_index((src[mine], dst[mine]), ET)
        fs["w"] = w[mine]
    fs["x"], fs["y"] = x, y
    return fs, gs


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


class _Replay:
    """A sampler whose i-th call takes this rank's replayed draws of batch i."""

    def __init__(self, inner, draws, prefix, rank):
        self.inner, self.draws, self.prefix, self.rank, self.calls = (inner, draws, prefix,
                                                                      rank, 0)
        self.fanouts = inner.fanouts

    def sample(self, seeds, node_times=None, generator=None):
        u = [torch.as_tensor(self.draws[f"{self.prefix}/{self.calls}/{h}/{self.rank}"])
             for h in range(len(self.fanouts))]
        self.calls += 1
        return self.inner.sample(seeds, node_times, u=u)


def _save_sample(res, key, sample):
    for i, lv in enumerate(sample.levels):
        res[f"{key}/level/{i}"] = lv.numpy()
    res[f"{key}/counts"] = torch.stack(sample.level_counts).numpy()
    for h, hop in enumerate(sample.hops):
        for j, name in enumerate(("neigh_local", "neigh_global", "edge_ids")):
            res[f"{key}/hop/{h}/{name}"] = hop[j].numpy()


def _worker2(rank, world, store, out_dir):
    """World 2: the node and link loaders on replayed draws, and three
    ``dist_train_step``s from the flax parameters."""
    from cugraph_gnn_tpu_torch.loader import DistLinkNeighborLoader, DistNeighborLoader
    from cugraph_gnn_tpu_torch.models.convert import graphsage_from_flax
    from cugraph_gnn_tpu_torch.train_dist import dist_train_step
    from cugraph_gnn_tpu_torch.utils import distributed as D

    torch.set_num_threads(1)
    mesh = D.init(init_method=f"file://{store}", rank=rank, world_size=world, device="cpu")
    try:
        draws = np.load(os.path.join(out_dir, "draws.npz"))
        data = _port_stores()
        res = {}
        loader = DistNeighborLoader(data, FANOUTS, mesh, batch_size=BATCH, shuffle=True,
                                    seed=SEED)
        loader.sampler = _Replay(loader.sampler, draws, "node", rank)
        model = graphsage_from_flax(_nest(dict(np.load(os.path.join(out_dir, "params.npz")))),
                                    device="cpu")
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        losses = []
        for i, b in zip(range(STEPS), loader):
            _save_sample(res, f"node/{i}", b.sample)
            for name in ("seeds", "input_id", "x", "y"):
                res[f"node/{i}/{name}"] = getattr(b, name).numpy()
            losses.append(float(dist_train_step(model, opt, b, mesh)))
        res["losses"] = np.array(losses)
        for key, p in model.state_dict().items():
            res[f"param/{key}"] = p.numpy()

        eli = _data()[5]
        link = DistLinkNeighborLoader(data, FANOUTS, mesh, edge_label_index=eli,
                                      neg_sampling="binary", batch_size=LINK_BATCH,
                                      shuffle=True, seed=SEED)
        link.sampler = _Replay(link.sampler, draws, "link", rank)
        calls = iter(range(10))

        def negatives(ps, n):           # JAX's negatives of the batch
            i = next(calls)
            return tuple(torch.as_tensor(draws[f"link/neg/{i}/{k}"]) for k in ("src", "dst"))

        link._negatives = negatives
        for i, b in zip(range(2), link):
            _save_sample(res, f"link/{i}", b.sample)
            for name in ("x", "seeds", "edge_label_index", "edge_label", "input_id"):
                res[f"link/{i}/{name}"] = getattr(b, name).numpy()
        np.savez(os.path.join(out_dir, f"out_{rank}.npz"), **res)
    finally:
        D.finalize()


def _frames(targets, jbook, world):
    """The rows of each owner's JAX receive buffer that hold real ids (see
    ``test_torch_dist_sampler.py``)."""
    owner = np.clip(jbook.owner_of_np(np.maximum(targets, 0)), 0, world - 1)
    owner = np.where(targets >= 0, owner, world - 1)
    out = []
    for r in range(world):
        pos, keep, start = [], [], 0
        for s in range(world):
            mine = np.flatnonzero(owner[s] == r)
            pos.extend(range(start, start + len(mine)))
            keep.extend(targets[s, mine] >= 0)
            start += len(mine)
        out.append(np.asarray(pos, np.int64)[np.asarray(keep, bool)])
    return out


def _replay_draws(draws, prefix, i, batch, book, key, world):
    """The port's draws of batch i: hop h's uniforms of each owner's frame
    of JAX's key ``fold_in(fold_in(key, h), r)``."""
    import jax

    for h, k in enumerate(FANOUTS):
        targets = np.asarray(batch.sample.levels[h]).reshape(world, -1)
        for r, frame in enumerate(_frames(targets, book, world)):
            skey = jax.random.fold_in(jax.random.fold_in(key, h), r)
            u = np.asarray(jax.random.uniform(skey, (targets.size, k)))
            draws[f"{prefix}/{i}/{h}/{r}"] = u[frame]


@pytest.fixture(scope="module")
def want():
    """JAX's node batches and link batches at world 2, the example's three
    updates, and the port's replayed draws."""
    import jax
    import jax.numpy as jnp
    import optax

    from cugraph_gnn_tpu.data import FeatureStore as JaxFS
    from cugraph_gnn_tpu.data import GraphStore as JaxGS
    from cugraph_gnn_tpu.loader import DistLinkNeighborLoader as JaxLink
    from cugraph_gnn_tpu.loader import DistNeighborLoader as JaxNode
    from cugraph_gnn_tpu.models import GraphSAGE as JaxGraphSAGE
    from cugraph_gnn_tpu.parallel.mesh import create_store_mesh

    world = 2
    src, dst, x, y, w, eli = _data()
    gs, fs = JaxGS(), JaxFS()
    gs.put_edge_index((src, dst), ET, num_nodes=(N, N))
    fs[("", "x")], fs[("", "y")] = x, y
    mesh = create_store_mesh(world)
    draws = {}
    node = JaxNode((fs, gs), list(FANOUTS), mesh=mesh, batch_size=BATCH, shuffle=True,
                   seed=SEED)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    nodes = [b for _, b in zip(range(STEPS), node)]
    for i, b in enumerate(nodes):
        _replay_draws(draws, "node", i, b, node.dist_graph.book, jax.random.fold_in(key, i),
                      world)

    model = JaxGraphSAGE(hidden_features=HIDDEN, out_features=CLASSES, num_layers=2)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), nodes[0].x, nodes[0].sample)
    flat = _flat(jax.tree_util.tree_map(np.asarray, params))
    tx = optax.adam(LR)
    opt = tx.init(params)

    @jax.jit
    def update(params, opt, batch):          # examples/multichip_training.py:73-84
        def loss_fn(p):
            logits = model.apply(p, batch.x, batch.sample)
            valid = batch.seeds >= 0
            ls = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.clip(batch.y, 0))
            return jnp.sum(jnp.where(valid, ls, 0)) / jnp.maximum(jnp.sum(valid), 1)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        u, opt = tx.update(grads, opt)
        return optax.apply_updates(params, u), opt, loss

    losses = []
    for b in nodes:
        params, opt, loss = update(params, opt, b)
        losses.append(float(loss))

    link = JaxLink((fs, gs), list(FANOUTS), mesh=mesh, edge_label_index=eli,
                   neg_sampling="binary", batch_size=LINK_BATCH, shuffle=True, seed=SEED)
    links = [b for _, b in zip(range(2), link)]
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    b2, n_neg = LINK_BATCH, link.num_neg
    for i, b in enumerate(links):
        seeds = np.asarray(b.seeds)
        draws[f"link/neg/{i}/src"] = seeds[2 * b2:2 * b2 + n_neg].astype(np.int32)
        draws[f"link/neg/{i}/dst"] = seeds[2 * b2 + n_neg:2 * b2 + 2 * n_neg].astype(np.int32)
        _replay_draws(draws, "link", i, b, link._nl.dist_graph.book,
                      jax.random.fold_in(jax.random.fold_in(key, i), 2), world)
    return dict(nodes=nodes, links=links, losses=losses, flat=flat, draws=draws,
                params=jax.tree_util.tree_map(np.asarray, params)["params"])


def _spawn(worker, world, tmp_path_factory, **arrays):
    out_dir = tmp_path_factory.mktemp(f"dist_loader_world{world}")
    for name, a in arrays.items():
        np.savez(out_dir / f"{name}.npz", **a)
    mp.spawn(worker, args=(world, str(out_dir / "store"), str(out_dir)), nprocs=world,
             join=True)
    return [dict(np.load(out_dir / f"out_{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def got2(want, tmp_path_factory):
    return _spawn(_worker2, 2, tmp_path_factory, draws=want["draws"], params=want["flat"])


def _assert_sample(res, key, sample, r, world=2):
    levels = [np.asarray(lv).reshape(world, -1) for lv in sample.levels]
    for i, lv in enumerate(levels):
        np.testing.assert_array_equal(res[f"{key}/level/{i}"], lv[r])
    np.testing.assert_array_equal(res[f"{key}/counts"], [int(c) for c in sample.level_counts])
    for h, hop in enumerate(sample.hops):
        for j, name in enumerate(("neigh_local", "neigh_global", "edge_ids")):
            np.testing.assert_array_equal(
                res[f"{key}/hop/{h}/{name}"],
                np.asarray(hop[j]).reshape(world, levels[h].shape[1], -1)[r])


def test_dist_neighbor_loader_matches_jax(got2, want):
    """Shuffled seeds cut per rank, input ids, levels, blocks, features and
    labels (-1 for pads) of three batches: JAX's shard r."""
    for r, res in enumerate(got2):
        for i, b in enumerate(want["nodes"]):
            _assert_sample(res, f"node/{i}", b.sample, r)
            per = len(res[f"node/{i}/seeds"])
            assert per == BATCH // 2 + 1
            np.testing.assert_array_equal(res[f"node/{i}/seeds"],
                                          np.asarray(b.seeds)[r * per:(r + 1) * per])
            np.testing.assert_array_equal(res[f"node/{i}/input_id"],
                                          np.asarray(b.input_id)[r * per:(r + 1) * per])
            np.testing.assert_array_equal(res[f"node/{i}/y"],
                                          np.asarray(b.y).reshape(2, -1)[r])
            xs = np.asarray(b.x).reshape(2, -1, F)[r]
            np.testing.assert_array_equal(res[f"node/{i}/x"], xs)
    # the epoch's third batch holds its 18 pads on rank 1
    assert (got2[1]["node/2/y"] == -1).sum() == 3 * (BATCH + 1) - N


def test_dist_link_neighbor_loader_matches_jax(got2, want):
    """The seed layout [pos_src | pos_dst | neg_src | neg_dst] padded to the
    world, edge_label_index, edge_label, input ids, each rank's sample and
    features: JAX's."""
    for r, res in enumerate(got2):
        for i, b in enumerate(want["links"]):
            _assert_sample(res, f"link/{i}", b.sample, r)
            for name in ("seeds", "edge_label_index", "edge_label", "input_id"):
                np.testing.assert_array_equal(res[f"link/{i}/{name}"],
                                              np.asarray(getattr(b, name)), err_msg=name)
            np.testing.assert_array_equal(res[f"link/{i}/x"],
                                          np.asarray(b.x).reshape(2, -1, F)[r])


def test_train_dist_matches_example(got2, want):
    """Three steps: the global losses and every parameter after them within
    1e-5 of the example's update, on both ranks (every rank applies the same
    update)."""
    for res in got2:
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=0, atol=1e-5)
        for i in range(2):
            p = want["params"][f"conv_{i}"]
            for key, ref in ((f"convs.{i}.lin_self.weight", p["lin_self"]["kernel"].T),
                             (f"convs.{i}.lin_self.bias", p["lin_self"]["bias"]),
                             (f"convs.{i}.lin_neigh.weight", p["lin_neigh"]["kernel"].T)):
                np.testing.assert_allclose(res[f"param/{key}"], ref, rtol=0, atol=1e-5)
    for key in got2[0]:
        if key.startswith("param/"):
            np.testing.assert_array_equal(got2[0][key], got2[1][key])


def _worker4(rank, world, store, out_dir):
    """World 4: an epoch of the global and the rank-local loader (weighted,
    dedup), the bounded gather against the one exchange, the topology, a
    hetero store."""
    from cugraph_gnn_tpu_torch.loader import DistNeighborLoader, auto_mesh
    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import read_rows
    from cugraph_gnn_tpu_torch.store.dist_array import DistArray, _dist_gather_shard
    from cugraph_gnn_tpu_torch.utils import distributed as D

    torch.set_num_threads(1)
    mesh = D.init(init_method=f"file://{store}", rank=rank, world_size=world, device="cpu")
    try:
        res = {}
        kw = dict(batch_size=BATCH, shuffle=True, seed=SEED, weight_attr="w", dedup=True)
        glob = DistNeighborLoader(_port_stores(), FANOUTS, mesh, **kw)
        fs, gs = _port_stores(local=(rank, world))
        assert gs.has_local_edges and gs.num_nodes() == N
        try:
            gs.finalize()
            res["finalize_refused"] = np.array(False)
        except ValueError:
            res["finalize_refused"] = np.array(True)
        local = DistNeighborLoader((fs, gs), FANOUTS, mesh, **kw)
        for name, ld in (("global", glob), ("local", local)):
            for i, b in enumerate(ld):
                _save_sample(res, f"{name}/{i}", b.sample)
                res[f"{name}/{i}/x"], res[f"{name}/{i}/y"] = b.x.numpy(), b.y.numpy()
        # the gather alone: skewed ids (most owned by one rank), -1 pads
        rng = np.random.default_rng(rank)
        ids = torch.as_tensor(np.where(rng.random(50) < 0.2, -1,
                                       rng.integers(0, 30, 50)))
        arr = DistArray.from_array(_data()[2], mesh)
        res["flat"] = arr.gather(ids, fill=-3, recv_cap="flat").numpy()
        res["capped"] = arr.gather(ids, fill=-3, recv_cap=5).numpy()
        res["capped_read"] = _dist_gather_shard(arr.data, ids, book=arr.book, mesh=mesh,
                                                read=read_rows, recv_cap=13).numpy()
        # auto_mesh: the flat mesh on one host, the (node, device) mesh of
        # two hosts; a store of two edge types samples through the hetero
        # sampler
        res["auto_world"] = np.array(auto_mesh("cpu").world)
        os.environ["LOCAL_WORLD_SIZE"] = "2"
        try:
            res["hier_mesh"] = np.array(tuple(auto_mesh("cpu").shape.values()) == (2, 2))
        finally:
            del os.environ["LOCAL_WORLD_SIZE"]
        fs, gs = _port_stores()
        gs.put_edge_index((_data()[1], _data()[0]), ("n", "rev", "n"), num_nodes=(N, N))
        hetero = DistNeighborLoader((fs, gs), FANOUTS, mesh, batch_size=8)
        res["hetero_sampled"] = np.array(
            hetero.hetero and set(next(iter(hetero)).sample.hops[0]) == {"n__e__n", "n__rev__n"})
        np.savez(os.path.join(out_dir, f"out_{rank}.npz"), **res)
    finally:
        D.finalize()


@pytest.fixture(scope="module")
def got4(tmp_path_factory):
    return _spawn(_worker4, 4, tmp_path_factory)


def test_rank_local_mode_equals_global(got4):
    """Every batch of an epoch (weighted, dedup, shuffled) from the
    rank-local edge slices equals the global store's bit for bit;
    ``finalize`` refuses the rank-local store."""
    for res in got4:
        assert res["finalize_refused"]
        assert res["auto_world"] == 4 and res["hier_mesh"] and res["hetero_sampled"]
        keys = [k for k in res if k.startswith("global/")]
        assert len(keys) > 20
        for k in keys:
            np.testing.assert_array_equal(res["local/" + k[7:]], res[k], err_msg=k)


def test_bounded_gather_equals_one_exchange(got4):
    """A forced receive capacity (5 and 13 ids a round) gives the one
    exchange's rows, also through ``read_rows``."""
    x = _data()[2]
    for rank, res in enumerate(got4):
        np.testing.assert_array_equal(res["capped"], res["flat"])
        rng = np.random.default_rng(rank)
        ids = np.where(rng.random(50) < 0.2, -1, rng.integers(0, 30, 50))
        np.testing.assert_array_equal(res["flat"], np.where((ids >= 0)[:, None],
                                                            x[np.maximum(ids, 0)], -3))
        np.testing.assert_array_equal(res["capped_read"], np.where((ids >= 0)[:, None],
                                                                   x[np.maximum(ids, 0)], 0))


@pytest.mark.parametrize("batch,world", [(64, 1), (64, 8), (64, 9), (3, 16), (1000, 12),
                                         (10, 64)])
def test_recv_cap_policy_matches_jax_ragged(batch, world, monkeypatch):
    """``"auto"`` is the JAX package's ragged (TPU) branch: the port's
    exchanges are actual-size; "flat" and ints pass through."""
    from cugraph_gnn_tpu.store import dist_array as jda

    from cugraph_gnn_tpu_torch.store.dist_array import dist_gather_recv_cap

    monkeypatch.setattr(jda, "_use_ragged_a2a", lambda: True)
    for policy in ("auto", "flat", 24):
        assert dist_gather_recv_cap(batch, world, policy) == jda.dist_gather_recv_cap(
            batch, world, policy)
    with pytest.raises(ValueError, match="recv_cap"):
        dist_gather_recv_cap(batch, world, "bounded")
