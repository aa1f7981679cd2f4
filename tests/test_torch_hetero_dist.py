"""Port parity: distributed hetero sampling, the hetero dist loaders and the
hetero dist trainer against the JAX package's.

- ``HeteroDistNeighborSampler`` in spawned gloo worlds of 2 and 4 ranks
  against JAX's on a 2- and 4-device CPU mesh, the JAX draws replayed:
  uniform, a fanout dict (one edge type left out, one skipped at hop 1),
  capped, weighted, temporal, and 64-bit edge ids (forced, with every edge
  type's base moved past 2**31).  Each rank's levels, blocks (local and
  global ids, edge ids and their high plane) and the global level counts
  are exact; ``from_local_coo`` of the ranks' slices equals
  ``from_sampling_graph``.
- At world 2: the typed ``DistNeighborLoader`` (features by node type, the
  paper labels de-offset) and ``DistLinkNeighborLoader`` (a typed
  ``edge_label_index``, the JAX negatives) against JAX's, exactly; the
  rank-local hetero mode (weighted) equal to the global one bit for bit;
  three Adam steps of ``train_hetero_dist``'s ``TypedSAGE`` from the flax
  parameters (``typed_sage_from_flax``) within 1e-5 of the update of
  ``examples/hetero_dist_training.py``.

The JAX draws of hop h, edge type e (its index among the sorted type names)
on owner r are over its receive buffer (``uniform(fold_in(fold_in(fold_in(
key, h), e), r), (W * t, k))``, or the last two key words of ``fold_in(...,
0)`` weighted and ``..., 1)`` time-masked); the port's frame is the rows that
hold real ids.  JAX is imported inside fixtures only: the spawned ranks
import this file and run torch alone.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

N_A, N_P, F, CLASSES = 48, 80, 4, 3
WRITES = ("author", "writes", "paper")
CITES = ("paper", "cites", "paper")
REV = ("paper", "rev_writes", "author")
NAMES = ["author__writes__paper", "paper__cites__paper", "paper__rev_writes__author"]
PER = 10                          # sampler seeds a rank
# the 64-bit case's shift of every edge base: 3 * 2**30 + (2**30 - 700), so
# that edge ids of 700 and more carry into the high plane (3 -> 4)
BIG = 4 * 2**30 - 700
CASES = {
    "uniform": dict(fanouts=[3, 2]),
    "dict": dict(fanouts={WRITES: [2, 0], CITES: [3, 2]}),
    "capped": dict(fanouts=[3, 2], caps=(25, 60)),
    "weighted": dict(fanouts=[3], weights=True),
    "temporal": dict(fanouts=[3, 2], times=True),
    "bits64": dict(fanouts=[2], bits=64),
}
KEY_SEED = 7
BATCH, SEED, STEPS, LR, HIDDEN = 21, 3, 3, 2e-3, 8
LINK_BATCH = 8


def _coo():
    """Each edge type's COO in type-local ids (a hub among the cited
    papers), and per-edge weights and times of 'cites' in CSR order."""
    rng = np.random.default_rng(5)
    ws, wd = rng.integers(0, N_A, 300), rng.integers(0, N_P, 300)
    cs, cd = rng.integers(0, N_P, 500), rng.integers(0, N_P, 500)
    cd[:60] = 4
    w = (rng.random(500) + 0.1).astype(np.float32)
    w[::11] = 0
    t = rng.integers(0, 100, 500).astype(np.int32)
    return {WRITES: (ws, wd), CITES: (cs, cd), REV: (wd, ws)}, w, t


def _fill(gs, fs, coo, local=None):
    """Put the edges (or, with ``local`` = (rank, world), this rank's slice)
    and the features, paper labels and 'cites' weights (COO order)."""
    rng = np.random.default_rng(6)
    x_a = rng.standard_normal((N_A, F)).astype(np.float32)
    x_p = rng.standard_normal((N_P, F)).astype(np.float32)
    y = rng.integers(0, CLASSES, N_P).astype(np.int32)
    w_coo = rng.uniform(0.1, 1.0, 500).astype(np.float32)
    for et, (s, d) in coo.items():
        n = (N_A if et[0] == "author" else N_P, N_A if et[2] == "author" else N_P)
        if local is None:
            gs.put_edge_index((s, d), et, num_nodes=n)
        else:
            mine = np.array_split(np.arange(len(s)), local[1])[local[0]]
            gs.put_local_edge_index((s[mine], d[mine]), et, num_nodes=n)
            if et == CITES:
                w_coo = w_coo[mine]
    fs[("author", "x")], fs[("paper", "x")], fs[("paper", "y")] = x_a, x_p, y
    fs[("paper__cites__paper", "w")] = w_coo
    return x_a, x_p, y


def _seeds(world):
    rng = np.random.default_rng(world)
    seeds = rng.integers(0, N_A + N_P, world * PER).astype(np.int32)
    seeds[::4] = -1
    seeds[1] = N_A + 4                        # the hub paper
    return seeds, rng.integers(30, 100, world * PER).astype(np.int32)


def _moved(graph):
    """``graph`` with every edge type's base moved by BIG (the 64-bit case)."""
    return SimpleNamespace(num_nodes_total=graph.num_nodes_total, etypes=graph.etypes,
                           csr_by_etype={et: (ip, ix, int(b) + BIG) for et, (ip, ix, b)
                                         in graph.csr_by_etype.items()})


def _case_graph(case, graph, mesh, cls):
    """The case's HeteroDistGraph (``cls``, either package's) of ``graph``."""
    spec = CASES[case]
    _, w, t = _coo()
    kw = {}
    if spec.get("weights"):
        kw["weights_by_etype"] = {CITES: w}
    if spec.get("times"):
        kw["times_by_etype"] = {CITES: t}
    if spec.get("bits"):
        graph, kw["edge_id_bits"] = _moved(graph), spec["bits"]
    return cls.from_sampling_graph(graph, mesh, **kw)


def _frames(targets, jbook, world):
    """For each owner r, the rows of JAX's receive buffer (sender-major, each
    sender's targets stably by owner, -1 pads with the last rank) that hold
    real ids: the rows of the port's frame."""
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


def _replay(draws, prefix, batch, sampler, book, key, world, keyed=()):
    """The port's draws of a JAX hetero dist batch: per hop h, edge type e
    and owner r, the uniforms of r's frame, or the key words of a keyed type
    (``keyed``: name -> 0 weighted, 1 time-masked)."""
    import jax

    for h in range(sampler.num_hops):
        targets = np.asarray(batch.levels[h]).reshape(world, -1)
        frames = _frames(targets, book, world)
        for ei, name in enumerate(sampler.enames):
            fan = sampler.fanouts[name]
            if fan is None or fan[h] <= 0:
                continue
            hkey = jax.random.fold_in(jax.random.fold_in(key, h), ei)
            for r in range(world):
                skey = jax.random.fold_in(hkey, r)
                if name in keyed:
                    draws[f"{prefix}/k/{h}/{name}/{r}"] = np.asarray(jax.random.key_data(
                        jax.random.fold_in(skey, keyed[name])))[-2:].astype(np.int64)
                else:
                    u = np.asarray(jax.random.uniform(skey, (targets.size, fan[h])))
                    draws[f"{prefix}/u/{h}/{name}/{r}"] = u[frames[r]]


def _draws_of(draws, prefix, hops, rank):
    """(u, hash_keys) per hop and edge type of this rank from ``draws``."""
    u = [{} for _ in range(hops)]
    keys = [{} for _ in range(hops)]
    for k in draws.files if hasattr(draws, "files") else draws:
        parts = k.split("/")
        if k.startswith(prefix + "/") and len(parts) == len(prefix.split("/")) + 4 \
                and int(parts[-1]) == rank:
            kind, h, name = parts[-4], int(parts[-3]), parts[-2]
            (u if kind == "u" else keys)[h][name] = (torch.as_tensor(draws[k]) if kind == "u"
                                                     else draws[k])
    return u, keys


class _Replay:
    """A hetero dist sampler whose i-th call takes this rank's replayed
    draws of batch i."""

    def __init__(self, inner, draws, prefix, rank):
        self.inner, self.draws, self.prefix, self.rank, self.calls = (inner, draws, prefix,
                                                                      rank, 0)

    def sample(self, seeds, node_times=None, generator=None):
        u, keys = _draws_of(self.draws, f"{self.prefix}/{self.calls}", self.inner.num_hops,
                            self.rank)
        self.calls += 1
        return self.inner.sample(seeds, node_times, u=u, hash_keys=keys)


def _save_sample(res, key, sample):
    for i, lv in enumerate(sample.levels):
        res[f"{key}/level/{i}"] = lv.numpy()
    res[f"{key}/counts"] = torch.stack(sample.level_counts).numpy()
    for h, hop in enumerate(sample.hops):
        for name, blk in hop.items():
            for field in ("neigh_local", "neigh_global", "edge_ids", "edge_hi"):
                if getattr(blk, field) is not None:
                    res[f"{key}/hop/{h}/{name}/{field}"] = getattr(blk, field).numpy()


def _assert_sample(res, key, sample, r, world):
    levels = [np.asarray(lv).reshape(world, -1) for lv in sample.levels]
    for i, lv in enumerate(levels):
        np.testing.assert_array_equal(res[f"{key}/level/{i}"], lv[r], err_msg=f"level {i}")
    np.testing.assert_array_equal(res[f"{key}/counts"], [int(c) for c in sample.level_counts])
    for h, hop in enumerate(sample.hops):
        assert {k.split("/")[-2] for k in res if k.startswith(f"{key}/hop/{h}/")} == set(hop)
        t = levels[h].shape[1]
        for name, blk in hop.items():
            for field in ("neigh_local", "neigh_global", "edge_ids", "edge_hi"):
                jv = getattr(blk, field)
                got = res.get(f"{key}/hop/{h}/{name}/{field}")
                assert (jv is None) == (got is None), (h, name, field)
                if jv is not None:
                    np.testing.assert_array_equal(
                        got, np.asarray(jv).reshape(world, t, -1)[r],
                        err_msg=f"hop {h} {name} {field}")


# -- the ranks ---------------------------------------------------------------------

def _port_stores(local=None):
    from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore

    gs, fs = GraphStore(device="cpu"), FeatureStore(device="cpu")
    _fill(gs, fs, _coo()[0], local)
    return fs, gs


def _sample_cases(res, mesh, draws):
    """Every sampler case on this rank's seeds with the replayed draws, and
    ``from_local_coo`` of this rank's slices against ``from_sampling_graph``."""
    from cugraph_gnn_tpu_torch.sampler.hetero_dist import (
        HeteroDistGraph,
        HeteroDistNeighborSampler,
    )

    rank, world = mesh.rank, mesh.world
    graph = _port_stores()[1].finalize()
    seeds, times = (a[rank * PER:(rank + 1) * PER] for a in _seeds(world))
    for case, spec in CASES.items():
        g = _case_graph(case, graph, mesh, HeteroDistGraph)
        sampler = HeteroDistNeighborSampler(g, spec["fanouts"], max_unique_per_hop=spec.get("caps"))
        u, keys = _draws_of(draws, f"{case}/0", sampler.num_hops, rank)
        b = sampler.sample(torch.as_tensor(seeds),
                           torch.as_tensor(times) if spec.get("times") else None,
                           u=u, hash_keys=keys)
        _save_sample(res, case, b)
    coo, w, t = _coo()
    offs = {"author": 0, "paper": N_A}
    edges, wl, tl = {}, {}, {}
    order = np.argsort(coo[CITES][1], kind="stable")      # CSR position -> COO position
    w_coo, t_coo = np.empty_like(w), np.empty_like(t)
    w_coo[order], t_coo[order] = w, t
    for et, (s, d) in coo.items():
        mine = np.array_split(np.arange(len(s)), world)[rank]
        edges[et] = (s[mine] + offs[et[0]], d[mine] + offs[et[2]])
        if et == CITES:
            wl[et], tl[et] = w_coo[mine], t_coo[mine]
    for bits in (None, 64):
        local = HeteroDistGraph.from_local_coo(edges, N_A + N_P, mesh, weights_by_etype=wl,
                                               times_by_etype=tl, edge_id_bits=bits, chunk=37)
        glob = HeteroDistGraph.from_sampling_graph(graph, mesh, weights_by_etype={CITES: w},
                                                   times_by_etype={CITES: t},
                                                   edge_id_bits=bits)
        for tag, g in (("local", local), ("global", glob)):
            res[f"{tag}{bits}/bits"] = np.array(g.edge_id_bits)
            res[f"{tag}{bits}/bases"] = np.array([g.edge_base_by_etype[n] for n in NAMES])
            for n in NAMES:
                dg = g.graphs[n]
                res[f"{tag}{bits}/{n}/book"] = dg.book.offsets
                res[f"{tag}{bits}/{n}/edge_base"] = dg.edge_base
                res[f"{tag}{bits}/{n}/max_degree"] = np.array(dg.max_degree)
                for field in ("indptr", "indices", "weights", "times"):
                    if getattr(dg, field) is not None:
                        res[f"{tag}{bits}/{n}/{field}"] = getattr(dg, field).numpy()


def _loaders(res, mesh, draws, params):
    """World 2: the typed node loader and three TypedSAGE steps, the typed
    link loader, the rank-local mode against the global one."""
    from cugraph_gnn_tpu_torch.loader import DistLinkNeighborLoader, DistNeighborLoader
    from cugraph_gnn_tpu_torch.models.convert import typed_sage_from_flax
    from cugraph_gnn_tpu_torch.train_dist import dist_train_step

    rank = mesh.rank
    data = _port_stores()
    kw = dict(input_nodes=("paper", np.arange(N_P)), batch_size=BATCH, shuffle=True, seed=SEED)
    loader = DistNeighborLoader(data, [3, 2], mesh, **kw)
    loader.sampler = _Replay(loader.sampler, draws, "node", rank)
    ranges = {"author": (0, N_A), "paper": (N_A, N_P)}
    model = typed_sage_from_flax(params, ranges, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    losses = []
    for i, b in zip(range(STEPS), loader):
        _save_sample(res, f"node/{i}", b.sample)
        for nt, xv in b.x.items():
            res[f"node/{i}/x/{nt}"] = xv.numpy()
        for name in ("seeds", "input_id", "y"):
            res[f"node/{i}/{name}"] = getattr(b, name).numpy()
        losses.append(float(dist_train_step(model, opt, b, mesh)))
    res["losses"] = np.array(losses)
    for key, p in model.state_dict().items():
        res[f"param/{key}"] = p.numpy()

    eli = np.stack(_coo()[0][WRITES])[:, :40]
    link = DistLinkNeighborLoader(data, [3, 2], mesh, edge_label_index=(WRITES, eli),
                                  neg_sampling="binary", batch_size=LINK_BATCH, shuffle=True,
                                  seed=SEED)
    link.sampler = _Replay(link.sampler, draws, "link", rank)
    calls = iter(range(10))

    def negatives(ps, n):              # JAX's negatives of the batch, type-local
        i = next(calls)
        return tuple(torch.as_tensor(draws[f"link/neg/{i}/{k}"]) for k in ("src", "dst"))

    link._negatives = negatives
    for i, b in zip(range(2), link):
        _save_sample(res, f"link/{i}", b.sample)
        for nt, xv in b.x.items():
            res[f"link/{i}/x/{nt}"] = xv.numpy()
        for name in ("seeds", "edge_label_index", "edge_label", "input_id"):
            res[f"link/{i}/{name}"] = getattr(b, name).numpy()

    # the rank-local mode (weighted 'cites') against the global one, an epoch
    kw = dict(input_nodes=("paper", np.arange(N_P)), batch_size=BATCH, shuffle=True, seed=SEED,
              weight_attr="w")
    pair = [DistNeighborLoader(_port_stores(), [3, 2], mesh, **kw),
            DistNeighborLoader(_port_stores(local=(rank, mesh.world)), [3, 2], mesh, **kw)]
    for tag, ld in zip(("global", "local"), pair):
        for i, b in enumerate(ld):
            _save_sample(res, f"{tag}/{i}", b.sample)
            for nt, xv in b.x.items():
                res[f"{tag}/{i}/x/{nt}"] = xv.numpy()
            res[f"{tag}/{i}/y"] = b.y.numpy()


def _worker(rank, world, store, out_dir):
    from cugraph_gnn_tpu_torch.utils import distributed as D

    torch.set_num_threads(1)         # the ranks share the CPU cores
    mesh = D.init(init_method=f"file://{store}", rank=rank, world_size=world, device="cpu")
    try:
        draws = np.load(os.path.join(out_dir, "draws.npz"))
        res = {}
        _sample_cases(res, mesh, draws)
        if world == 2:
            params = np.load(os.path.join(out_dir, "params.npz"))
            _loaders(res, mesh, draws, {"params": _nest(dict(params))})
        np.savez(os.path.join(out_dir, f"out_{rank}.npz"), **res)
    finally:
        D.finalize()


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


# -- the JAX references -------------------------------------------------------------

def _jax_stores():
    from cugraph_gnn_tpu.data import FeatureStore, GraphStore

    gs, fs = GraphStore(), FeatureStore()
    _fill(gs, fs, _coo()[0])
    return fs, gs


def _jax_sampler_cases(world, draws):
    import jax
    import jax.numpy as jnp

    from cugraph_gnn_tpu.parallel.mesh import create_store_mesh
    from cugraph_gnn_tpu.sampler.hetero_dist import HeteroDistGraph, HeteroDistNeighborSampler

    mesh = create_store_mesh(world)
    graph = _jax_stores()[1].finalize()
    seeds, times = _seeds(world)
    key = jax.random.PRNGKey(KEY_SEED)
    out = {}
    for case, spec in CASES.items():
        g = _case_graph(case, graph, mesh, HeteroDistGraph)
        sampler = HeteroDistNeighborSampler(g, spec["fanouts"],
                                            max_unique_per_hop=spec.get("caps"))
        # jitted: the sampler's shard_map runs op by op otherwise
        b = jax.jit(sampler.sample)(key, jnp.asarray(seeds),
                                    jnp.asarray(times) if spec.get("times") else None)
        keyed = {}
        if spec.get("weights"):
            keyed["paper__cites__paper"] = 0
        if spec.get("times"):
            keyed["paper__cites__paper"] = 1
        _replay(draws, f"{case}/0", b, sampler, g.book, key, world, keyed)
        out[case] = b
    return out


class _JaxTypedSAGE:
    """The example's flax ``TypedSAGE`` (local to its ``main()``), restated."""

    @staticmethod
    def make(ranges, hidden, classes):
        import flax.linen as nn
        import jax.numpy as jnp

        class TypedSAGE(nn.Module):
            @nn.compact
            def __call__(self, x_by_type, sample):
                inp = sample.levels[-1]
                h = jnp.zeros((inp.shape[0], hidden), jnp.float32)
                for nt, xv in x_by_type.items():
                    proj = nn.Dense(hidden, name=f"in_{nt}")(xv)
                    off, n = ranges[nt]
                    is_t = (inp >= off) & (inp < off + n)
                    h = jnp.where(is_t[:, None], proj, h)
                h = nn.relu(h)
                agg = sample.dst_activations(h, 0)
                for ename, hop in sample.hops[0].items():
                    k = hop.neigh_local.shape[1]
                    neigh = sample.gather_neighbors(h, 0, ename)
                    m = hop.mask[..., None]
                    agg = agg + jnp.sum(jnp.where(m, neigh, 0), axis=1) / k
                return nn.Dense(classes, name="out")(nn.relu(agg))

        return TypedSAGE()


def _jax_loaders(draws):
    """World 2: JAX's typed node batches, the example's three updates from
    its flax init, JAX's typed link batches; the port's replayed draws and
    the negatives."""
    import jax
    import jax.numpy as jnp
    import optax

    from cugraph_gnn_tpu.loader import DistLinkNeighborLoader, DistNeighborLoader
    from cugraph_gnn_tpu.parallel.mesh import create_store_mesh

    world = 2
    mesh = create_store_mesh(world)
    data = _jax_stores()
    node = DistNeighborLoader(data, [3, 2], mesh=mesh, input_nodes=("paper", np.arange(N_P)),
                              batch_size=BATCH, shuffle=True, seed=SEED)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    nodes = [b for _, b in zip(range(STEPS), node)]
    for i, b in enumerate(nodes):
        _replay(draws, f"node/{i}", b.sample, node.sampler, node.dist_graph.book,
                jax.random.fold_in(key, i), world)

    model = _JaxTypedSAGE.make({"author": (0, N_A), "paper": (N_A, N_P)}, HIDDEN, CLASSES)
    params = model.init(jax.random.PRNGKey(0), nodes[0].x, nodes[0].sample)
    flat = _flat(jax.tree_util.tree_map(np.asarray, params)["params"])
    tx = optax.adam(LR)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, x, sample, y, seeds):       # the example's step
        def loss_fn(p):
            logits = model.apply(p, x, sample)
            ok = seeds >= 0
            ls = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.clip(y, 0))
            return jnp.sum(jnp.where(ok, ls, 0)) / jnp.maximum(jnp.sum(ok), 1)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(grads, opt)
        return optax.apply_updates(params, upd), opt, loss

    losses = []
    for b in nodes:
        params, opt, loss = step(params, opt, b.x, b.sample, b.y, b.seeds)
        losses.append(float(loss))

    eli = np.stack(_coo()[0][WRITES])[:, :40]
    link = DistLinkNeighborLoader(data, [3, 2], mesh=mesh, edge_label_index=(WRITES, eli),
                                  neg_sampling="binary", batch_size=LINK_BATCH, shuffle=True,
                                  seed=SEED)
    links = [b for _, b in zip(range(2), link)]
    b2, n_neg = LINK_BATCH, link.num_neg
    for i, b in enumerate(links):
        seeds = np.asarray(b.seeds)
        for part, lo, off in (("src", 2 * b2, link.src_offset),
                              ("dst", 2 * b2 + n_neg, link.dst_offset)):
            s = seeds[lo:lo + n_neg]
            draws[f"link/neg/{i}/{part}"] = np.where(s >= 0, s - off, -1).astype(np.int32)
        _replay(draws, f"link/{i}", b.sample, link._nl.sampler, link._nl.dist_graph.book,
                jax.random.fold_in(jax.random.fold_in(key, i), 2), world)
    return dict(nodes=nodes, links=links, losses=losses, flat=flat,
                params=jax.tree_util.tree_map(np.asarray, params)["params"])


@pytest.fixture(scope="module")
def want():
    """By world: JAX's sampler batches of every case, the port's draws; at
    world 2 also JAX's loader batches and the example's updates."""
    out = {}
    for world in (2, 4):
        draws = {}
        cases = _jax_sampler_cases(world, draws)
        loaders = _jax_loaders(draws) if world == 2 else None
        out[world] = (cases, loaders, draws)
    return out


@pytest.fixture(scope="module")
def spawned(want, tmp_path_factory):
    """A function giving every rank's results at a gloo world of 2 or 4,
    spawned once a world."""
    cache = {}

    def run(world):
        if world not in cache:
            _, loaders, draws = want[world]
            out_dir = tmp_path_factory.mktemp(f"hetero_dist_world{world}")
            np.savez(out_dir / "draws.npz", **draws)
            if loaders is not None:
                np.savez(out_dir / "params.npz", **loaders["flat"])
            mp.spawn(_worker, args=(world, str(out_dir / "store"), str(out_dir)),
                     nprocs=world, join=True)
            cache[world] = [dict(np.load(out_dir / f"out_{r}.npz")) for r in range(world)]
        return cache[world], world

    return run


@pytest.fixture(params=[2, 4], ids=lambda w: f"world{w}")
def got(request, spawned):
    return spawned(request.param)


@pytest.fixture
def got2(spawned):
    """The world-2 ranks' results (the loaders run there)."""
    return spawned(2)[0]


@pytest.mark.parametrize("case", list(CASES))
def test_hetero_dist_sampler_matches_jax(got, want, case):
    """Each rank's levels and per-type blocks are JAX's shard r exactly, the
    level counts JAX's global ones; the 64-bit case carries JAX's high
    plane past 2**31."""
    ranks, world = got
    b = want[world][0][case]
    for r, res in enumerate(ranks):
        _assert_sample(res, case, b, r, world)
    last = len(b.hops) - 1
    assert any((res[f"{case}/hop/{last}/paper__cites__paper/neigh_global"] >= 0).any()
               for res in ranks)
    if case == "bits64":
        hi = np.concatenate([v.ravel() for res in ranks for k, v in res.items()
                             if k.startswith("bits64/") and k.endswith("/edge_hi")])
        assert set(np.unique(hi)) == {-1, 3, 4}
    if case == "dict":
        assert all("dict/hop/1/author__writes__paper/edge_ids" not in res for res in ranks)


def test_hetero_from_local_coo_equals_global(got):
    """Each edge type's shard from the ranks' slices (routed in rounds of 37
    edges) equals the one cut from the store's CSR, bases and width
    included, at 32 and forced 64 bits."""
    ranks, _ = got
    for res in ranks:
        keys = [k for k in res if k.startswith("global")]
        assert len(keys) > 20
        for k in keys:
            a, b = res[k], res["local" + k[6:]]
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        assert res["globalNone/bits"] == 32 and res["global64/bits"] == 64


def test_hetero_dist_loader_matches_jax(got2, want):
    """Three typed batches: seeds, input ids, levels, blocks, the features
    of each node type and the de-offset paper labels are JAX's shard r."""
    ranks = got2
    for r, res in enumerate(ranks):
        for i, b in enumerate(want[2][1]["nodes"]):
            _assert_sample(res, f"node/{i}", b.sample, r, 2)
            per = len(res[f"node/{i}/seeds"])
            assert per == (BATCH + 1) // 2
            for name in ("seeds", "input_id"):
                np.testing.assert_array_equal(res[f"node/{i}/{name}"],
                                              np.asarray(getattr(b, name))[r * per:(r + 1) * per])
            np.testing.assert_array_equal(res[f"node/{i}/y"], np.asarray(b.y).reshape(2, -1)[r])
            assert set(b.x) == {"author", "paper"}
            for nt, xv in b.x.items():
                np.testing.assert_array_equal(res[f"node/{i}/x/{nt}"],
                                              np.asarray(xv).reshape(2, -1, F)[r])


def test_hetero_dist_link_loader_matches_jax(got2, want):
    """A typed edge_label_index: the seed layout with the source and
    destination offsets, edge_label_index, edge_label, input ids, each
    rank's sample and feature dict are JAX's."""
    ranks = got2
    for r, res in enumerate(ranks):
        for i, b in enumerate(want[2][1]["links"]):
            _assert_sample(res, f"link/{i}", b.sample, r, 2)
            for name in ("seeds", "edge_label_index", "edge_label", "input_id"):
                np.testing.assert_array_equal(res[f"link/{i}/{name}"],
                                              np.asarray(getattr(b, name)), err_msg=name)
            for nt, xv in b.x.items():
                np.testing.assert_array_equal(res[f"link/{i}/x/{nt}"],
                                              np.asarray(xv).reshape(2, -1, F)[r])


def test_hetero_rank_local_mode_equals_global(got2):
    """An epoch of weighted typed batches from the ranks' edge slices equals
    the global store's bit for bit."""
    ranks = got2
    for res in ranks:
        keys = [k for k in res if k.startswith("global/")]
        assert len(keys) > 30
        for k in keys:
            np.testing.assert_array_equal(res["local/" + k[7:]], res[k], err_msg=k)


def test_typed_sage_steps_match_example(got2, want):
    """Three Adam steps of ``dist_train_step`` on ``TypedSAGE`` from the converted
    flax parameters: the global losses and every parameter within 1e-5 of
    the example's update, on both ranks."""
    ranks = got2
    ref = want[2][1]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=0, atol=1e-5)
        for nt in ("author", "paper"):
            p = ref["params"][f"in_{nt}"]
            np.testing.assert_allclose(res[f"param/inputs.{nt}.weight"], p["kernel"].T,
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(res[f"param/inputs.{nt}.bias"], p["bias"], rtol=0,
                                       atol=1e-5)
        np.testing.assert_allclose(res["param/out.weight"], ref["params"]["out"]["kernel"].T,
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ranks[0]["param/out.weight"], ranks[1]["param/out.weight"])
