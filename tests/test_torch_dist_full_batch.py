"""Port parity: the row-sharded full-batch graph (``DistFullBatchGraph``) at
gloo worlds of 2 and 4 ranks against the JAX package's ``DistFullBatchGraph``
on a 4-device sub-mesh of the CPU mesh (its Pallas kernels in interpret mode,
jitted): ``spmm`` forward and gradient (sum and mean, weighted, and a hub
graph whose fallback edges take the balanced regime at 4 ranks), the
attention forward and gradients (H = 1 and H = 3, with bit planes at R = 128
and with ``t_ell`` at R = 512, and the port's head groups), the RCM order, and three
chained GCN and GAT training steps against the optax steps.  The SpMM's
bucketed fallback plan (each rank's table of halo and remote rows) is held
by a numpy test of its plan at worlds 1, 2 and 4, and its plain version
(``slab_spmm_shard_ref``, which the gloo worlds run) against the JAX
``spmm`` on each rank's table as the exchanges built it.  The attention's
two tables (A by destination, B by source) are held by a numpy test of
their plans at worlds 1, 2 and 4, and the shard attention's plain
versions, forward and backward, on each rank's tables against the whole
graph's plain versions.

Each world is spawned once (a module fixture) and runs every case; each rank
computes its rows and rank 0 saves the gathered results.  Each JAX reference
is computed once, in a module fixture.  The JAX package is imported inside
the fixtures, not at the top: the spawned workers import this file and run
torch alone.

Tolerances: forward outputs within 1e-5 (float32 sums of a few dozen terms
in another order), gradients within 1e-4 (the attention's through exp and a
division), training losses and parameters after each step within 1e-5.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cugraph_gnn_tpu_torch import train_full as TF

N, F, H, FH = 600, 16, 3, 8
R_BITS, R_TELL = 128, 512
JAX_WORLD = 4
CLASSES = 4
STEPS = 3
SPMM_CASES = ("sum", "mean", "weighted", "hub")
ATTN_CASES = ("h1_bits", "h1_tell", "mh_bits", "mh_tell", "mh_groups")


def _graphs():
    """COO edges src -> dst, the same in the test process and the workers:
    'a', 600 nodes with 5 sources each, within +-60 or (a quarter) anywhere;
    'w', weights for 'a'; 'hub', a banded graph plus 300 far edges that all
    end on node 5, so that one rank holds every fallback destination."""
    rng = np.random.default_rng(7)
    rows = np.repeat(np.arange(N), 5)
    src = np.clip(rows + rng.integers(-60, 61, len(rows)), 0, N - 1)
    far = rng.random(len(rows)) < 0.25
    src[far] = rng.integers(0, N, int(far.sum()))
    w = rng.uniform(0.1, 2.0, len(rows)).astype(np.float32)
    rows_h = np.repeat(np.arange(N), 4)
    src_h = np.clip(rows_h + rng.integers(-20, 21, len(rows_h)), 0, N - 1)
    hub_src = np.concatenate([src_h, rng.integers(N // 2, N, 300)])
    hub_dst = np.concatenate([rows_h, np.full(300, 5)])
    return {"a": (src.astype(np.int32), rows.astype(np.int32)), "w": w,
            "hub": (hub_src.astype(np.int32), hub_dst.astype(np.int32))}


def _inputs():
    rng = np.random.default_rng(8)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"x": normal(N, F), "gy": normal(N, F), "x3": normal(N, H, FH),
            "ad3": normal(N, H), "as3": normal(N, H), "g3": normal(N, H, FH),
            "feat": normal(N, F), "labels": (np.arange(N) * CLASSES // N).astype(np.int64)}


def _graph_kw(case):
    r = R_TELL if case.endswith("tell") else R_BITS
    return dict(reorder="none", block_rows=r)


def _attn_args(case, inp):
    if case.startswith("h1"):
        return inp["x3"][:, 0], inp["ad3"][:, 0], inp["as3"][:, 0], inp["g3"][:, 0]
    return inp["x3"], inp["ad3"], inp["as3"], inp["g3"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def _worker(rank, world, store, out_dir):
    """One rank of a gloo world: every case on this rank's rows; rank 0
    saves the gathered results to ``out_dir/out.npz``."""
    from cugraph_gnn_tpu_torch.models.convert import gat_from_flax, gcn_from_flax
    from cugraph_gnn_tpu_torch.ops import dist_full_batch as DF
    from cugraph_gnn_tpu_torch.ops.dist_full_batch import DistFullBatchGraph
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_kernel as AK
    from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
        slab_spmm_band_shard,
        slab_spmm_shard,
        slab_spmm_shard_ref,
    )
    from cugraph_gnn_tpu_torch.utils import distributed as D

    torch.set_num_threads(1)     # the ranks share the CPU cores
    mesh = D.init(init_method=f"file://{store}", rank=rank, world_size=world, device="cpu")
    try:
        gr, inp = _graphs(), _inputs()
        res = {}
        graphs = {}

        def graph(key, r_blk, weights=None):
            if (key, r_blk, weights is None) not in graphs:
                graphs[key, r_blk, weights is None] = DistFullBatchGraph.from_coo(
                    *gr[key], N, mesh, weights=weights, reorder="none", block_rows=r_blk)
            return graphs[key, r_blk, weights is None]

        for case in SPMM_CASES:
            g = graph("hub" if case == "hub" else "a", R_BITS,
                      gr["w"] if case == "weighted" else None)
            xs = g.shard(inp["x"]).requires_grad_()
            y = g.spmm(xs, reduce="mean" if case in ("mean", "hub") else "sum")
            (y * g.shard(inp["gy"])).sum().backward()
            res[f"spmm_{case}"] = g.unshard(y.detach()).numpy()
            res[f"spmm_{case}_grad"] = g.unshard(xs.grad).numpy()
            res[f"spmm_{case}_balanced"] = np.array([g._spmm[False].balanced,
                                                     g._spmm[True].balanced])
        g = graph("a", R_BITS)
        xs = g.shard(inp["x"])
        res["spmm_with_arrays"] = g.unshard(
            g.spmm_with_arrays(xs, *g.spmm_arrays())).numpy()
        # the bucketed plan's plain version on this rank's table, as the
        # halo exchange and the planned gather of remote rows build it
        st = g._spmm[False]
        prev, nxt = DF._halo_pair(xs, R_BITS, mesh)
        tail = DF._dist_gather_planned(xs, st.route, mesh=mesh)
        res["spmm_table_ref_mean"] = g.unshard(slab_spmm_shard_ref(
            st.band, xs, prev, nxt, tail, "mean", torch.float32)).numpy()
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
        dist.all_gather(sizes, torch.tensor([tail.shape[0]]), group=mesh.group)
        res["spmm_table_tail_rows"] = torch.cat(sizes).numpy()

        for case in ATTN_CASES:
            g = graph("a", _graph_kw(case)["block_rows"])
            x, ad, as_, gy = _attn_args(case, inp)
            ins = [g.shard(v).requires_grad_() for v in (x, ad, as_)]
            keep = AG.MAX_PACKED_HEADS
            AG.MAX_PACKED_HEADS = 2 if case == "mh_groups" else keep
            try:
                fn = g.attention_spmm if case.startswith("h1") else g.attention_spmm_mh
                y = fn(*ins)
                (y * g.shard(gy)).sum().backward()
            finally:
                AG.MAX_PACKED_HEADS = keep
            res[f"attn_{case}"] = g.unshard(y.detach()).numpy()
            for name, t in zip(("dx", "dad", "das"), ins):
                res[f"attn_{case}_{name}"] = g.unshard(t.grad).numpy()

        g = DistFullBatchGraph.from_coo(*gr["a"], N, mesh, reorder="rcm",
                                        block_rows=R_BITS)
        res["rcm_order"], res["rcm_band_fraction"] = g.order, np.array(g.band_fraction)

        params = dict(np.load(os.path.join(out_dir, "params.npz")))
        for name, conv, r_blk in (("gcn", gcn_from_flax, R_BITS),
                                  ("gat", gat_from_flax, R_BITS)):
            g = graph("a", r_blk)
            model = conv(_nest(params, f"{name}/"), device="cpu")
            opt = torch.optim.Adam(model.parameters(), lr=TF.LR)
            x = g.shard(inp["feat"])
            labels = g.shard(inp["labels"])
            valid = g.shard(np.ones(N, np.float32))
            res[f"{name}_losses"] = np.array([
                float(TF.dist_full_batch_step(model, opt, x, g, labels, valid))
                for _ in range(STEPS)])
            for key, p in model.state_dict().items():
                res[f"{name}_param/{key}"] = p.numpy()
        counters = (slab_spmm_band_shard, slab_spmm_shard, AK.slab_attention_spmm_shard,
                    AK.slab_attention_spmm_mh_shard, AG.onepass_bwd_shard,
                    AG.slab_attention_bwd_shard, AG.slab_attention_bwd_mh_shard)
        res["launches"] = np.array([fn.launches for fn in counters])
        if rank == 0:
            np.savez(os.path.join(out_dir, "out.npz"), **res)
    finally:
        D.finalize()


@pytest.fixture(scope="module")
def want():
    """The JAX package's results for every case, and the flax parameters
    the training cases start from."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from cugraph_gnn_tpu.models import GAT as JaxGAT
    from cugraph_gnn_tpu.models import GCN as JaxGCN
    from cugraph_gnn_tpu.ops.dist_full_batch import DistFullBatchGraph
    from cugraph_gnn_tpu.parallel import STORE_AXIS

    mesh = Mesh(np.array(jax.devices()[:JAX_WORLD]), (STORE_AXIS,))
    gr, inp = _graphs(), _inputs()
    out = {}

    def graph(key, r_blk, weights=None):
        return DistFullBatchGraph.from_coo(*gr[key], N, mesh, weights=weights,
                                           reorder="none", block_rows=r_blk)

    for case in SPMM_CASES:
        g = graph("hub" if case == "hub" else "a", R_BITS,
                  gr["w"] if case == "weighted" else None)
        reduce = "mean" if case in ("mean", "hub") else "sum"
        gs = g.shard(inp["gy"])

        def run(z, g=g, reduce=reduce, gs=gs):
            y, vjp = jax.vjp(lambda q: g.spmm(q, reduce=reduce), z)
            return y, vjp(gs)[0]

        y, gx = jax.jit(run)(g.shard(inp["x"]))
        out[f"spmm_{case}"], out[f"spmm_{case}_grad"] = g.unshard(y), g.unshard(gx)
        out[f"spmm_{case}_balanced"] = np.array([g._fb_balanced, g._fb_balanced_t])

    graphs = {r: graph("a", r) for r in (R_BITS, R_TELL)}
    for case in ATTN_CASES[:-1]:
        g = graphs[_graph_kw(case)["block_rows"]]
        x, ad, as_, gy = (g.shard(v) for v in _attn_args(case, inp))
        fn = g.attention_spmm if case.startswith("h1") else g.attention_spmm_mh

        def run(*z, fn=fn, gy=gy):
            y, vjp = jax.vjp(fn, *z)
            return (y,) + vjp(gy)

        for name, v in zip(("", "_dx", "_dad", "_das"), jax.jit(run)(x, ad, as_)):
            out[f"attn_{case}{name}"] = g.unshard(v)
    # head groups compute the function of one group: the reference of the
    # port's groups of 2 over 3 heads is JAX's 3 heads at once
    for name in ("", "_dx", "_dad", "_das"):
        out[f"attn_mh_groups{name}"] = out[f"attn_mh_bits{name}"]

    g = DistFullBatchGraph.from_coo(*gr["a"], N, mesh, reorder="rcm", block_rows=R_BITS)
    out["rcm_order"], out["rcm_band_fraction"] = g.order, np.array(g.band_fraction)

    params = {}
    g = graphs[R_BITS]
    x = g.shard(inp["feat"])
    y_pad = np.zeros(g._n_pad, np.int32)
    y_pad[:N] = inp["labels"]
    ys = g.shard(y_pad)
    valid = g.shard((np.arange(g._n_pad) < N).astype(np.float32))
    for name, model, conv in (("gcn", JaxGCN(hidden_features=16, out_features=CLASSES,
                                              num_layers=2), JaxGCN),
                              ("gat", JaxGAT(hidden_features=8, out_features=CLASSES,
                                             num_layers=2, heads=2), JaxGAT)):
        p = jax.jit(lambda z, m=model, c=conv: m.init(jax.random.PRNGKey(0), z, g,
                                                      method=c.full_graph))(x)
        params.update(_flat(jax.tree_util.tree_map(np.asarray, p), f"{name}/"))
        tx = optax.adam(TF.LR)

        def step(state, _, m=model, c=conv, tx=tx):
            def loss_fn(q):
                logits = m.apply(q, x, g, method=c.full_graph)
                ls = optax.softmax_cross_entropy_with_integer_labels(logits, ys)
                return jnp.sum(ls * valid) / jnp.sum(valid)
            p, opt = state
            loss, grads = jax.value_and_grad(loss_fn)(p)
            upd, opt = tx.update(grads, opt)
            return (optax.apply_updates(p, upd), opt), loss

        # the chained steps in one program (one compile of the step)
        (p, _), losses = jax.jit(lambda p, opt, step=step: jax.lax.scan(
            step, (p, opt), None, length=STEPS))(p, tx.init(p))
        out[f"{name}_losses"] = np.asarray(losses)
        out[f"{name}_params"] = jax.tree_util.tree_map(np.asarray, p)["params"]
    out["params"] = params
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def got(request, want, tmp_path_factory):
    """The port's results at a gloo world of 2 or 4 ranks: (results, world)."""
    world = request.param
    out_dir = tmp_path_factory.mktemp(f"world{world}")
    np.savez(out_dir / "params.npz", **want["params"])
    mp.spawn(_worker, args=(world, str(out_dir / "store"), str(out_dir)), nprocs=world,
             join=True)
    return dict(np.load(out_dir / "out.npz")), world


@pytest.mark.parametrize("case", SPMM_CASES)
def test_spmm_matches_jax(got, want, case):
    """Forward within 1e-5, gradient (transposed graph) within 1e-5; the
    hub graph takes the balanced fallback regime at 4 ranks (both
    orientations), as JAX's at 4 devices."""
    res, world = got
    np.testing.assert_allclose(res[f"spmm_{case}"], want[f"spmm_{case}"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(res[f"spmm_{case}_grad"], want[f"spmm_{case}_grad"],
                               rtol=1e-5, atol=1e-5)
    balanced = res[f"spmm_{case}_balanced"]
    assert list(balanced) == ([case == "hub"] * 2 if world == 4 else [False, False])
    np.testing.assert_array_equal(want[f"spmm_{case}_balanced"], [case == "hub"] * 2)


def test_spmm_with_arrays_is_the_sum(got):
    res, _ = got
    np.testing.assert_allclose(res["spmm_with_arrays"], res["spmm_sum"], rtol=0, atol=0)


def test_shard_table_plain_matches_jax(got, want):
    """The bucketed plan's plain version (``slab_spmm_shard_ref``) on each
    rank's table (halos by the halo exchange, remote rows by one planned
    all-to-all) within 1e-5 of the JAX sharded 'mean' SpMM; every rank but
    one reads remote rows."""
    res, world = got
    np.testing.assert_allclose(res["spmm_table_ref_mean"], want["spmm_mean"], rtol=1e-5,
                               atol=1e-5)
    assert len(res["spmm_table_tail_rows"]) == world
    assert (res["spmm_table_tail_rows"] > 0).sum() >= world - 1


@pytest.mark.parametrize("world", [1, 2, 4])
def test_plan_fallback_table(world):
    """The host plan of each rank's bucketed fallback edges, no process
    group: every slot reads, through the table, the global row that
    ``_dist_gather_shard`` would fetch for it (halo-extended rows in place,
    remote rows from the tail), each remote row is in the tail once (none at
    world 1), the slots of a row keep their bucketed order; the plan's
    plain SpMM on a table built from the whole x equals the one-card
    ``slab_spmm_ref`` on the rank's rows (sum and mean, weighted)."""
    from cugraph_gnn_tpu_torch.ops import dist_full_batch as DF
    from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
        build_slab_graph,
        slab_spmm_ref,
        slab_spmm_shard_ref,
    )
    from cugraph_gnn_tpu_torch import _native

    gr = _graphs()
    indptr, indices, perm = _native.build_csr(gr["a"][1], gr["a"][0], N)
    slab = build_slab_graph(indptr, indices, gr["w"][perm], block_rows=R_BITS, device="cpu")
    nb = -(-slab.n_blocks // world) * world
    rs, n_pad = nb // world * R_BITS, nb * R_BITS
    fb_s, fb_d, fb_w = DF._bucket_fallback(slab.fb_src.numpy(), slab.fb_dst.numpy(), rs, world,
                                           fb_w=slab.fb_w.numpy())
    cap = len(fb_s) // world
    x = torch.as_tensor(_inputs()["x"])
    x_pad = torch.cat([x, x.new_zeros((n_pad - N, F))])
    for w in range(world):
        mine = slice(w * cap, (w + 1) * cap)
        ok = fb_s[mine] >= 0
        src, dst, wt = fb_s[mine][ok], fb_d[mine][ok], fb_w[mine][ok]
        t = DF.plan_fallback_table(src, dst, wt, rank=w, rows_per_rank=rs, block_rows=R_BITS)
        order = np.argsort(dst, kind="stable")
        np.testing.assert_array_equal(t.dst, dst[order])
        np.testing.assert_array_equal(t.weights, wt[order])
        np.testing.assert_array_equal(t.rowptr, np.searchsorted(dst[order], np.arange(rs + 1)))
        ext = rs + 2 * R_BITS
        assert (t.x_ids >= 0).all() and (t.x_ids < ext + len(t.tail)).all()
        remote = np.append(t.tail, -1)[np.where(t.x_ids < ext, len(t.tail), t.x_ids - ext)]
        read = np.where(t.x_ids < ext, t.x_ids.astype(np.int64) + w * rs - R_BITS, remote)
        np.testing.assert_array_equal(read, src[order])
        assert (np.diff(t.tail) > 0).all()
        assert not ((t.tail >= w * rs - R_BITS) & (t.tail < (w + 1) * rs + R_BITS)).any()
        assert set(t.tail) == set(src[(src < w * rs - R_BITS) | (src >= (w + 1) * rs + R_BITS)])
        if world == 1:
            assert len(t.tail) == 0
        graph, tail = DF.shard_table_graph(slab, w, rs, n_pad, world, "cpu")
        np.testing.assert_array_equal(tail, t.tail)
        parts = [DF.halo_rows(x_pad, w, rs, R_BITS)[:R_BITS], x_pad[w * rs:(w + 1) * rs],
                 DF.halo_rows(x_pad, w, rs, R_BITS)[-R_BITS:], x_pad[torch.as_tensor(tail)]]
        for reduce in ("sum", "mean"):
            got = slab_spmm_shard_ref(graph, parts[1], parts[0], parts[2], parts[3], reduce,
                                      torch.float32)
            whole = slab_spmm_ref(slab, x, reduce, torch.float32)
            hi = min((w + 1) * rs, N)
            if hi > w * rs:
                torch.testing.assert_close(got[:hi - w * rs], whole[w * rs:hi], rtol=1e-5,
                                           atol=1e-5)
            assert not got[max(hi - w * rs, 0):].any()


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_matches_jax(got, want, case):
    """Forward within 1e-5 and dx, dalpha_dst, dalpha_src within 1e-4 of
    the JAX sharded attention (H = 1 and 3; bit planes at R = 128, t_ell at
    R = 512; 'mh_groups': the port's head groups of 2 over 3 heads against
    JAX's 3 heads in one group)."""
    res, _ = got
    np.testing.assert_allclose(res[f"attn_{case}"], want[f"attn_{case}"], rtol=1e-5,
                               atol=1e-5)
    for name in ("dx", "dad", "das"):
        np.testing.assert_allclose(res[f"attn_{case}_{name}"], want[f"attn_{case}_{name}"],
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_rcm_order_matches_jax(got, want):
    res, _ = got
    np.testing.assert_array_equal(res["rcm_order"], want["rcm_order"])
    assert float(res["rcm_band_fraction"]) == pytest.approx(float(want["rcm_band_fraction"]))


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_training_steps_match_optax(got, want, name):
    """Three chained dist_full_batch_steps (Adam 5e-3) from the flax
    parameters: the global loss of each step within 1e-5 and every
    parameter after the last within 1e-5 of the optax steps over JAX's
    sharded graph; the CPU run launched no kernel."""
    res, _ = got
    np.testing.assert_allclose(res[f"{name}_losses"], want[f"{name}_losses"], rtol=0,
                               atol=1e-5)
    for i in range(2):
        p = want[f"{name}_params"][f"conv_{i}"]
        pairs = [("lin.weight", np.asarray(p["lin"]["kernel"]).T),
                 ("lin.bias", p["lin"]["bias"]) if name == "gcn" else ("bias", p["bias"])]
        if name == "gat":
            pairs += [("att_src", p["att_src"]), ("att_dst", p["att_dst"])]
        for key, theirs in pairs:
            np.testing.assert_allclose(res[f"{name}_param/convs.{i}.{key}"], theirs, rtol=0,
                                       atol=1e-5, err_msg=key)
    assert not res["launches"].any()


def _attention_pair(r_blk):
    """The attention pair of graph 'a' (host tensors)."""
    from cugraph_gnn_tpu_torch import _native
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG

    src, dst = _graphs()["a"]
    indptr, indices, _ = _native.build_csr(dst, src, N)
    return AG.build_attention_slab_pair(indptr, indices, block_rows=r_blk, device="cpu")


def _split(r_blk, world):
    """(rows per rank, padded rows) of a ``world``-rank split of N nodes."""
    nb = -(-(-(-N // r_blk)) // world) * world
    return nb // world * r_blk, nb * r_blk


@pytest.mark.parametrize("world", [1, 2, 4])
def test_plan_attention_tables(world):
    """Both attention tables of each rank, no process group: table A (the
    fallback edges by destination rank) reads, through the table, each
    edge's global source, table B (by source rank) each edge's global
    destination; every fallback edge is in one rank's A and one rank's B;
    each remote row is in its tail once, none in the halo-extended rows; a
    row's slots keep the bucketed order; both tails are empty at world 1."""
    from cugraph_gnn_tpu_torch.ops import dist_full_batch as DF

    pair = _attention_pair(R_BITS)
    fb_s, fb_d = pair.fwd.fb_src.numpy(), pair.fwd.fb_dst.numpy()
    ok = (fb_s >= 0) & (fb_d >= 0)
    edges = sorted(zip(fb_s[ok].tolist(), fb_d[ok].tolist()))
    rs, n_pad = _split(R_BITS, world)
    ext = rs + 2 * R_BITS
    seen = {"a": [], "b": []}
    for w in range(world):
        lo = w * rs - R_BITS
        tables = DF._attention_tables(fb_s, fb_d, rank=w, rows_per_rank=rs, world=world,
                                      block_rows=R_BITS)
        for key, t, local_is in zip("ab", tables, ("dst", "src")):
            # the edges this rank plans, in the bucketed order (fallback order)
            mine = ok & ((fb_d if local_is == "dst" else fb_s) // rs == w)
            local = (fb_d if local_is == "dst" else fb_s)[mine] - w * rs
            other = (fb_s if local_is == "dst" else fb_d)[mine]
            order = np.argsort(local, kind="stable")
            np.testing.assert_array_equal(t.dst, local[order])
            np.testing.assert_array_equal(t.rowptr, np.searchsorted(local[order],
                                                                    np.arange(rs + 1)))
            assert (t.x_ids >= 0).all() and (t.x_ids < ext + len(t.tail)).all()
            remote = np.append(t.tail, -1)[np.where(t.x_ids < ext, len(t.tail), t.x_ids - ext)]
            read = np.where(t.x_ids < ext, t.x_ids.astype(np.int64) + lo, remote)
            np.testing.assert_array_equal(read, other[order])
            assert (np.diff(t.tail) > 0).all()
            assert not ((t.tail >= lo) & (t.tail < lo + ext)).any()
            assert set(t.tail) == set(other[(other < lo) | (other >= lo + ext)])
            if world == 1:
                assert len(t.tail) == 0
            glob = t.dst.astype(np.int64) + w * rs
            seen[key] += (list(zip(read.tolist(), glob.tolist())) if key == "a"
                          else list(zip(glob.tolist(), read.tolist())))
        sp, tail_a, tail_b = DF.shard_attention_tables(pair, w, rs, n_pad, world, "cpu")
        np.testing.assert_array_equal(tail_a, tables[0].tail)
        np.testing.assert_array_equal(tail_b, tables[1].tail)
        np.testing.assert_array_equal(sp.fwd.fb_src.numpy(), tables[0].x_ids)
        np.testing.assert_array_equal(sp.fwd.fb_rowptr.numpy(), tables[0].rowptr)
        np.testing.assert_array_equal(sp.fb_t_dst.numpy(), tables[1].x_ids)
        np.testing.assert_array_equal(sp.fb_t_rowptr.numpy(), tables[1].rowptr)
    assert sorted(seen["a"]) == edges and sorted(seen["b"]) == edges


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ATTN_CASES[:-1])
def test_attention_shard_plain_matches_whole(case, world):
    """The shard forward's and backward's plain versions (``*_shard_ref``, as
    the gloo worlds run them; H = 1 through the single-head wrappers) on
    each rank's tables built with no process group (halos and remote rows
    from the whole arrays, packed as the exchanges pack them) against the
    whole graph's ``slab_attention_spmm_mh_ref`` (within 1e-5, m equal) and
    ``slab_attention_bwd_ref`` (within 1e-4) on the rank's rows."""
    from cugraph_gnn_tpu_torch.ops import dist_full_batch as DF
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_kernel as AK

    r_blk = _graph_kw(case)["block_rows"]
    pair = _attention_pair(r_blk)
    inp = _inputs()
    x, ad, as_, g = (torch.as_tensor(inp[k]) for k in ("x3", "ad3", "as3", "g3"))
    heads = 1 if case.startswith("h1") else H
    x, ad, as_, g = x[:, :heads], ad[:, :heads], as_[:, :heads], g[:, :heads]
    t = torch.as_tensor(np.random.default_rng(9).standard_normal((N, heads)), dtype=torch.float32)
    out_w, m_w, s_w = AK.slab_attention_spmm_mh_ref(pair.fwd, x, ad, as_, return_stats=True)
    grads_w = AG.slab_attention_bwd_ref(pair, x, ad, as_, m_w, s_w, t, g)
    rs, n_pad = _split(r_blk, world)

    def pad(a):
        return torch.cat([a, a.new_zeros((n_pad - N,) + tuple(a.shape[1:]))])

    x_p, ad_p, as_p, g_p = (pad(a) for a in (x, ad, as_, g))
    stats_p = AG.attention_stats(pad(ad), pad(m_w), pad(s_w), pad(t))
    remote = 0
    for w in range(world):
        sp, tail_a, tail_b = DF.shard_attention_tables(pair, w, rs, n_pad, world, "cpu")
        remote += bool(len(tail_a)) and bool(len(tail_b))
        own = slice(w * rs, (w + 1) * rs)
        rows = slice(0, max(min(N - w * rs, rs), 0))
        whole = slice(w * rs, w * rs + rows.stop)
        table_a = DF.halo_table(x_p, as_p, w, rs, r_blk, tail_a)
        table_b = DF.halo_table(g_p, stats_p, w, rs, r_blk, tail_b)
        as_ext = DF.halo_rows(as_p, w, rs, r_blk)
        stats_ext = DF.halo_rows(stats_p, w, rs, r_blk)
        stats_ext[..., 2].clamp_(min=1e-16)
        if heads == 1:
            out, m, s = (a[:, None] for a in AK.slab_attention_spmm_shard(
                sp.fwd, table_a.squeeze_heads(), ad_p[own, 0], as_ext[:, 0],
                return_stats=True))
            grads = [a[:, None] for a in AG.slab_attention_bwd_shard(
                sp, table_a.squeeze_heads(), as_ext[:, 0], table_b.squeeze_heads(),
                stats_ext[:, 0])]
        else:
            out, m, s = AK.slab_attention_spmm_mh_shard_ref(sp.fwd, table_a, ad_p[own], as_ext,
                                                            return_stats=True)
            grads = AG.slab_attention_bwd_shard_ref(sp, table_a, as_ext, table_b, stats_ext)
        np.testing.assert_allclose(out[rows], out_w[whole], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(m[rows], m_w[whole])
        np.testing.assert_allclose(s[rows], s_w[whole], rtol=1e-5, atol=1e-5)
        for name, a, b in zip(("dx", "dad", "das"), grads, grads_w):
            np.testing.assert_allclose(a[rows], b[whole], rtol=1e-4, atol=1e-4, err_msg=name)
            assert not a[rows.stop:].any()
    # at R = 128 the ranks read remote rows through both tables (at R = 512
    # every rank's halo-extended rows cover the 600 nodes)
    assert remote >= (1 if r_blk == R_BITS else 0)
