"""Port parity: homogeneous link prediction, PyTorch port against the JAX
package on small graphs, on the CPU.

- ``ops/edge_ids.py``: the host splits and round trips, and ``combine_local``
  across the 2**30 carry; exact.
- ``ops/csr.py``: ``coo_to_csr`` (both orientations, with ``edge_perm``),
  ``coo_to_csr_np``, ``csr_add_self_loop`` and ``edge_mask_valid``; exact.
- ``sample_negative_edges`` with the JAX draws passed in (``split(key, 4)``:
  sources on k1, destinations on k2, the rejection's re-draw on k3, the
  temporal re-draws on ``split(k4, retries)``): uniform, weighted, true-edge
  rejection, an empty table, pinned (triplet) sources, temporal retries;
  exact.  ``make_edge_key_sorted``'s packed keys decode to JAX's table.
- ``neg_cat`` with an even and an uneven split; exact.
- One shuffled epoch of ``LinkNeighborLoader`` (binary with rejection and
  user labels, triplet, ``drop_last``) over a graph whose positive edges
  repeat nodes, with the JAX loader's negatives and uniforms replayed per
  batch: seeds, ``edge_label_index``, ``edge_label``, ``input_id``, ``len``,
  every level, map and count, and the gathered rows; exact.
- One float32 ``link_step`` of GraphSAGE from ``graphsage_from_flax``
  weights against ``examples/link_prediction.py``'s loss: loss and
  gradients within 1e-5; ``link_auc`` against the example's formula.
- The options not ported raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cugraph_gnn_tpu.data import FeatureStore as JaxFeatureStore
from cugraph_gnn_tpu.data import GraphStore as JaxGraphStore
from cugraph_gnn_tpu.loader import LinkNeighborLoader as JaxLinkNeighborLoader
from cugraph_gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from cugraph_gnn_tpu.ops import csr as jax_csr
from cugraph_gnn_tpu.ops import edge_ids as jax_eid
from cugraph_gnn_tpu.sampler import negative as jax_neg
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader
from cugraph_gnn_tpu_torch.loader.link_loader import draw_negatives
from cugraph_gnn_tpu_torch.models.convert import graphsage_from_flax
from cugraph_gnn_tpu_torch.ops import csr as port_csr
from cugraph_gnn_tpu_torch.ops import edge_ids as port_eid
from cugraph_gnn_tpu_torch.sampler import negative as port_neg
from cugraph_gnn_tpu_torch.sampler.output import HopBlock, to_coo, to_csc
from cugraph_gnn_tpu_torch.train_link import link_auc, link_eval_scores, link_loss

N, F_IN, HIDDEN, OUT = 60, 6, 16, 8
BATCH, FANOUTS, SEED = 16, (3, 2), 3
ET = ("n", "to", "n")


# -- edge ids and CSR ------------------------------------------------------------

def test_edge_ids_match_jax():
    rng = np.random.default_rng(0)
    gids = np.concatenate([rng.integers(0, 2**40, 50), [-1, 0, 2**30 - 1, 2**30, 2**33]])
    hi, lo = port_eid.from_int64_np(gids)
    jhi, jlo = jax_eid.from_int64_np(gids)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(port_eid.to_int64_np(hi, lo), gids)
    bases = np.array([0, 2**30 - 5, 3 * 2**30 + 7, 2**40])
    np.testing.assert_array_equal(port_eid.split_bases_np(bases),
                                  jax_eid.split_bases_np(bases))
    assert port_eid.MAX_LOCAL_EDGES == jax_eid.MAX_LOCAL_EDGES == 2**30
    # base_lo + local crosses 2**30: one carry into hi; -1 is a pad
    local = np.array([0, 4, 5, 6, 2**30 - 1, -1], np.int32)
    for base in (2**30 - 5, 3 * 2**30 + 7):
        b_hi, b_lo = port_eid.split_bases_np([base])[0]
        got = port_eid.combine_local(torch.as_tensor(local), b_hi, b_lo)
        want = jax_eid.combine_local(jnp.asarray(local), jnp.int32(b_hi), jnp.int32(b_lo))
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        ids = port_eid.to_int64_np(*(a.numpy() for a in got))
        np.testing.assert_array_equal(ids, np.where(local >= 0, base + local.astype(np.int64), -1))
    # the sampler's views carry the high plane
    nl = torch.tensor([[0, -1], [1, 2]], dtype=torch.int32)
    hop = HopBlock(nl, nl, torch.tensor([[5, -1], [0, 9]], dtype=torch.int32),
                   torch.tensor([[1, 0], [2, 0]], dtype=torch.int32))
    np.testing.assert_array_equal(hop.edge_ids64(), [[2**30 + 5, -1], [2**31, 9]])

    class _Batch:
        hops = [hop]
        levels = [torch.tensor([0, 1], dtype=torch.int32), torch.arange(3, dtype=torch.int32)]
        level_counts = [torch.tensor(2), torch.tensor(3)]
        num_hops = 1

    np.testing.assert_array_equal(to_coo(_Batch).edge_ids64(),
                                  [2**30 + 5, -1, 2**31, 9])
    np.testing.assert_array_equal(to_csc(_Batch).edge_ids64()[0],
                                  [2**30 + 5, 2**31, 9, -1])


def test_csr_ops_match_jax():
    rng = np.random.default_rng(1)
    n = 40
    src = rng.integers(0, n, 300).astype(np.int32)
    dst = rng.integers(0, n, 300).astype(np.int32)
    dst[:30] = 7                                     # a hub row
    for sort_by in ("src", "dst"):
        csr, perm = port_csr.coo_to_csr(torch.as_tensor(src), torch.as_tensor(dst), n,
                                        sort_by=sort_by)
        jcsr, jperm = jax_csr.coo_to_csr(jnp.asarray(src), jnp.asarray(dst), n,
                                         sort_by=sort_by)
        for a, b in ((csr.indptr, jcsr.indptr), (csr.indices, jcsr.indices), (perm, jperm)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert csr.num_nodes == n and csr.num_edges == 300
        np.testing.assert_array_equal(csr.degrees().numpy(), np.asarray(jcsr.degrees()))
        (ip, ix), p = port_csr.coo_to_csr_np(src, dst, n, sort_by=sort_by)
        (jip, jix), jp = jax_csr.coo_to_csr_np(src, dst, n, sort_by=sort_by)
        for a, b in ((ip, jip), (ix, jix), (p, jp)):
            np.testing.assert_array_equal(a, b)
        # edge_perm carries an edge attribute into CSR order
        attr = np.arange(300) * 3
        np.testing.assert_array_equal(attr[perm.numpy()], attr[np.asarray(jperm)])
    indptr = torch.as_tensor(ip.astype(np.int32))
    got = port_csr.csr_add_self_loop(indptr, torch.as_tensor(ix))
    want = jax_csr.csr_add_self_loop(jnp.asarray(ip.astype(np.int32)), jnp.asarray(ix))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    neigh = np.array([[0, -1, 3], [-1, -1, 2]], np.int32)
    np.testing.assert_array_equal(port_csr.edge_mask_valid(torch.as_tensor(neigh)).numpy(),
                                  np.asarray(jax_csr.edge_mask_valid(jnp.asarray(neigh))))


# -- negative sampling -----------------------------------------------------------

def jax_draws(key, num_src, num_dst, count, config, *, pinned=False, rejection=False,
              retries=0):
    """The candidates ``sample_negative_edges(key, ...)`` draws in JAX."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    w_src, w_dst = (None if w is None else jnp.asarray(np.asarray(w))
                    for w in (config.src_weight, config.dst_weight))

    def choice(k, n, w):
        return torch.as_tensor(np.array(jax_neg._weighted_choice(k, n, (count,), w)))

    src = None if pinned else choice(k1, num_src, w_src)
    dst = choice(k2, num_dst, w_dst)
    dst2 = choice(k3, num_dst, w_dst) if rejection else None
    redraws = None
    if retries:
        redraws = torch.stack([choice(kk, num_dst, w_dst)
                               for kk in jax.random.split(k4, retries)])
    return port_neg.NegativeDraws(src, dst, dst2, redraws)


def _true_edges(n=30, e=240, seed=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


NEG_CASES = ["uniform", "weighted", "reject", "reject_weighted", "empty_table",
             "triplet", "temporal", "temporal_reject"]


@pytest.mark.parametrize("case", NEG_CASES)
def test_sample_negative_edges_matches_jax(case):
    n, count = 30, 64
    src_t, dst_t = _true_edges(n)
    rng = np.random.default_rng(3)
    w = rng.random(n).astype(np.float32)
    w[::4] = 0
    weighted = "weighted" in case
    jcfg = jax_neg.NegativeSampling("binary", 1.0, jnp.asarray(w) if weighted else None,
                                    jnp.asarray(w) if weighted else None)
    pcfg = port_neg.NegativeSampling("binary", 1.0, torch.as_tensor(w) if weighted else None,
                                     torch.as_tensor(w) if weighted else None)
    jtable = ptable = None
    if "reject" in case or case == "triplet":
        jtable = jax_neg.make_edge_key_sorted(src_t, dst_t, n)
        ptable = port_neg.make_edge_key_sorted(src_t, dst_t, n, device="cpu")
        ks, kd = port_neg.edge_key_pairs(ptable)
        np.testing.assert_array_equal(torch.stack([ks, kd], 1).numpy(), np.asarray(jtable))
    elif case == "empty_table":
        jtable = jax_neg.make_edge_key_sorted([], [], n)
        ptable = port_neg.make_edge_key_sorted([], [], n, device="cpu")
    kw, pkw = {}, {}
    if case == "triplet":
        ps = np.repeat(src_t[:count // 2], 2).astype(np.int32)
        ps[-5:] = -1                       # padded positives
        kw["src"] = jnp.asarray(ps)
        pkw["src"] = torch.as_tensor(ps)
    retries = 0
    if "temporal" in case:
        retries = 3
        node_time = rng.integers(0, 10, n)
        seed_time = rng.integers(0, 10, count)
        kw.update(node_time=jnp.asarray(node_time), seed_time=jnp.asarray(seed_time),
                  time_retries=retries)
        pkw.update(node_time=torch.as_tensor(node_time), seed_time=torch.as_tensor(seed_time),
                   time_retries=retries)
    key = jax.random.PRNGKey(7)
    want = jax_neg.sample_negative_edges(key, n, n, count, jcfg, jtable, **kw)
    draws = jax_draws(key, n, n, count, pcfg, pinned="src" in pkw,
                      rejection=ptable is not None and ptable.numel() > 0, retries=retries)
    got = port_neg.sample_negative_edges(n, n, count, pcfg, ptable, draws=draws,
                                         device="cpu", **pkw)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s, d = (a.numpy() for a in got)
    if ptable is not None and ptable.numel():
        true = set(zip(src_t.tolist(), dst_t.tolist()))
        assert not any((a, b) in true for a, b in zip(s, d) if a >= 0 and b >= 0)
    if case == "reject":
        assert (s < 0).any() or (draws.dst != torch.as_tensor(d)).any()   # it did work
    # without injected draws: the generator's, reproducible and in range
    g = [torch.Generator().manual_seed(5) for _ in range(2)]
    a, b = (port_neg.sample_negative_edges(n, n, count, pcfg, ptable, generator=gi,
                                           device="cpu", **pkw) for gi in g)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[1].max()) < n and int(a[1].min()) >= -1
    if weighted:
        valid = a[1][a[1] >= 0].numpy()
        assert not np.isin(valid, np.nonzero(w == 0)[0]).any()


@pytest.mark.parametrize("n_pos,n_neg,batch", [(8, 8, 4), (10, 7, 4), (5, 3, 8)])
def test_neg_cat_matches_jax(n_pos, n_neg, batch):
    pos = np.arange(n_pos) + 100
    neg = -np.arange(1, n_neg + 1)
    got = port_neg.neg_cat(torch.as_tensor(pos), torch.as_tensor(neg), batch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_neg.neg_cat(pos, neg, batch)))


# -- the link loader -----------------------------------------------------------------

def _graph(seed=4):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 500)
    dst = rng.integers(0, N, 500)
    dst[:40] = 5                                     # a hub
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    # positives over few nodes: seeds repeat within a batch and across blocks
    eli = np.stack([rng.integers(0, 12, 70), rng.integers(0, 20, 70)])
    labels = rng.integers(1, 4, 70).astype(np.float32)
    return src, dst, x, eli, labels


def _stores(jax_side, src, dst, x):
    if jax_side:
        gs, fs = JaxGraphStore(), JaxFeatureStore()
    else:
        gs, fs = GraphStore(device="cpu"), FeatureStore(device="cpu")
    gs.put_edge_index((src, dst), ET, num_nodes=(N, N))
    fs["x"] = x
    return fs, gs


class _Replay:
    """The port loader's negatives and sampler, with batch i's draws taken
    from the JAX loader's keys: ``fold_in(fold_in(PRNGKey(seed), epoch),
    i)``, then 1 for the negatives and 2 for the sampler."""

    def __init__(self, loader, seed, epoch=0):
        self.loader, self.inner = loader, loader.sampler
        self.key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
        self.neg_calls = self.sample_calls = 0
        loader.sampler = self
        loader._negatives = self.negatives

    def negatives(self, ps, n_neg):
        lo = self.loader
        key = jax.random.fold_in(jax.random.fold_in(self.key, self.neg_calls), 1)
        self.neg_calls += 1
        draws = jax_draws(key, lo.num_src, lo.num_dst, n_neg, lo.neg,
                          pinned=lo.neg.mode == "triplet",
                          rejection=lo._edge_key_sorted is not None)
        return draw_negatives(ps, n_neg, lo.num_src, lo.num_dst, lo.neg, lo._edge_key_sorted,
                              draws=draws, device="cpu")

    def sample(self, seeds, generator=None):
        key = jax.random.fold_in(jax.random.fold_in(self.key, self.sample_calls), 2)
        self.sample_calls += 1
        caps = self.inner.level_caps(seeds.shape[0])
        u = [np.array(jax.random.uniform(jax.random.fold_in(key, h), (caps[h], k)))
             for h, k in enumerate(self.inner.fanouts)]
        return self.inner.sample(seeds, u=u)


LOADER_CASES = {
    "binary": dict(neg_sampling="binary", reject_true_edges=True, labels=True),
    "triplet": dict(neg_sampling=dict(mode="triplet", amount=2), reject_true_edges=True),
    "drop_last": dict(neg_sampling="binary", drop_last=True),
}


@pytest.fixture(scope="module")
def epochs():
    """One shuffled epoch of each loader case, JAX's and the port's."""
    src, dst, x, eli, labels = _graph()
    out = {}
    for name, case in LOADER_CASES.items():
        case = dict(case)
        kw = dict(num_neighbors=FANOUTS, edge_label_index=eli, batch_size=BATCH,
                  shuffle=True, seed=SEED, **({"edge_label": labels}
                                              if case.pop("labels", False) else {}), **case)
        jl = JaxLinkNeighborLoader(_stores(True, src, dst, x), **kw)
        pl = LinkNeighborLoader(_stores(False, src, dst, x), **kw)
        _Replay(pl, SEED)
        out[name] = (jl, pl, list(jl), list(pl))
    return out


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_link_loader_epoch_matches_jax(epochs, case):
    jl, pl, ref, port = epochs[case]
    n_edges = 70
    assert len(pl) == len(jl) == len(port) == len(ref)
    assert len(pl) == (n_edges // BATCH if case == "drop_last" else -(-n_edges // BATCH))
    if case != "drop_last":
        assert int((port[-1].input_id < 0).sum()) == BATCH * len(pl) - n_edges   # padded
    repeats = 0
    for p, r in zip(port, ref):
        for a, b in ((p.seeds, r.seeds), (p.edge_label_index, r.edge_label_index),
                     (p.edge_label, r.edge_label), (p.input_id, r.input_id), (p.x, r.x)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert p.seeds.dtype == torch.int32 and p.edge_label_index.dtype == torch.int32
        s = p.sample
        for a, b in zip(s.levels + s.level_counts, r.sample.levels + r.sample.level_counts):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for hp, hr in zip(s.hops, r.sample.hops):
            for name in ("neigh_local", "neigh_global", "edge_ids"):
                np.testing.assert_array_equal(getattr(hp, name).numpy(),
                                              np.asarray(getattr(hr, name)))
        valid = p.seeds[p.seeds >= 0]
        repeats += valid.numel() - torch.unique(valid).numel()
    assert repeats > 0
    if case == "triplet":
        b = BATCH
        np.testing.assert_array_equal(port[0].seeds[2 * b:4 * b].numpy(),
                                      np.repeat(port[0].seeds[:b].numpy(), 2))
    # a second epoch reshuffles as JAX does
    np.testing.assert_array_equal(pl._epoch_order(), jl_order(jl, 1))


def jl_order(jl, epoch):
    order = np.arange(len(jl.pos_src))
    if jl.shuffle:
        np.random.default_rng(epoch + 999).shuffle(order)
    return order


def test_link_step_matches_example(epochs):
    """One float32 step of the example's loop on the binary loader's first
    batch: loss and gradients within 1e-5."""
    _, _, ref, port = epochs["binary"]
    r, p = ref[0], port[0]
    model = JaxGraphSAGE(hidden_features=HIDDEN, out_features=OUT, num_layers=2)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), r.x, r.sample)

    def loss_fn(prm):
        emb = model.apply(prm, r.x, r.sample)
        eli = r.edge_label_index
        score = jnp.sum(emb[eli[0]] * emb[eli[1]], axis=-1)
        valid = (r.seeds[eli[0]] >= 0) & (r.seeds[eli[1]] >= 0)
        ls = optax.sigmoid_binary_cross_entropy(score, r.edge_label)
        return jnp.sum(jnp.where(valid, ls, 0)) / jnp.maximum(jnp.sum(valid), 1)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    pm = graphsage_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    ploss = link_loss(pm(p.x, p.sample), p)
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(loss), rtol=0, atol=1e-5)
    for i, conv in enumerate(pm.convs):
        g = grads["params"][f"conv_{i}"]
        for w, gw in ((conv.lin_self.weight, g["lin_self"]["kernel"].T),
                      (conv.lin_self.bias, g["lin_self"]["bias"]),
                      (conv.lin_neigh.weight, g["lin_neigh"]["kernel"].T)):
            np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), rtol=1e-5, atol=1e-5)
    # the AUC pass: the example's formula on the same scores
    s, lab = link_eval_scores(pm, p)
    order = np.argsort(s)
    rank = np.empty_like(order, dtype=np.float64)
    rank[order] = np.arange(1, len(s) + 1)
    n_pos, n_neg = int(lab.sum()), int((1 - lab).sum())
    assert link_auc(s, lab) == ((rank[lab > 0.5].sum() - n_pos * (n_pos + 1) / 2)
                                / max(n_pos * n_neg, 1))
    assert link_auc([0.1, 0.9, 0.2, 0.8], [0, 1, 0, 1]) == 1.0


def test_link_loader_generator_and_refusals():
    src, dst, x, eli, _ = _graph(5)
    data = _stores(False, src, dst, x)
    kw = dict(num_neighbors=FANOUTS, edge_label_index=eli, batch_size=BATCH,
              neg_sampling="binary", reject_true_edges=True)
    a, b, c = (next(iter(LinkNeighborLoader(data, seed=s, **kw))) for s in (1, 1, 2))
    assert torch.equal(a.seeds, b.seeds) and not torch.equal(a.seeds, c.seeds)
    for la, lb in zip(a.sample.levels, b.sample.levels):
        assert torch.equal(la, lb)
    # a typed edge_label_index (ported since the hetero slice): on a one-type
    # store the offsets are 0, so the batch is the untyped one
    typed = next(iter(LinkNeighborLoader(data, seed=1, **{**kw, "edge_label_index": (ET, eli)})))
    assert torch.equal(typed.seeds, a.seeds) and torch.equal(typed.x, a.x)
    # the temporal options need each other (tests/test_torch_temporal.py
    # holds them against JAX)
    for extra in (dict(edge_label_time=np.zeros(70)), dict(time_attr="t")):
        with pytest.raises(ValueError, match="requires"):
            LinkNeighborLoader(data, **{**kw, **extra})
