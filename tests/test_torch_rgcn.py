"""Port parity: R-GCN (``RGCNConv``, ``RGCN``, ``RelationalFullBatch``),
PyTorch port against the JAX package on the CPU, float32.

- ``RGCNConv`` ``forward`` (an absent relation included), ``typed_call``
  (segment plans with covered and uncovered segments), ``edgewise`` and
  ``full`` against flax, from the weights ``rgcn_from_flax`` carries: atol
  1e-5.
- ``RGCN.batch_call`` over one typed JAX batch of ``hetero_multihop_batched``
  (and ``forward`` over an untyped one), then three training steps: loss,
  every gradient and the parameters after each Adam update against optax,
  atol 1e-5.
- ``RelationalFullBatch`` on a locality graph of 300 nodes and 3 relations
  (one empty): its RCM order, inverse order and band fraction equal JAX's;
  ``RGCN.full_graph`` against JAX's ``full_graph`` (the interpret-mode slab,
  computed once in this file) and against the port's own ``full``, values
  and gradients (x and every parameter), atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.nn import functional as F

from cugraph_gnn_tpu.models import RGCN as JaxRGCN
from cugraph_gnn_tpu.models.conv import RGCNConv as JaxRGCNConv
from cugraph_gnn_tpu.ops import RelationalFullBatch as JaxRFB
from cugraph_gnn_tpu.sampler import hetero as jax_het
from cugraph_gnn_tpu_torch.models.convert import model_from_flax, rgcn_from_flax
from cugraph_gnn_tpu_torch.models.conv import RGCNConv
from cugraph_gnn_tpu_torch.models.zoo import RGCN
from cugraph_gnn_tpu_torch.ops.full_batch import RelationalFullBatch
from cugraph_gnn_tpu_torch.sampler.hetero import HeteroMultihopBatch
from cugraph_gnn_tpu_torch.sampler.output import HopBlock

F_IN, HID, OUT, R = 6, 8, 4, 3
ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(a.detach().numpy() if isinstance(a, torch.Tensor) else a,
                               np.asarray(b), rtol=0, atol=atol)


def conv_from_flax(params):
    """A one-layer port conv from a flax RGCNConv tree."""
    model = rgcn_from_flax({"params": {"conv_0": params["params"]}}, device="cpu")
    return model.convs[0]


# -- the conv ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def conv_case():
    rng = np.random.default_rng(0)
    s, k = 7, 3
    x_dst = rng.standard_normal((s, F_IN)).astype(np.float32)
    xn = [rng.standard_normal((s, k, F_IN)).astype(np.float32) for _ in range(R)]
    masks = [rng.random((s, k)) < 0.6 for _ in range(R)]
    masks[0][2] = False                                   # a row with no neighbor
    conv = JaxRGCNConv(HID, num_relations=R)
    blocks = [(jnp.asarray(a), jnp.asarray(m)) for a, m in zip(xn, masks)]
    params = jax.jit(conv.init)(jax.random.PRNGKey(0), jnp.asarray(x_dst), blocks)
    blocks[1] = None                                      # absent from the batch
    return dict(conv=conv, params=params, x_dst=x_dst, xn=xn, masks=masks, blocks=blocks,
                rng=rng)


def test_rgcn_conv_forward_matches_flax(conv_case):
    c = conv_case
    want = c["conv"].apply(c["params"], jnp.asarray(c["x_dst"]), c["blocks"])
    conv = conv_from_flax(_np(c["params"]))
    got = conv(torch.as_tensor(c["x_dst"]),
               [None if b is None else (torch.as_tensor(np.array(b[0])),
                                        torch.as_tensor(np.array(b[1])))
                for b in c["blocks"]])
    close(got, want)


def test_rgcn_conv_typed_call_matches_flax(conv_case):
    c = conv_case
    rng = c["rng"]
    # level of 9 rows in segments 2 | 4 | 3: relation 0 covers segments 0 and
    # 2, relation 2 segment 1, relation 1 absent
    x_dst = rng.standard_normal((9, F_IN)).astype(np.float32)
    plans = {0: ((2, True), (4, False), (3, True)), 2: ((2, False), (4, True), (3, False))}
    rows = {0: 5, 2: 4}
    blk, pblk = [], []
    for r in range(R):
        if r not in plans:
            blk.append(None)
            pblk.append(None)
            continue
        xn = rng.standard_normal((rows[r], 3, F_IN)).astype(np.float32)
        m = rng.random((rows[r], 3)) < 0.7
        blk.append((jnp.asarray(xn), jnp.asarray(m), plans[r]))
        pblk.append((torch.as_tensor(xn), torch.as_tensor(m), plans[r]))
    want = c["conv"].apply(c["params"], jnp.asarray(x_dst), blk,
                           method=JaxRGCNConv.typed_call)
    got = conv_from_flax(_np(c["params"])).typed_call(torch.as_tensor(x_dst), pblk)
    close(got, want)


def test_rgcn_conv_edgewise_matches_flax(conv_case):
    c = conv_case
    rng = c["rng"]
    xn = rng.standard_normal((7, 4, F_IN)).astype(np.float32)
    m = rng.random((7, 4)) < 0.8
    et = rng.integers(0, R, (7, 4)).astype(np.int32)
    want = c["conv"].apply(c["params"], jnp.asarray(c["x_dst"]), jnp.asarray(xn),
                           jnp.asarray(m), jnp.asarray(et), method=JaxRGCNConv.edgewise)
    got = conv_from_flax(_np(c["params"])).edgewise(
        torch.as_tensor(c["x_dst"]), torch.as_tensor(xn), torch.as_tensor(m),
        torch.as_tensor(et))
    close(got, want)


def test_rgcn_conv_full_matches_flax(conv_case):
    c = conv_case
    rng = c["rng"]
    n, e = 12, 40
    x = rng.standard_normal((n, F_IN)).astype(np.float32)
    src, dst = rng.integers(0, n, e).astype(np.int32), rng.integers(0, 10, e).astype(np.int32)
    src[:3] = -1
    et = rng.integers(0, R, e).astype(np.int32)
    want = c["conv"].apply(c["params"], *map(jnp.asarray, (x, src, dst, et)), 10,
                           method=JaxRGCNConv.full)
    got = conv_from_flax(_np(c["params"])).full(*map(torch.as_tensor, (x, src, dst, et)), 10)
    close(got, want)


# -- the model over a sampled batch -------------------------------------------------

NODES = {"paper": 24, "author": 16, "field": 6}
OFF = {"paper": 0, "author": 24, "field": 40}
ETYPES = ["paper__cites__paper", "author__writes__paper", "field__has__paper"]


def _csrs(seed=0):
    rng = np.random.default_rng(seed)
    total = sum(NODES.values())
    csrs, maxdeg, bases, base = {}, {}, {}, 0
    for name in ETYPES:
        src_t = name.split("__")[0]
        deg = np.zeros(total, np.int64)
        deg[:NODES["paper"]] = rng.integers(0, 6, NODES["paper"])
        ip = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        ix = (OFF[src_t] + rng.integers(0, NODES[src_t], int(ip[-1]))).astype(np.int32)
        csrs[name] = (ip, ix)
        maxdeg[name], bases[name] = int(deg.max()), base
        base += int(ip[-1])
    return csrs, maxdeg, bases


def to_port_batch(jb):
    """A JAX HeteroMultihopBatch as the port's (tensors from numpy)."""
    t = lambda a: None if a is None else torch.as_tensor(np.array(a))    # noqa: E731
    return HeteroMultihopBatch(
        levels=[t(a) for a in jb.levels], level_counts=[t(a) for a in jb.level_counts],
        hops=[{k: HopBlock(*(t(a) for a in b)) for k, b in hop.items()} for hop in jb.hops],
        seed_count=t(jb.seed_count), num_shards=jb.num_shards, layouts=jb.layouts)


@pytest.fixture(scope="module")
def sampled_case():
    """One typed step of 6 paper seeds (JAX's sampler), features, labels,
    the JAX model's params and three optax steps' losses, grads and params."""
    csrs, maxdeg, bases = _csrs()
    rng = np.random.default_rng(3)
    seeds = rng.integers(0, NODES["paper"], (1, 6)).astype(np.int32)
    seeds[0, 4] = -1
    jb = jax.jit(functools.partial(
        jax_het.hetero_multihop_batched, etype_names=ETYPES,
        fanouts={ETYPES[0]: [3, 2], ETYPES[1]: [2, 2], ETYPES[2]: [2, 1]},
        edge_bases=bases, max_degrees=maxdeg, caps=[6, 0, 0], seed_type="paper",
        dst_types={n: "paper" for n in ETYPES},
        src_types={n: n.split("__")[0] for n in ETYPES}))(
        jax.random.PRNGKey(2), {n: tuple(map(jnp.asarray, v)) for n, v in csrs.items()},
        jnp.asarray(seeds))
    jb = jax.tree_util.tree_map(lambda a: a[0], jb)
    feats = rng.standard_normal((sum(NODES.values()), F_IN)).astype(np.float32)
    inp = np.asarray(jb.input_nodes)
    x = np.where((inp >= 0)[:, None], feats[np.clip(inp, 0, None)], 0).astype(np.float32)
    labels = rng.integers(0, OUT, NODES["paper"])
    model = JaxRGCN(num_relations=R, hidden_features=HID, out_features=OUT)
    params = jax.jit(functools.partial(model.init, method=JaxRGCN.batch_call),
                     static_argnums=3)(jax.random.PRNGKey(5), jnp.asarray(x), jb, tuple(ETYPES))
    tx = optax.adam(1e-3)
    y = jnp.asarray(labels[np.clip(seeds[0], 0, None)])
    valid = jnp.asarray(seeds[0] >= 0)

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(x), jb, ETYPES, method=JaxRGCN.batch_call)
        ls = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        return jnp.sum(jnp.where(valid, ls, 0)) / jnp.maximum(jnp.sum(valid), 1), logits

    @jax.jit
    def step(p, opt):
        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        u, opt = tx.update(g, opt)
        return optax.apply_updates(p, u), opt, loss, g, logits

    p, opt, steps = params, tx.init(params), []
    for _ in range(3):
        p, opt, loss, g, logits = step(p, opt)
        steps.append((float(loss), _np(g), _np(p), np.asarray(logits)))
    return dict(jb=jb, x=x, labels=labels, seeds=seeds[0], params=_np(params), steps=steps)


def _flax_pairs(model, tree):
    """(port parameter, flax array in torch layout) for every parameter."""
    for i, conv in enumerate(model.convs):
        c = tree["params"][f"conv_{i}"]
        yield conv.lin_root.weight, c["lin_root"]["kernel"].T
        yield conv.lin_root.bias, c["lin_root"]["bias"]
        for r, lin in enumerate(conv.lin_rel):
            yield lin.weight, c[f"lin_rel_{r}"]["kernel"].T


def test_rgcn_batch_call_and_adam_steps_match_optax(sampled_case):
    c = sampled_case
    batch = to_port_batch(c["jb"])
    assert batch.layouts and all(len(e) == 4 for lay in batch.layouts for e in lay)
    model = model_from_flax("rgcn", c["params"], device="cpu")
    assert len(model.convs[0].lin_rel) == R
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    x = torch.as_tensor(c["x"])
    seeds = torch.as_tensor(c["seeds"])
    y = torch.as_tensor(c["labels"])[seeds.clamp(min=0).long()]
    for loss_w, grads_w, params_w, logits_w in c["steps"]:
        opt.zero_grad()
        logits = model.batch_call(x, batch, ETYPES)
        close(logits, logits_w)
        valid = seeds >= 0
        ls = F.cross_entropy(logits, y, reduction="none")
        loss = torch.where(valid, ls, 0).sum() / valid.sum()
        loss.backward()
        assert abs(float(loss.detach()) - loss_w) <= ATOL
        for p, g in _flax_pairs(model, {"params": grads_w["params"]}):
            close(p.grad, g)
        opt.step()
        for p, w in _flax_pairs(model, params_w):
            close(p, w)


def test_rgcn_forward_over_untyped_blocks_matches_flax(sampled_case):
    """``RGCN.__call__`` over per-relation (neigh_local, mask) blocks of a
    deduplicated batch (as ``examples/hetero_link_pred.py`` feeds it)."""
    c = sampled_case
    csrs, maxdeg, bases = _csrs(1)
    jb = jax.jit(functools.partial(
        jax_het.hetero_multihop, etype_names=ETYPES, fanouts={n: [2, 2] for n in ETYPES},
        edge_bases=bases, max_degrees=maxdeg, caps=[6, 42, 294]))(
        jax.random.PRNGKey(4), {n: tuple(map(jnp.asarray, v)) for n, v in csrs.items()},
        jnp.asarray(c["seeds"]))
    rel = [[(jb.hops[h][n].neigh_local, jb.hops[h][n].mask) if n != ETYPES[1] or h else None
            for n in ETYPES] for h in (1, 0)]
    model = JaxRGCN(num_relations=R, hidden_features=HID, out_features=OUT)
    x = np.random.default_rng(6).standard_normal((294, F_IN)).astype(np.float32)
    want = model.apply({"params": c["params"]["params"]}, jnp.asarray(x), rel)
    port = rgcn_from_flax(c["params"], device="cpu")
    prel = [[None if b is None else tuple(torch.as_tensor(np.array(a)) for a in b)
             for b in layer] for layer in rel]
    close(port(torch.as_tensor(x), prel), want)
    close(port.batch_call(torch.as_tensor(x), to_port_batch(jb), ETYPES),
          model.apply({"params": c["params"]["params"]}, jnp.asarray(x), jb, ETYPES,
                      method=JaxRGCN.batch_call))


# -- full batch ---------------------------------------------------------------------

N = 300


@pytest.fixture(scope="module")
def full_case():
    """A locality graph with relation R-1 empty, JAX's RelationalFullBatch,
    and JAX's full_graph output and input gradient (computed once)."""
    rng = np.random.default_rng(7)
    dst = np.repeat(np.arange(N), 4)
    src = (dst + rng.integers(-20, 21, dst.shape[0])) % N
    et = rng.integers(0, R - 1, dst.shape[0])
    src, dst, et = (a.astype(np.int32) for a in (src, dst, et))
    rfb_j = JaxRFB(src, dst, et, R, N, block_rows=128)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    tgt = rng.standard_normal((N, OUT)).astype(np.float32)
    model = JaxRGCN(num_relations=R, hidden_features=HID, out_features=OUT)
    params = jax.jit(functools.partial(model.init, method=JaxRGCN.full),
                     static_argnums=5)(jax.random.PRNGKey(1), *map(jnp.asarray, (x, src, dst, et)),
                                       N)

    @jax.jit
    def slab(p, xx):
        def loss(p, xx):
            o = rfb_j.to_input_order(model.apply(p, rfb_j.to_graph_order(xx), rfb_j,
                                                 method=JaxRGCN.full_graph))
            return jnp.mean((o - tgt) ** 2), o
        (_, o), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, xx)
        return o, g

    out, (g_p, g_x) = slab(params, jnp.asarray(x))
    return dict(src=src, dst=dst, et=et, rfb_j=rfb_j, x=x, tgt=tgt, params=_np(params),
                out=np.asarray(out), g_p=_np(g_p), g_x=np.asarray(g_x))


def test_relational_full_batch_orders_match_jax(full_case):
    c = full_case
    rfb = RelationalFullBatch(c["src"], c["dst"], c["et"], R, N, block_rows=128, device="cpu")
    j = c["rfb_j"]
    assert (rfb.order is None) == (j.order is None)
    np.testing.assert_array_equal(rfb.order, j.order)
    np.testing.assert_array_equal(rfb.inv_order, j.inv_order)
    assert rfb.band_fraction == pytest.approx(j.band_fraction, abs=1e-12)
    assert [g.band_fraction for g in rfb.graphs] == pytest.approx(
        [g.band_fraction for g in j.graphs], abs=1e-12)
    ids = torch.tensor([3, -1, 17])
    np.testing.assert_array_equal(rfb.map_ids(ids).numpy(),
                                  np.asarray(j.map_ids(jnp.asarray(ids.numpy()))))
    none = RelationalFullBatch(c["src"], c["dst"], c["et"], R, N, reorder="none",
                               device="cpu")
    assert none.order is None and none.map_ids(ids) is ids
    with pytest.raises(ValueError, match="relations"):
        RGCNConv(4, 4, R - 1).full_graph(torch.zeros(N, 4), rfb)


def test_rgcn_full_graph_matches_jax_and_full(full_case):
    c = full_case
    rfb = RelationalFullBatch(c["src"], c["dst"], c["et"], R, N, block_rows=128, device="cpu")
    assert rfb.graphs[R - 1].spmm(torch.ones(N, 2), "sum").abs().max() == 0   # empty relation
    model = rgcn_from_flax(c["params"], device="cpu")
    tgt = torch.as_tensor(c["tgt"])
    outs, grads = [], []
    for path in ("full_graph", "full"):
        model.zero_grad()
        x = torch.as_tensor(c["x"]).requires_grad_(True)
        if path == "full_graph":
            out = rfb.to_input_order(model.full_graph(rfb.to_graph_order(x), rfb))
        else:
            out = model.full(x, *map(torch.as_tensor, (c["src"], c["dst"], c["et"])), N)
        ((out - tgt) ** 2).mean().backward()
        outs.append(out.detach())
        grads.append([x.grad] + [p.grad.clone() for p, _ in _flax_pairs(model, c["params"])])
    close(outs[0], c["out"])
    close(grads[0][0], c["g_x"])
    for p, g in zip(grads[0][1:], (g for _, g in _flax_pairs(model, c["g_p"]))):
        close(p, g)
    close(outs[0], outs[1].numpy())
    for a, b in zip(grads[0], grads[1]):
        close(a, b.numpy())


@pytest.mark.parametrize("train", [True, False])
def test_rgcn_full_graph_train_keyword_matches_jax(full_case, train):
    """``RGCN.full_graph(..., train=...)`` takes the JAX package's keyword
    (R-GCN has no dropout, so it changes nothing in either): the output
    matches JAX's ``full_graph`` with the same ``train``."""
    c = full_case
    rfb = RelationalFullBatch(c["src"], c["dst"], c["et"], R, N, block_rows=128, device="cpu")
    model = rgcn_from_flax(c["params"], device="cpu")
    with torch.no_grad():
        out = rfb.to_input_order(model.full_graph(
            rfb.to_graph_order(torch.as_tensor(c["x"])), rfb, train=train))
    j = c["rfb_j"]
    model_j = JaxRGCN(num_relations=R, hidden_features=HID, out_features=OUT)
    want = jax.jit(lambda p, xx: j.to_input_order(model_j.apply(
        p, j.to_graph_order(xx), j, train=train, method=JaxRGCN.full_graph)))(
        c["params"], jnp.asarray(c["x"]))
    close(out, np.asarray(want))
    close(out, c["out"])
