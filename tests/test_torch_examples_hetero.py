"""The port's heterogeneous and knowledge-graph example scripts against the
JAX package's, on the CPU at the JAX example tests' sizes
(``torch_example_runs.TINY_ARGV``): ``rgcn_hetero``, ``hetero_link_pred``
(both modes), ``kg_link_class`` and ``movielens_rec``.

- Data: each JAX script runs until it hands its data to a loader; the
  port's builder on the same argv puts the same typed edges, features,
  labels and edge times into its stores and gives the same positives and
  their times, byte for byte; the KG's relation ids in CSR edge-id order
  are JAX's ``edge_attr_to_csr_order``.
- Glue against flax restatements of the scripts' code, weights carried
  across by ``models/convert.py``, on one port loader batch (f32, within
  1e-5): ``input_features`` + ``to_rel_batches`` + ``RGCN`` with the node
  loss (``rgcn_hetero``) and the link loss and accuracy (``movielens_rec``,
  ``hetero_link_pred``); the disjoint encoder (the flattened batch) against
  JAX's ``vmap`` over the same per-seed arrays; ``KGEncoder`` with the link
  loss and accuracy.  Forward, loss and every gradient.
- ``main`` with ``--device cpu``: the JAX scripts' line formats, and the
  last loss below the first.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from torch_example_runs import (  # noqa: F401 (one_thread: an autouse fixture)
    TINY_ARGV,
    close,
    one_thread,
    recorded,
    run_jax_script,
    same_bytes,
    same_calls,
    same_grads,
    to_jax,
)

from cugraph_gnn_tpu_torch.examples import hetero_link_pred as HL
from cugraph_gnn_tpu_torch.examples import kg_link_class as KG
from cugraph_gnn_tpu_torch.examples import movielens_rec as ML
from cugraph_gnn_tpu_torch.examples import rgcn_hetero as RH
from cugraph_gnn_tpu_torch.examples.common import loader_step
from cugraph_gnn_tpu_torch.models.convert import kg_encoder_from_flax, rgcn_from_flax
from cugraph_gnn_tpu_torch.train_hetero import input_features
from cugraph_gnn_tpu_torch.train_link import link_step

CPU = ["--device", "cpu"]
SCRIPTS = {"rgcn_hetero": RH, "hetero_link_pred": HL, "kg_link_class": KG,
           "movielens_rec": ML}


def _args(name, extra=()):
    return SCRIPTS[name].parse_args(TINY_ARGV[name] + list(extra) + CPU)


def _still(model):
    """An optimizer that leaves the parameters (and their gradients) as
    they are, to read one step's gradients."""
    return torch.optim.SGD(model.parameters(), lr=0.0)


# -- data ---------------------------------------------------------------------------


def _port_calls(name, args):
    mod = SCRIPTS[name]
    data = mod.make_data(args)
    with recorded() as got:
        mod.make_stores(data, "cpu")
    return data, got


def test_rgcn_hetero_data_matches_jax():
    import cugraph_gnn_tpu.loader as jl

    want = run_jax_script("rgcn_hetero", TINY_ARGV["rgcn_hetero"], [(jl, "NeighborLoader")])
    args = _args("rgcn_hetero")
    _, got = _port_calls("rgcn_hetero", args)
    same_calls(got, want)
    kw = want["stop"][1]
    assert kw["input_nodes"][0] == "paper"
    assert same_bytes(kw["input_nodes"][1], np.arange(args.num_papers))
    assert kw["batch_size"] == min(args.batch_size, RH.MAX_BATCH) and kw["num_neighbors"] == \
        RH.FANOUTS


def test_hetero_link_pred_data_matches_jax():
    import cugraph_gnn_tpu.loader as jl

    want = run_jax_script("hetero_link_pred", TINY_ARGV["hetero_link_pred"],
                          [(jl, "LinkNeighborLoader")])
    data, got = _port_calls("hetero_link_pred", _args("hetero_link_pred"))
    same_calls(got, want)
    et, eli = want["stop"][1]["edge_label_index"]
    assert et == HL.WRITES and same_bytes(np.stack(data["writes"]), eli)


def test_kg_data_matches_jax():
    import cugraph_gnn_tpu.loader.link_loader as jll

    want = run_jax_script("kg_link_class", TINY_ARGV["kg_link_class"],
                          [(jll, "LinkNeighborLoader")])
    data, got = _port_calls("kg_link_class", _args("kg_link_class"))
    same_calls(got, want)
    loc = want["locals"]["main"]
    for k in ("src", "dst", "rel"):
        assert same_bytes(data[k], loc[k]), k
    assert same_bytes(np.stack([data["src"], data["dst"]]), want["stop"][1]["edge_label_index"])
    # the relation ids in CSR edge-id order, as the sampled edge ids index them
    jax_rel = want["stores"][0].finalize().edge_attr_to_csr_order(KG.EDGE, loc["rel"])
    port_rel = got["stores"][0].finalize().edge_attr_to_csr_order(KG.EDGE, data["rel"])
    assert same_bytes(port_rel.numpy(), np.asarray(jax_rel))


def test_movielens_data_matches_jax():
    import cugraph_gnn_tpu.loader as jl

    want = run_jax_script("movielens_rec", TINY_ARGV["movielens_rec"],
                          [(jl, "LinkNeighborLoader")])
    data, got = _port_calls("movielens_rec", _args("movielens_rec"))
    same_calls(got, want)
    kw = want["stop"][1]
    assert kw["edge_label_index"][0] == ML.RATES
    assert same_bytes(data["eli"], kw["edge_label_index"][1])
    assert same_bytes(data["elt"], kw["edge_label_time"]) and kw["time_attr"] == "t"
    assert same_bytes(data["rating"], want["locals"]["main"]["rating"])


# -- glue against flax restatements ----------------------------------------------------


def _batch(name, extra=()):
    """(args, stores, one port loader batch) of a hetero script."""
    mod = SCRIPTS[name]
    args = _args(name, extra)
    data = mod.make_data(args)
    fs, gs = mod.make_stores(data, "cpu")
    if name == "rgcn_hetero":
        loader = RH.make_loader(fs, gs, args.num_papers, args.batch_size)
    else:
        loader = mod.make_loader(fs, gs, data, [3, 3], args.batch_size,
                                 *([args.disjoint] if name == "hetero_link_pred" else []))
    return args, gs, next(iter(loader))


def _jax_rel_batches(sample, names):
    import jax.numpy as jnp

    return [[(jnp.asarray(hop[en].neigh_local.numpy()), jnp.asarray(hop[en].mask.numpy()))
             if en in hop else None for en in names]
            for hop in reversed(sample.hops)]


def _jax_link_loss(h, eli, lab, seeds):
    import jax.numpy as jnp
    import optax

    score = jnp.sum(h[eli[0]] * h[eli[1]], axis=-1)
    valid = (seeds[eli[0]] >= 0) & (seeds[eli[1]] >= 0)
    ls = optax.sigmoid_binary_cross_entropy(score, lab)
    loss = jnp.sum(jnp.where(valid, ls, 0)) / jnp.maximum(jnp.sum(valid), 1)
    acc = jnp.sum(jnp.where(valid, ((score > 0) == (lab > 0.5)).astype(jnp.float32), 0)) \
        / jnp.maximum(jnp.sum(valid), 1)
    return loss, acc


@pytest.mark.parametrize("name", ["rgcn_hetero", "movielens_rec", "hetero_link_pred"])
def test_rgcn_path_matches_flax(name):
    """The scripts' ``input_features`` + ``to_rel_batches`` + RGCN, with the
    node loss (``rgcn_hetero``) or the link loss and accuracy."""
    import jax
    import jax.numpy as jnp
    import optax

    from cugraph_gnn_tpu.models import RGCN as JaxRGCN

    args, gs, b = _batch(name)

    def make():
        layers = () if name == "rgcn_hetero" else (2,)
        return SCRIPTS[name].make_model(gs, args.hidden_dim, *layers, "cpu")

    model = make()
    names, convs = model.etype_names, model.rgcn.convs
    jmodel = JaxRGCN(num_relations=len(names), hidden_features=convs[0].lin_root.out_features,
                     out_features=convs[-1].lin_root.out_features, num_layers=2)
    x = jnp.asarray(input_features(b.x).numpy())
    rb = _jax_rel_batches(b.sample, names)
    seeds = jnp.asarray(b.seeds.numpy())
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, rb)
    if name == "rgcn_hetero":
        y = jnp.asarray(b.y.numpy())

        def loss_fn(p):
            logits = jmodel.apply(p, x, rb)
            ls = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            valid = seeds >= 0
            return jnp.sum(jnp.where(valid, ls, 0)) / jnp.maximum(jnp.sum(valid), 1), (logits, 0)
    else:
        eli = jnp.asarray(b.edge_label_index.numpy())
        lab = jnp.asarray(b.edge_label.numpy())

        def loss_fn(p):
            h = jmodel.apply(p, x, rb)
            loss, acc = _jax_link_loss(h, eli, lab, seeds)
            return loss, (h, acc)

    (loss, (out, acc)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    rgcn_from_flax(jax.tree_util.tree_map(np.asarray, params), model.rgcn)
    close(model(b.x, b.sample).detach(), out)
    if name == "rgcn_hetero":
        ploss = loader_step(model, _still(model), b)
    else:
        ploss, pacc = link_step(model, _still(model), b, accuracy=True)
        close(pacc, acc)
    close(ploss, loss)
    want = make()
    rgcn_from_flax(jax.tree_util.tree_map(np.asarray, grads), want.rgcn)
    same_grads(model, want)


def test_disjoint_encoder_matches_vmap():
    """``--disjoint``: the encoder over the flattened disjoint batch against
    JAX's ``vmap`` of the RGCN over the seeds (initialised on seed 0's
    subgraph, as the script does), each seed's row 0; loss, accuracy and
    gradients."""
    import jax
    import jax.numpy as jnp

    from cugraph_gnn_tpu.models import RGCN as JaxRGCN

    args, gs, b = _batch("hetero_link_pred", ["--disjoint"])
    model = HL.make_model(gs, args.hidden_dim, 2, "cpu")
    names = model.etype_names
    jmodel = JaxRGCN(num_relations=len(names), hidden_features=args.hidden_dim,
                     out_features=args.hidden_dim, num_layers=2)
    x = jnp.asarray(input_features(b.x).numpy())             # (B, cap_L, F)
    rb = _jax_rel_batches(b.sample, names)                    # (B, cap_l, k) blocks
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x[0],
                                  jax.tree.map(lambda a: a[0], rb))
    eli = jnp.asarray(b.edge_label_index.numpy())
    lab = jnp.asarray(b.edge_label.numpy())
    seeds = jnp.asarray(b.seeds.numpy())

    def loss_fn(p):
        h = jax.vmap(jmodel.apply, in_axes=(None, 0, 0))(p, x, rb)[:, 0]
        loss, acc = _jax_link_loss(h, eli, lab, seeds)
        return loss, (h, acc)

    (loss, (h, acc)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    rgcn_from_flax(jax.tree_util.tree_map(np.asarray, params), model.rgcn)
    close(model(b.x, b.sample).detach(), h)
    ploss, pacc = HL.train_step(model, _still(model), b)
    close(ploss, loss)
    close(pacc, acc)
    want = HL.make_model(gs, args.hidden_dim, 2, "cpu")
    rgcn_from_flax(jax.tree_util.tree_map(np.asarray, grads), want.rgcn)
    same_grads(model, want)


def test_kg_encoder_matches_flax():
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from cugraph_gnn_tpu.models.conv import RGCNConv as JaxRGCNConv

    args, gs, b = _batch("kg_link_class")
    data = KG.make_data(args)
    rel_csr = gs.finalize().edge_attr_to_csr_order(KG.EDGE, data["rel"])
    n, hidden, n_rel, layers = args.num_entities, args.hidden_dim, args.num_relations, 2

    class KGEncoder(nn.Module):        # examples/kg_link_class.py's, restated
        def setup(self):
            self.node_emb = self.param("node_emb", nn.initializers.xavier_uniform(),
                                       (n, hidden))
            self.convs = [JaxRGCNConv(hidden, num_relations=n_rel, name=f"conv_{i}")
                          for i in range(layers)]

        def __call__(self, batch, rel_by_hop):
            inp = batch.input_nodes
            h = jnp.where((inp >= 0)[:, None], self.node_emb[jnp.clip(inp, 0)], 0)
            num_hops = batch.num_hops
            for li in range(num_hops - 1, -1, -1):
                conv = self.convs[num_hops - 1 - li]
                h = conv.edgewise(batch.dst_activations(h, li), batch.gather_neighbors(h, li),
                                  batch.hops[li].mask, rel_by_hop[li])
                if li != 0:
                    h = nn.relu(h)
            return h

    def j(t):
        return jnp.asarray(t.numpy())

    s = b.sample
    jb = to_jax(s)
    rels = [j(r) for r in KG.relations_of(s, rel_csr)]
    jmodel = KGEncoder()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb, rels)
    eli, lab, seeds = j(b.edge_label_index), j(b.edge_label), j(b.seeds)

    def loss_fn(p):
        z = jmodel.apply(p, jb, rels)
        loss, acc = _jax_link_loss(z, eli, lab, seeds)
        return loss, (z, acc)

    (loss, (z, acc)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = kg_encoder_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    close(model(s, KG.relations_of(s, rel_csr)).detach(), z)
    ploss, pacc = KG.train_step(model, _still(model), b, rel_csr)
    close(ploss, loss)
    close(pacc, acc)
    same_grads(model, kg_encoder_from_flax(jax.tree_util.tree_map(np.asarray, grads),
                                            device="cpu"))


# -- main on the CPU -----------------------------------------------------------------

LINK_LINE = re.compile(r"^epoch (\d+): loss \d+\.\d{4} acc [01]\.\d{3}$")


def _run_main(name, extra=()):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = SCRIPTS[name].main(TINY_ARGV[name] + list(extra) + CPU)
    return res, out.getvalue().splitlines()


def test_rgcn_hetero_main(caplog):
    caplog.set_level("INFO", logger="cugraph_gnn_tpu_torch")
    out, _ = _run_main("rgcn_hetero")
    msgs = [r.getMessage() for r in caplog.records if r.name == "cugraph_gnn_tpu_torch"]
    assert [int(re.match(r"^epoch (\d+): loss \d+\.\d{4}$", m).group(1)) for m in msgs] == [0, 1]
    assert out["losses"][-1] < out["losses"][0] and out["batches"] == 7


@pytest.mark.parametrize("name,extra", [("hetero_link_pred", ()),
                                        ("hetero_link_pred", ("--disjoint",)),
                                        ("kg_link_class", ()), ("movielens_rec", ())],
                         ids=["hetero_link_pred", "hetero_link_pred_disjoint", "kg_link_class",
                              "movielens_rec"])
def test_link_mains(name, extra):
    out, lines = _run_main(name, extra)
    assert [int(LINK_LINE.match(s).group(1)) for s in lines] == [0, 1]
    assert out["losses"][-1] < out["losses"][0]
