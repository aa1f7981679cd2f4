"""The port's homogeneous example scripts against the JAX package's, on the
CPU at the JAX example tests' sizes (``torch_example_runs.TINY_ARGV``):
``fraud_detection``, ``cached_embedding_training``, ``xgb_downstream``,
``full_batch_training`` and ``link_prediction``.

- Data: each JAX script runs until it hands its data to the package (the
  stores, a loader, ``CachedHostEmbedding``, ``FullBatchGraph`` /
  ``RelationalFullBatch``); the port's builder on the same argv gives the
  same edges, features, labels and masks, byte for byte.
- Glue: fraud's ``Encoder`` (masked cross-entropy, ``embed``'s z and fraud
  score) and xgb's train-masked loss, each against a flax restatement of the
  script's own code with the weights carried across by
  ``models/convert.py``, on one port loader batch: forward, loss and every
  gradient within 1e-5 (f32).
- ``main`` with ``--device cpu``: the JAX scripts' line formats and the JAX
  tests' gates (fraud prints "RF with GNN" and the lift line; the logistic
  probe takes the forest's place without scikit-learn; link prediction's
  AUC >= 0.75 on the karate stand-in; the full-batch models' accuracy
  asserts; elsewhere the last loss below the first).
"""

import contextlib
import io
import re
import sys

import numpy as np
import pytest
import torch

from torch_example_runs import (  # noqa: F401 (one_thread: an autouse fixture)
    TINY_ARGV,
    close,
    karate_file,
    one_thread,
    recorded,
    run_jax_script,
    same_bytes,
    same_calls,
    same_grads,
    to_jax,
)

from cugraph_gnn_tpu_torch.examples import cached_embedding_training as CE
from cugraph_gnn_tpu_torch.examples import fraud_detection as FD
from cugraph_gnn_tpu_torch.examples import full_batch_training as FB
from cugraph_gnn_tpu_torch.examples import link_prediction as LP
from cugraph_gnn_tpu_torch.examples import xgb_downstream as XG
from cugraph_gnn_tpu_torch.examples.common import masked_ce
from cugraph_gnn_tpu_torch.loader import NeighborLoader
from cugraph_gnn_tpu_torch.models.convert import fraud_encoder_from_flax, graphsage_from_flax

CPU = ["--device", "cpu"]


def _args(mod, name):
    return mod.parse_args(TINY_ARGV[name] + CPU)


def _run_main(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = mod.main(argv + CPU)
    return res, out.getvalue().splitlines()


# -- data ---------------------------------------------------------------------------


def test_fraud_data_matches_jax():
    import cugraph_gnn_tpu.loader as jl

    want = run_jax_script("fraud_detection", TINY_ARGV["fraud_detection"],
                          [(jl, "NeighborLoader")])
    data = FD.make_data(_args(FD, "fraud_detection"))
    with recorded() as got:
        FD.make_stores(data, "cpu")
    same_calls(got, want)
    loc = want["locals"]["main"]
    for k in ("x", "y", "train_mask", "test_mask"):
        assert same_bytes(data[k], loc[k]), k
    assert same_bytes(want["stop"][1]["input_nodes"],
                      np.nonzero(data["train_mask"])[0].astype(np.int64))


def test_cached_embedding_data_matches_jax():
    import cugraph_gnn_tpu.embedding as je

    want = run_jax_script("cached_embedding_training", TINY_ARGV["cached_embedding_training"],
                          [(je, "CachedHostEmbedding")])
    data = CE.make_data(_args(CE, "cached_embedding_training"))
    loc = want["locals"]["main"]
    assert same_bytes(data["table"], want["stop"][0][0])
    assert same_bytes(data["labels"], loc["labels"])
    assert same_bytes(data["indptr"], loc["indptr"])
    assert same_bytes(data["indices"], loc["indices"])


def test_xgb_data_matches_jax():
    import cugraph_gnn_tpu.loader as jl

    want = run_jax_script("xgb_downstream", TINY_ARGV["xgb_downstream"],
                          [(jl, "NeighborLoader")])
    args = _args(XG, "xgb_downstream")
    data = XG.make_data(args)
    with recorded() as got:
        XG.make_stores(data, "cpu")
    same_calls(got, want)
    train, test = XG.split(args.num_nodes)
    assert same_bytes(train, want["locals"]["main"]["train"])
    assert same_bytes(test, want["locals"]["main"]["test"])
    assert same_bytes(train, want["locals"]["make_embeddings"]["train_mask"])


@pytest.mark.parametrize("model", ["gcn", "rgcn"])
def test_full_batch_data_matches_jax(model):
    import cugraph_gnn_tpu.ops as jops

    stops = [(jops, "RelationalFullBatch")] if model == "rgcn" else \
        [(jops.FullBatchGraph, "from_coo")]
    with karate_file():
        want = run_jax_script("full_batch_training", ["--model", model], stops, stub=True)
        data = FB.make_data(model)
    loc = want["locals"]["main"]
    a = want["stop"][0]
    assert same_bytes(data["src"], a[0]) and same_bytes(data["dst"], a[1])
    assert same_bytes(data["labels"], loc["labels_in"]) and same_bytes(data["x"], loc["x_in"])
    if model == "rgcn":
        assert same_bytes(data["etype"], a[2]) and a[3:] == (2, data["num_nodes"])
    else:
        assert a[2] == data["num_nodes"]


def test_link_prediction_data_matches_jax():
    import cugraph_gnn_tpu.loader.link_loader as jll

    with karate_file():
        want = run_jax_script("link_prediction", TINY_ARGV["link_prediction"],
                              [(jll, "LinkNeighborLoader")])
        data = LP.make_data()
    with recorded() as got:
        LP.make_stores(data, "cpu")
    same_calls(got, want)
    assert same_bytes(np.stack([data["src"], data["dst"]]),
                      want["stop"][1]["edge_label_index"])


# -- glue against flax restatements --------------------------------------------------


def _fraud_batch():
    args = _args(FD, "fraud_detection")
    data = FD.make_data(args)
    fs, gs = FD.make_stores(data, "cpu")
    loader = NeighborLoader((fs, gs), num_neighbors=[8, 8], batch_size=64, shuffle=False,
                            input_nodes=np.nonzero(data["train_mask"])[0][:60])
    return args, next(iter(loader))


def test_fraud_encoder_matches_flax():
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax

    from cugraph_gnn_tpu.models.builder import create_gnn_model

    args, b = _fraud_batch()
    enc = create_gnn_model(args.model, class_count=args.hidden_dim,
                           hidden_feat_dim=args.hidden_dim, num_layers=2, num_heads=args.heads)

    class Encoder(nn.Module):          # examples/fraud_detection.py's, restated
        enc: nn.Module

        @nn.compact
        def __call__(self, xb, sample):
            z = nn.relu(self.enc(xb, sample))
            return z, nn.Dense(2, name="lin")(z)

    model = Encoder(enc)
    jb, xb = to_jax(b.sample), jnp.asarray(b.x.numpy())
    yb, seeds = jnp.asarray(b.y.numpy()), jnp.asarray(b.seeds.numpy())
    params = jax.jit(model.init)(jax.random.PRNGKey(0), xb, jb)

    def loss_fn(pp):
        z, logits = model.apply(pp, xb, jb)
        valid = seeds >= 0
        ls = optax.softmax_cross_entropy_with_integer_labels(logits, yb)
        return jnp.sum(jnp.where(valid, ls, 0)) / jnp.maximum(jnp.sum(valid), 1), (z, logits)

    (loss, (z, logits)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    score = jax.nn.softmax(logits, axis=-1)[:, 1]

    port = fraud_encoder_from_flax(jax.tree_util.tree_map(np.asarray, params), args.model,
                                   device="cpu")
    pz, plogits = port.encode(b.x, b.sample)
    ploss = masked_ce(plogits, b)
    ploss.backward()
    close(pz.detach(), z)
    close(plogits.detach(), logits)
    close(ploss.detach(), loss)
    same_grads(port, fraud_encoder_from_flax(jax.tree_util.tree_map(np.asarray, grads),
                                              args.model, device="cpu"))
    ez, escore = FD.embed(port, b.x, b.sample)
    close(ez, z)
    close(escore, score)


def test_xgb_loss_matches_flax():
    import jax
    import jax.numpy as jnp
    import optax

    from cugraph_gnn_tpu.models import GraphSAGE as JaxGraphSAGE

    args = _args(XG, "xgb_downstream")
    fs, gs = XG.make_stores(XG.make_data(args), "cpu")
    train, _ = XG.split(args.num_nodes)
    b = next(iter(NeighborLoader((fs, gs), num_neighbors=XG.FANOUTS, batch_size=256)))
    model = JaxGraphSAGE(hidden_features=args.hidden_dim, out_features=args.num_classes,
                         num_layers=2)
    jb, xb = to_jax(b.sample), jnp.asarray(b.x.numpy())
    yb, seeds = jnp.asarray(b.y.numpy()), jnp.asarray(b.seeds.numpy())
    mask = jnp.asarray(train)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), xb, jb)

    def loss_fn(p):                     # examples/xgb_downstream.py's step, restated
        logits = model.apply(p, xb, jb)
        valid = (seeds >= 0) & mask[jnp.maximum(seeds, 0)]
        ls = optax.softmax_cross_entropy_with_integer_labels(logits, yb)
        return jnp.sum(jnp.where(valid, ls, 0)) / jnp.maximum(jnp.sum(valid), 1)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    port = graphsage_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    ploss = masked_ce(port(b.x, b.sample), b, torch.as_tensor(train))
    ploss.backward()
    close(ploss.detach(), loss)
    same_grads(port, graphsage_from_flax(jax.tree_util.tree_map(np.asarray, grads),
                                          device="cpu"))


# -- main on the CPU -----------------------------------------------------------------

EPOCH = re.compile(r"^epoch \d+: loss \d+\.\d{4}$")
LIFT = re.compile(r"^gnn-embedding lift: acc [+-]\d\.\d{4} auc [+-]\d\.\d{4}$")


def test_fraud_main():
    out, lines = _run_main(FD, TINY_ARGV["fraud_detection"])
    assert [s for s in lines if s.startswith("epoch")] == \
        [s for s in lines if EPOCH.match(s)] and len(out["losses"]) == 4
    for name in ("RF with GNN", "GNN Only", "RF Only"):
        assert f"=== {name} ===" in lines
    assert LIFT.match(lines[-1]), lines[-1]
    assert out["downstream"] == "random_forest"
    assert "downstream model: random forest (scikit-learn)" in lines
    assert out["losses"][-1] < out["losses"][0]
    assert out["export_batches"] == 13      # 800 nodes, batch 64


def test_fraud_probe_without_sklearn(monkeypatch):
    """Without scikit-learn the logistic probe fits the same design matrix,
    and the output says so."""
    monkeypatch.setitem(sys.modules, "sklearn.ensemble", None)
    out, lines = _run_main(FD, ["--num-nodes", "300", "--epochs", "1", "--batch-size", "64",
                                "--neighbors", "4,4", "--hidden-dim", "16"])
    assert out["downstream"] == "logistic_probe"
    assert "downstream model: logistic probe (scikit-learn is not installed)" in lines
    assert "=== RF with GNN ===" in lines and LIFT.match(lines[-1])


def test_logistic_probe_matches_sklearn():
    """The probe is scikit-learn's default ``LogisticRegression`` on
    standardised columns: probabilities within 1e-3."""
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(0)
    x = rng.standard_normal((400, 6)) * [1, 2, 3, 4, 5, 6] + 1.0
    y = (x[:, 0] + 0.3 * x[:, 1] + rng.standard_normal(400) > 1).astype(np.int64)
    probe = FD.LogisticProbe().fit(x, y)
    z = (x - x.mean(0)) / x.std(0, ddof=1)
    ref = LogisticRegression(max_iter=200, tol=1e-8).fit(z, y)
    np.testing.assert_allclose(probe.predict_proba(x), ref.predict_proba(z), atol=1e-3)


def test_cached_embedding_main():
    out, lines = _run_main(CE, TINY_ARGV["cached_embedding_training"])
    assert len(lines) == 2 and all(
        re.match(r"^epoch \d: loss \d+\.\d{4} cache hit rate [01]\.\d{2}$", s) for s in lines)
    assert out["losses"][-1] < out["losses"][0] and out["steps_per_epoch"] == 31


def test_xgb_main():
    out, lines = _run_main(XG, TINY_ARGV["xgb_downstream"])
    assert lines[0] == "embeddings: (600, 20), classes: 4"
    assert lines[1] == "Training hist-GBT model..."
    assert all(re.match(rf"^{n}: mlogloss \d+\.\d{{4}} acc [01]\.\d{{4}}$", s)
               for n, s in zip(("train", "test"), lines[2:]))
    assert out["losses"][-1] < out["losses"][0]


@pytest.mark.parametrize("model", ["gcn", "sage", "gat", "rgcn"])
def test_full_batch_main(model):
    argv = ["--model", model] + ([] if model in ("gcn", "sage") else ["--epochs", "40"])
    with karate_file():
        out, lines = _run_main(FB, argv)
    assert lines[-1] == "OK" and out["accuracy"] > 0.9
    assert re.match(rf"^full-batch {model} accuracy: [01]\.\d{{3}} \(band fraction "
                    rf"[01]\.\d{{2}}\)$", lines[-2])
    assert all(re.match(r"^epoch \d+: loss \d+\.\d{4}$", s) for s in lines[:-2])
    assert out["losses"][-1] < out["losses"][0]


def test_link_prediction_main():
    with karate_file():
        out, lines = _run_main(LP, TINY_ARGV["link_prediction"])
    m = re.match(r"^link-pred AUC: ([0-9.]+)$", lines[-1])
    assert m and float(m.group(1)) >= 0.75, lines
    assert out["losses"][-1] < out["losses"][0]
