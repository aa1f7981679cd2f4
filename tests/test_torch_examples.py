"""The port's example scripts, run in-process on the CPU at a tiny size:
``ogbn_convert --synthetic`` writes the files the JAX package's script
writes, byte for byte; ``ogbn_train`` over them and ``node_classification``
on a synthetic graph each train 3 epochs, print (or log) their lines in the
JAX scripts' formats, and end with a lower loss than they started with.
"""

import os
import re
import runpy
import sys

import pytest

from cugraph_gnn_tpu_torch.examples import node_classification, ogbn_convert, ogbn_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = ["--synthetic", "500", "4000", "16", "--parts", "3"]

# the JAX scripts' formats: f"epoch {epoch}: loss {l:.4f}" + f" {name}_acc {a:.4f}",
# "epoch %d: loss %.4f  (%.2fs, %.3fs/iter)" and f"train accuracy: {a:.4f}"
OGBN_LINE = re.compile(r"^epoch (\d+): loss \d+\.\d{4} valid_acc [01]\.\d{4} test_acc [01]\.\d{4}$")
EPOCH_LOG = re.compile(r"^epoch (\d+): loss \d+\.\d{4}  \(\d+\.\d{2}s, \d+\.\d{3}s/iter\)$")
ACC_LINE = re.compile(r"^train accuracy: [01]\.\d{4}$")


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The port's and the JAX script's output directories for one argv."""
    root = tmp_path_factory.mktemp("ogbn")
    ogbn_convert.main(SYNTHETIC + ["--out", str(root / "port")])
    argv, path = sys.argv, list(sys.path)
    sys.argv = ["ogbn_convert.py"] + SYNTHETIC + ["--out", str(root / "jax")]
    try:
        runpy.run_path(os.path.join(REPO, "examples", "ogbn_convert.py"), run_name="__main__")
    finally:
        sys.argv, sys.path[:] = argv, path
    return root


def test_ogbn_convert_matches_jax(converted):
    names = sorted(os.listdir(converted / "jax"))
    assert names == sorted(os.listdir(converted / "port"))
    assert "node_feat_part_2.bin" in names and "meta.json" in names
    for name in names:
        assert (converted / "port" / name).read_bytes() == (converted / "jax" / name).read_bytes(), \
            name


def test_ogbn_train_learns(converted, capsys):
    capsys.readouterr()
    out = ogbn_train.main(["--dir", str(converted / "port"), "--epochs", "3", "--lr", "0.01",
                           "--batch-size", "64", "--hidden-dim", "32", "--neighbors", "4,3",
                           "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    assert [int(OGBN_LINE.match(s).group(1)) for s in lines] == [0, 1, 2]
    losses = [e["loss"] for e in out["epochs"]]
    assert losses[-1] < losses[0]
    assert out["feat_dim"] == 128 and out["num_nodes"] == 500 and out["edges"] == 8000
    assert [e["batches"] for e in out["epochs"]] == [5, 5, 5]   # 300 train nodes


def test_node_classification_learns(caplog, capsys):
    caplog.set_level("INFO", logger="cugraph_gnn_tpu_torch")
    capsys.readouterr()
    out = node_classification.main(
        ["--dataset", "synthetic", "--num-nodes", "600", "--num-edges", "4000",
         "--feat-dim", "12", "--epochs", "3", "--lr", "0.01", "--batch-size", "128",
         "--hidden-dim", "32", "--neighbors", "4,3", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == [f"train accuracy: {out['train_accuracy']:.4f}"]
    msgs = [r.getMessage() for r in caplog.records if r.name == "cugraph_gnn_tpu_torch"]
    epochs = [m for m in msgs if m.startswith("epoch")]
    assert [int(EPOCH_LOG.match(m).group(1)) for m in epochs] == [0, 1, 2]
    assert msgs[0].startswith("prep time: ") and ACC_LINE.match(msgs[-1])
    assert out["losses"][-1] < out["losses"][0] and out["batches"] == 5
