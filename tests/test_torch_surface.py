"""Port parity of the package surface: every subpackage's ``__all__`` and
the version equal the JAX package's; the argparse groups parse the same
command lines into equal namespaces; the log levels; ``uniform_sample_np``
on the JAX draws gives JAX's result (exact); the doctor on the CPU, and its
refusal without a card.
"""

import importlib
import logging

import numpy as np
import pytest
import torch

from cugraph_gnn_tpu_torch import doctor
from cugraph_gnn_tpu_torch.utils import config, logging as plog

SUBPACKAGES = ["", ".ops", ".sampler", ".models", ".utils"]


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "root")
def test_all_matches_jax(sub):
    port = importlib.import_module(f"cugraph_gnn_tpu_torch{sub}")
    jax_pkg = importlib.import_module(f"cugraph_gnn_tpu{sub}")
    assert port.__all__ == jax_pkg.__all__
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_version_matches_jax():
    import cugraph_gnn_tpu
    import cugraph_gnn_tpu_torch

    assert cugraph_gnn_tpu_torch.__version__ == cugraph_gnn_tpu.__version__


ARGVS = [
    [],
    ["--epochs", "3", "--lr", "0.01", "--batch-size", "64", "--log-level", "trace"],
    ["--model", "gat", "--heads", "8", "--hidden-dim", "32", "--num-layers", "3"],
    ["--neighbors", "15,10,5", "--dataset", "synthetic", "--feat-dim", "16",
     "--root-dir", "/data", "--emb-optimizer", "adagrad", "--optimizer", "sgd",
     "--embedding-dim", "64"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parsers_match_jax(argv):
    from cugraph_gnn_tpu.utils import config as jconfig

    assert config.make_parser().parse_args(argv) == jconfig.make_parser().parse_args(argv)


def test_group_subsets_match_jax():
    from cugraph_gnn_tpu.utils import config as jconfig

    groups = ("add_training_options", "add_sampler_options")
    port = config.make_parser(*(getattr(config, g) for g in groups))
    jax_p = jconfig.make_parser(*(getattr(jconfig, g) for g in groups))
    argv = ["--epochs", "2", "--neighbors", "5,5"]
    assert port.parse_args(argv) == jax_p.parse_args(argv)
    assert not hasattr(port.parse_args([]), "model")
    assert config.parse_fanouts("10, 5,,3") == jconfig.parse_fanouts("10, 5,,3") == [10, 5, 3]


def test_parser_refuses_what_jax_refuses():
    for argv in (["--model", "mlp"], ["--log-level", "loud"], ["--emb-optimizer", "adam"]):
        with pytest.raises(SystemExit):
            config.make_parser().parse_args(argv)


def test_log_levels_match_jax():
    from cugraph_gnn_tpu.utils import logging as jlog

    assert plog.LEVELS == jlog.LEVELS
    assert logging.getLevelName(plog.LEVELS["trace"]) == "TRACE"
    log = plog.get_logger()
    assert log.name == "cugraph_gnn_tpu_torch" and log is not jlog.get_logger()
    level = log.level
    try:
        plog.set_log_level("DEBUG")
        assert log.level == logging.DEBUG and len(log.handlers) == 1
        plog.set_log_level("warn")
        assert log.level == logging.WARNING and len(log.handlers) == 1
    finally:
        log.setLevel(level)


def test_uniform_sample_np_matches_jax():
    """The JAX function's own draw, passed in: the same neighbors and edge
    ids, with -1 seeds, low-degree seeds and a hub."""
    import jax

    from cugraph_gnn_tpu.sampler import uniform_sample_np as jax_np
    from cugraph_gnn_tpu_torch.sampler import uniform_sample_np

    rng = np.random.default_rng(5)
    deg = rng.integers(0, 12, 40)
    deg[7] = 300
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, 40, int(indptr[-1])).astype(np.int32)
    seeds = rng.integers(-1, 40, 64).astype(np.int32)
    seeds[:3] = (7, -1, 0)
    for fanout in (1, 5):
        key = jax.random.PRNGKey(fanout)
        u = np.asarray(jax.random.uniform(key, (len(seeds), fanout)))
        got = uniform_sample_np(u, indptr, indices, seeds, fanout)
        want = jax_np(key, indptr, indices, seeds, fanout)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_doctor_passes_on_cpu(capsys):
    with pytest.warns(UserWarning, match="targets an NVIDIA H100"):
        report = doctor.smoke_check(device="cpu")
    assert report["sample_op"] == "ok" and report["platform"] == "cpu"
    assert report["num_devices"] == 1 and report["version"] == "0.1.0"
    assert report["sample_kernel_launches"] == 0
    with pytest.warns(UserWarning):
        doctor.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "version: 0.1.0"
    assert out[-1] == "cugraph_gnn_tpu_torch doctor: all checks passed"


def test_doctor_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        doctor.smoke_check()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        doctor.main([])
