"""The port's distributed example scripts against the JAX package's, on the
CPU: ``multichip_training``, ``hetero_dist_training`` and
``dist_full_batch_training``.

- Data: each JAX script runs until it hands its data to the package (a
  ``DistNeighborLoader``, ``DistFullBatchGraph.from_coo``); the port's
  builder puts the same edges, features and labels into its stores (or gives
  the same edges, features and labels), byte for byte.  The JAX device count
  stays as the test session set it.
- ``main`` with ``--device cpu`` in one gloo world of 2 ranks, spawned once
  for the module (``torch.multiprocessing.spawn``, a ``file://`` store), each
  rank running the three scripts in turn at the JAX example tests' argv:
  the JAX scripts' lines on rank 0, the same global losses on both ranks,
  their gates (the loss falls; the hetero script's assert and ``OK``; the
  full-batch accuracy > 0.8 and ``OK``); and ``multichip_training --devices
  1``, which runs on rank 0 alone (``min(--devices, world size)`` ranks)
  while rank 1 returns None.

The module imports no JAX at the top: the spawned ranks import it.
"""

import contextlib
import io
import logging
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_example_runs import (  # noqa: F401 (one_thread: an autouse fixture)
    TINY_ARGV,
    one_thread,
    recorded,
    run_jax_script,
    same_bytes,
    same_calls,
)

from cugraph_gnn_tpu_torch import train_hetero_dist as THD
from cugraph_gnn_tpu_torch.examples import dist_full_batch_training as DFB
from cugraph_gnn_tpu_torch.examples import hetero_dist_training as HDT
from cugraph_gnn_tpu_torch.examples import multichip_training as MC

CPU = ["--device", "cpu"]
WORLD = 2
SCRIPTS = {"multichip_training": MC, "hetero_dist_training": HDT,
           "dist_full_batch_training": DFB}


# -- data ---------------------------------------------------------------------------


@contextlib.contextmanager
def _device_count_kept():
    import jax

    n = jax.device_count()        # the backend is up before a script can resize it
    yield
    assert jax.device_count() == n


def test_multichip_data_matches_jax():
    import cugraph_gnn_tpu.loader as jl

    with _device_count_kept():
        want = run_jax_script("multichip_training", TINY_ARGV["multichip_training"],
                              [(jl, "DistNeighborLoader")])
    args = MC.parse_args(TINY_ARGV["multichip_training"] + CPU)
    with recorded() as got:
        MC.make_stores(MC.make_data(args), "cpu")
    same_calls(got, want)
    a, kw = want["stop"]
    assert list(a[1]) == MC.FANOUTS and kw["batch_size"] == args.batch_size


def test_hetero_dist_data_matches_jax():
    import cugraph_gnn_tpu.loader as jl

    with _device_count_kept():
        want = run_jax_script("hetero_dist_training", [], [(jl, "DistNeighborLoader")])
    with recorded() as got:
        THD.click_stores(0, "cpu")
    same_calls(got, want)
    a, kw = want["stop"]
    assert tuple(a[1]) == THD.FANOUTS and kw["batch_size"] == THD.BATCH
    assert kw["input_nodes"][0] == "item"
    assert same_bytes(kw["input_nodes"][1], np.arange(THD.N_ITEM))


def test_dist_full_batch_data_matches_jax():
    import cugraph_gnn_tpu.ops as jops

    with _device_count_kept():
        want = run_jax_script("dist_full_batch_training", TINY_ARGV["dist_full_batch_training"],
                              [(jops.DistFullBatchGraph, "from_coo")])
    args = DFB.parse_args(TINY_ARGV["dist_full_batch_training"] + CPU)
    data = DFB.make_data(args)
    a, kw = want["stop"]
    assert same_bytes(data["src"], a[0]) and same_bytes(data["dst"], a[1])
    assert a[2] == args.num_nodes and kw == {"reorder": "auto", "block_rows": DFB.BLOCK_ROWS}
    loc = want["locals"]["main"]
    assert same_bytes(data["labels"], loc["labels"]) and same_bytes(data["x"], loc["x"])


# -- main in a gloo world of 2 ----------------------------------------------------------


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _worker(rank, world, store, out_dir):
    from cugraph_gnn_tpu_torch.utils import distributed as D

    torch.set_num_threads(1)      # the ranks share the CPU cores
    D.init(init_method=f"file://{store}", rank=rank, world_size=world, device="cpu")
    logs = _Records()
    logging.getLogger("cugraph_gnn_tpu_torch").addHandler(logs)
    res = {}
    try:
        runs = [(name, TINY_ARGV[name]) for name in SCRIPTS]
        runs.append(("multichip_training",
                     TINY_ARGV["multichip_training"] + ["--devices", "1"]))
        for i, (name, argv) in enumerate(runs):
            out = io.StringIO()
            del logs.lines[:]
            with contextlib.redirect_stdout(out):
                r = SCRIPTS[name].main(argv + CPU)
            res[i] = (name, r, out.getvalue().splitlines(), list(logs.lines))
    finally:
        D.finalize()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as fh:
        pickle.dump(res, fh)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Per rank, per run: (script, main's return, stdout lines, log lines)."""
    out_dir = tmp_path_factory.mktemp("examples_world2")
    mp.spawn(_worker, args=(WORLD, str(out_dir / "store"), str(out_dir)), nprocs=WORLD,
             join=True)
    out = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def test_multichip_main(ranks):
    name, r0, _, logs = ranks[0][0]
    assert name == "multichip_training" and r0["world"] == WORLD
    assert ranks[1][0][1]["losses"] == r0["losses"]          # the global loss
    steps = [m for m in logs if m.startswith("epoch")]
    assert steps == [f"epoch 0 step {s}: loss {r0['losses'][s]:.4f}" for s in (0, 4)]
    assert logs[-1] == "done (2 devices, 512 nodes, 4096 edges)"
    assert not ranks[1][0][3]                                  # rank 0 logs
    assert r0["losses"][-1] < r0["losses"][0] and len(r0["losses"]) == 8


def test_hetero_dist_main(ranks):
    _, r0, lines, _ = ranks[0][1]
    assert r0["world"] == WORLD and ranks[1][1][1]["losses"] == r0["losses"]
    assert lines == [f"first loss {r0['losses'][0]:.3f} -> last {r0['losses'][-1]:.3f}", "OK"]
    assert ranks[1][1][2] == []


def test_dist_full_batch_main(ranks):
    _, r0, lines, _ = ranks[0][2]
    assert r0["world"] == WORLD and r0["accuracy"] > 0.8
    assert ranks[1][2][1]["accuracy"] == r0["accuracy"]
    assert lines[0] == f"mesh=2 devices, band_fraction={r0['band_fraction']:.2f}"
    assert lines[1:3] == [f"epoch {20 * (i + 1)}: loss {v:.4f}" for i, v in
                          enumerate(r0["losses"])]
    assert lines[3:] == [f"full-batch distributed accuracy: {r0['accuracy']:.3f}", "OK"]
    assert r0["losses"][-1] < r0["losses"][0]


def test_fewer_devices_than_ranks(ranks):
    """``--devices 1`` in a world of 2: rank 0 trains alone, rank 1 sits out."""
    _, r0, _, logs = ranks[0][3]
    assert r0["world"] == 1 and ranks[1][3][1] is None
    assert logs[-1] == "done (1 devices, 512 nodes, 4096 edges)"
    assert r0["losses"][-1] < r0["losses"][0] and len(r0["losses"]) == 8
