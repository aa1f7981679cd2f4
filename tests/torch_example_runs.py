"""Helpers of the example-script tests (``test_torch_examples_*.py`` and the
card test in ``test_torch_kernels_cuda.py``).

- ``TINY_ARGV``: each script's small command line (the JAX package's
  ``tests/test_examples.py`` argv; two epochs where that has one, so that a
  loss can fall).
- ``karate_file``: ``chip_smoke.karate_standin``, the karate-format
  stand-in that the smoke's full-batch and link runs read, for both
  packages' ``load_karate`` while the context is open; the file is deleted
  afterwards.
- ``run_jax_script``: runs ``examples/<name>.py`` of the JAX package as
  ``__main__`` until it hands its data to a package name that the test
  patched to stop it, recording what the script passed to the stores on the
  way.  No jitted function runs, and nothing in the JAX package changes.
- ``recorded``: the same recording around the port's data builders.
- ``close``, ``same_grads`` and ``to_jax``: the glue tests' f32 comparison
  (within 1e-5), their gradient check against a JAX gradient tree carried
  across by a converter, and a port batch as the JAX package's.
- ``one_thread``: an autouse fixture (imported by the test modules) that
  runs each test with one torch intra-op thread.  The scripts run many
  small ops; when the suite's workers share the cores, torch's spinning
  thread pool makes a ``main`` many times slower (hetero link prediction
  took 103.6 s under 6 pytest workers, against 1.2 s alone).

This module imports no JAX at the top: the card's machine, which has none,
imports it for ``TINY_ARGV``.
"""

import contextlib
import os
import runpy
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_ARGV = {
    "fraud_detection": ["--num-nodes", "800", "--epochs", "4", "--batch-size", "64",
                        "--neighbors", "8,8", "--hidden-dim", "32"],
    "cached_embedding_training": ["--epochs", "2", "--batch-size", "32", "--num-nodes", "1000",
                                  "--num-edges", "5000", "--neighbors", "3,3"],
    "rgcn_hetero": ["--epochs", "2", "--batch-size", "32", "--num-papers", "200",
                    "--num-authors", "100", "--num-insts", "20"],
    "hetero_link_pred": ["--epochs", "2", "--batch-size", "16", "--num-papers", "200",
                         "--num-authors", "100", "--num-writes", "600", "--neighbors", "3,3"],
    "kg_link_class": ["--epochs", "2", "--batch-size", "64", "--neighbors", "3,3",
                      "--num-entities", "300", "--num-edges", "1500"],
    "movielens_rec": ["--epochs", "2", "--batch-size", "64", "--neighbors", "3,3",
                      "--num-users", "150", "--num-movies", "200", "--num-ratings", "1500"],
    "multichip_training": ["--devices", "8", "--epochs", "1", "--num-nodes", "512",
                           "--num-edges", "4096", "--batch-size", "64"],
    "hetero_dist_training": [],
    "dist_full_batch_training": ["--devices", "8", "--epochs", "40", "--num-nodes", "1024",
                                 "--band", "100"],
    "xgb_downstream": ["--num_nodes", "600", "--epochs", "1", "--hidden_dim", "16",
                       "--num_boost_round", "3"],
    "full_batch_training": [],
    "link_prediction": ["--epochs", "12", "--batch-size", "32", "--neighbors", "5,5"],
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def karate_file():
    """Point both packages' ``load_karate`` at a karate-format stand-in."""
    from chip_smoke import karate_standin

    jax_ds = sys.modules.get("cugraph_gnn_tpu.utils.datasets")
    jax_load = jax_ds.load_karate if jax_ds is not None else None
    with karate_standin() as path:
        try:
            if jax_ds is not None:
                jax_ds.load_karate = lambda p=None: jax_load(p or path)
            yield path
        finally:
            if jax_ds is not None:
                jax_ds.load_karate = jax_load


class Stop(Exception):
    """Raised by a patched name: the script has handed over its data."""


class _Stub:
    """What a patched constructor returns when the script must run on a
    little: any use of it stops the script."""

    def __getattr__(self, name):
        raise Stop(name)


@contextlib.contextmanager
def _patched(patches):
    saved = [(obj, name, obj.__dict__[name]) for obj, name, _ in patches]
    try:
        for obj, name, new in patches:
            setattr(obj, name, new)
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)


def _recorders(gs_cls, fs_cls, calls):
    put, setitem = gs_cls.put_edge_index, fs_cls.__setitem__

    def put_edge_index(self, edge_index, edge_type, *a, **kw):
        calls["edges"].append((tuple(edge_type), tuple(np.asarray(e) for e in edge_index),
                               kw.get("num_nodes")))
        if not any(g is self for g in calls["stores"]):
            calls["stores"].append(self)
        return put(self, edge_index, edge_type, *a, **kw)

    def item(self, key, value):
        calls["features"].append((key, np.asarray(value)))
        return setitem(self, key, value)

    return [(gs_cls, "put_edge_index", put_edge_index), (fs_cls, "__setitem__", item)]


def _new_calls():
    return {"edges": [], "features": [], "stop": None, "stores": []}


@contextlib.contextmanager
def recorded():
    """Record the port's ``put_edge_index`` and feature-store item calls."""
    from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore

    calls = _new_calls()
    with _patched(_recorders(GraphStore, FeatureStore, calls)):
        yield calls


def run_jax_script(name, argv, stops, stub=False):
    """Run ``examples/<name>.py`` with ``argv`` until it calls one of
    ``stops`` ((object, attribute) pairs).  Returns the recorded calls:
    ``edges`` (edge type, (src, dst), num_nodes), ``features`` (key,
    array), ``stores`` (the graph stores filled), ``stop`` (the stopping
    call's args and kwargs) and ``locals``, the local variables of each of
    the script's frames by function name.
    ``stub``: the stopping call returns a stub and the script stops at its
    first use (for scripts that draw more data after that call)."""
    from cugraph_gnn_tpu.data import FeatureStore, GraphStore

    calls = _new_calls()

    def stopper(*a, **kw):
        calls["stop"] = (a, kw)
        if stub:
            return _Stub()
        raise Stop()

    patches = _recorders(GraphStore, FeatureStore, calls)
    patches += [(obj, attr, classmethod(lambda cls, *a, **kw: stopper(*a, **kw))
                 if isinstance(obj.__dict__[attr], classmethod) else stopper)
                for obj, attr in stops]
    script = os.path.join(REPO, "examples", f"{name}.py")
    argv0, path0 = sys.argv, list(sys.path)
    sys.argv = [script] + list(argv)
    try:
        with _patched(patches):
            runpy.run_path(script, run_name="__main__")
    except Stop as e:
        tb, frames = e.__traceback__, {}
        while tb is not None:
            if tb.tb_frame.f_code.co_filename == script:
                frames[tb.tb_frame.f_code.co_name] = dict(tb.tb_frame.f_locals)
            tb = tb.tb_next
        calls["locals"] = frames
    else:
        raise AssertionError(f"{name} ran to its end without reaching a stop")
    finally:
        sys.argv, sys.path[:] = argv0, path0
    return calls


def same_bytes(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def same_calls(got, want) -> None:
    """The port's recorded store calls are the script's, byte for byte."""
    assert [e[0] for e in got["edges"]] == [e[0] for e in want["edges"]]
    for g, w in zip(got["edges"], want["edges"]):
        assert g[2] == w[2], (g[0], g[2], w[2])
        assert all(same_bytes(a, b) for a, b in zip(g[1], w[1])), g[0]
    assert [k for k, _ in got["features"]] == [k for k, _ in want["features"]]
    for (k, g), (_, w) in zip(got["features"], want["features"]):
        assert same_bytes(g, w), k


TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want) -> None:
    torch.testing.assert_close(torch.as_tensor(np.array(got)).float(),
                               torch.as_tensor(np.array(want)).float(), **TOL)


def same_grads(model, want_model) -> None:
    """Every parameter's gradient (zero where it has none) equals what
    ``want_model`` holds as weights: a JAX gradient tree carried across by
    the converter that carried the weights."""
    for (name, p), (_, w) in zip(model.named_parameters(), want_model.named_parameters()):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(g, w.detach(), **TOL, msg=name)


def to_jax(sample):
    """A port ``MultihopBatch`` as the JAX package's."""
    import jax.numpy as jnp

    from cugraph_gnn_tpu.sampler import output as jax_out

    def j(t):
        return jnp.asarray(t.numpy())

    return jax_out.MultihopBatch(
        levels=[j(a) for a in sample.levels], level_counts=[j(a) for a in sample.level_counts],
        hops=[jax_out.HopBlock(j(h.neigh_local), j(h.neigh_global), j(h.edge_ids))
              for h in sample.hops],
        seed_count=j(sample.seed_count), static_layout=sample.static_layout)
