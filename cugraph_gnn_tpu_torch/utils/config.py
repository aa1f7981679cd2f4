"""Shared argparse option groups for the examples.

Counterpart of ``cugraph_gnn_tpu/utils/config.py``, with the same groups,
flags and defaults, so that a command line means the same in both packages:
training, graph, model and sampler options, ``parse_fanouts`` for the
comma-separated per-hop fanouts, and ``make_parser``.
"""

from __future__ import annotations

import argparse
from typing import List


def add_training_options(p: argparse.ArgumentParser):
    g = p.add_argument_group("training")
    g.add_argument("--epochs", type=int, default=10)
    g.add_argument("--lr", type=float, default=0.003)
    g.add_argument("--batch-size", type=int, default=1024)
    g.add_argument("--embedding-dim", type=int, default=128)
    g.add_argument("--log-level", default="info",
                   choices=["fatal", "error", "warn", "info", "debug", "trace"])
    g.add_argument("--optimizer", default="adam")
    g.add_argument("--emb-optimizer", default="lazy_adam",
                   choices=["sgd", "lazy_adam", "adagrad", "rmsprop"])


def add_graph_options(p: argparse.ArgumentParser):
    g = p.add_argument_group("graph")
    g.add_argument("--root-dir", default=".")
    g.add_argument("--feat-dim", type=int, default=100)
    g.add_argument("--dataset", default="karate")


def add_model_options(p: argparse.ArgumentParser):
    g = p.add_argument_group("model")
    g.add_argument("--model", default="sage",
                   choices=["sage", "gcn", "gat", "gin", "rgcn"])
    g.add_argument("--hidden-dim", type=int, default=256)
    g.add_argument("--num-layers", type=int, default=2)
    g.add_argument("--heads", type=int, default=4)


def add_sampler_options(p: argparse.ArgumentParser):
    g = p.add_argument_group("sampler")
    g.add_argument("--neighbors", default="10,10",
                   help="comma-separated per-hop fanouts, seed-side first")


def parse_fanouts(s: str) -> List[int]:
    """"10,10" -> [10, 10]; empty items are skipped."""
    return [int(x) for x in s.split(",") if x.strip()]


def make_parser(*groups) -> argparse.ArgumentParser:
    """A parser with the given option groups (default: all four)."""
    p = argparse.ArgumentParser()
    for add in groups or (add_training_options, add_graph_options,
                          add_model_options, add_sampler_options):
        add(p)
    return p
