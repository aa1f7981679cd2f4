"""Sparse per-row embedding optimizers.

Counterpart of ``cugraph_gnn_tpu/embedding/optimizers.py``: each optimizer
is a plain function of the touched rows, their deduplicated gradients and the
matching rows of its state, returning the updated rows and state.  The
callers (``embedding.DistEmbedding``, ``cached.CachedHostEmbedding``) dedup
the ids, find the rows and write the results back; these functions see dense
(U, F) tensors only and compute in their dtype (float32: the tables and the
state are float32).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """An optimizer's per-row state (name -> width multiplier of the row
    width; 0 for one column) and its hyperparameter defaults."""

    name: str
    state_widths: Dict[str, int]
    hyper_defaults: Dict[str, float]

    def init_state(self, num_rows: int, dim: int, dtype=torch.float32, device=None):
        return {k: torch.zeros((num_rows, dim * w if w > 0 else 1), dtype=dtype, device=device)
                for k, w in self.state_widths.items()}


def sgd_update(rows, grads, state, *, lr, weight_decay=0.0, **_):
    g = grads + weight_decay * rows
    return rows - lr * g, state


def lazy_adam_update(rows, grads, state, *, lr, beta1=0.9, beta2=0.999, epsilon=1e-8,
                     weight_decay=0.0, adam_w=False, **_):
    """Adam whose moments and per-row step count ``t`` (one column) advance
    for the touched rows only; ``adam_w`` decays the rows instead of adding
    the decay to the gradient."""
    m, v, t = state["m"], state["v"], state["t"]
    if adam_w:
        rows = rows * (1.0 - lr * weight_decay)
        g = grads
    else:
        g = grads + weight_decay * rows
    t = t + 1.0
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    m_hat = m / (1.0 - torch.pow(beta1, t))       # (U, 1) bias corrections
    v_hat = v / (1.0 - torch.pow(beta2, t))
    new_rows = rows - lr * m_hat / (torch.sqrt(v_hat) + epsilon)
    return new_rows, {"m": m, "v": v, "t": t}


def adagrad_update(rows, grads, state, *, lr, epsilon=1e-8, weight_decay=0.0, **_):
    g = grads + weight_decay * rows
    h = state["state_sum"] + g * g
    return rows - lr * g / (torch.sqrt(h) + epsilon), {"state_sum": h}


def rmsprop_update(rows, grads, state, *, lr, alpha=0.99, epsilon=1e-8, weight_decay=0.0,
                   **_):
    g = grads + weight_decay * rows
    v = alpha * state["v"] + (1 - alpha) * g * g
    return rows - lr * g / (torch.sqrt(v) + epsilon), {"v": v}


SGD = OptimizerSpec("sgd", {}, {"weight_decay": 0.0})
LAZY_ADAM = OptimizerSpec(
    "lazy_adam", {"m": 1, "v": 1, "t": 0},
    {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "weight_decay": 0.0})
ADAGRAD = OptimizerSpec(
    "adagrad", {"state_sum": 1}, {"epsilon": 1e-8, "weight_decay": 0.0})
RMSPROP = OptimizerSpec(
    "rmsprop", {"v": 1}, {"alpha": 0.99, "epsilon": 1e-8, "weight_decay": 0.0})

UPDATE_FNS = {
    "sgd": sgd_update,
    "lazy_adam": lazy_adam_update,
    "adagrad": adagrad_update,
    "rmsprop": rmsprop_update,
}

SPECS = {s.name: s for s in (SGD, LAZY_ADAM, ADAGRAD, RMSPROP)}
