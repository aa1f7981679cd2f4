"""Node-id and label batching for training loops over split files.

Counterpart of ``cugraph_gnn_tpu/utils/data_loader.py`` (the reference's
``create_node_classification_datasets`` and a ``DistributedSampler``-driven
data loader): the train / valid / test splits of a converted dataset, and
per-replica epoch batches of fixed size from a per-epoch seeded
permutation.  Host NumPy: the same seed, epoch and replica give the JAX
package's batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass
class NodeSplit:
    """One split: node ids and their labels, of equal length."""

    idx: np.ndarray
    label: np.ndarray

    def __post_init__(self):
        self.idx = np.asarray(self.idx)
        self.label = np.asarray(self.label)
        if self.idx.shape[0] != self.label.shape[0]:
            raise ValueError("idx/label length mismatch")

    def __len__(self) -> int:
        return int(self.idx.shape[0])


def create_node_classification_datasets(
    data_and_label: Dict[str, np.ndarray],
) -> Tuple[NodeSplit, NodeSplit, NodeSplit]:
    """The train / valid / test splits of a dict with
    ``{train,valid,test}_{idx,label}`` entries (labels as int64)."""
    return tuple(NodeSplit(data_and_label[f"{name}_idx"],
                           np.asarray(data_and_label[f"{name}_label"], dtype=np.int64))
                 for name in ("train", "valid", "test"))


def iterate_batches(
    split: NodeSplit,
    batch_size: int,
    *,
    replica_id: int = 0,
    num_replicas: int = 1,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    epoch: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """This replica's (idx, label) batches for one epoch.

    ``DistributedSampler`` semantics: a permutation seeded by
    ``SeedSequence([seed, epoch])``, wrapped to a multiple of the replica
    count with its own head, dealt round-robin, so that every replica gets a
    disjoint stream of one length.  Every batch has ``batch_size`` rows:
    with ``drop_last=False`` the tail batch wraps to the stream's head.
    """
    if not 0 <= replica_id < num_replicas:
        raise ValueError(f"replica_id {replica_id} not in [0, {num_replicas})")
    n = len(split)
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(n)
    per_replica = -(-n // num_replicas)
    padded = np.concatenate([order, order[: per_replica * num_replicas - n]])
    mine = padded[replica_id::num_replicas]
    nb = len(mine) // batch_size
    for b in range(nb):
        sel = mine[b * batch_size:(b + 1) * batch_size]
        yield split.idx[sel], split.label[sel]
    rem = len(mine) - nb * batch_size
    if rem and not drop_last:
        sel = np.concatenate([mine[nb * batch_size:], mine[: batch_size - rem]])
        yield split.idx[sel], split.label[sel]


def num_batches(split_len: int, batch_size: int, *, num_replicas: int = 1,
                drop_last: bool = True) -> int:
    """Batches a replica gets in an epoch of :func:`iterate_batches`."""
    per_replica = -(-split_len // num_replicas)
    if drop_last:
        return per_replica // batch_size
    return -(-per_replica // batch_size)
