"""Link prediction training: the step and the AUC pass of
``examples/link_prediction.py``.

``link_step`` is the example's jitted step on a ``LinkBatch``: node
embeddings from the model, dot-product scores over ``edge_label_index``,
sigmoid binary cross-entropy against ``edge_label``, averaged over the pairs
whose two seeds are real (-1 seeds are padding), backward, optimizer update.
``link_auc`` is the example's rank AUC of positives against negatives (the
fraud example's too: a stable sort, nan on an empty class).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F


def link_logits(emb: torch.Tensor, batch):
    """(scores (B+N,), valid (B+N,)): the dot product of each labelled pair's
    embeddings, and whether both of its seeds are real."""
    eli = batch.edge_label_index.long()
    score = (emb[eli[0]] * emb[eli[1]]).sum(dim=-1)
    valid = (batch.seeds[eli[0]] >= 0) & (batch.seeds[eli[1]] >= 0)
    return score, valid


def link_loss(emb: torch.Tensor, batch) -> torch.Tensor:
    """Mean sigmoid cross-entropy over the valid pairs (float32)."""
    score, valid = link_logits(emb, batch)
    ls = F.binary_cross_entropy_with_logits(score.float(), batch.edge_label.float(),
                                            reduction="none")
    return torch.where(valid, ls, 0).sum() / valid.sum().clamp(min=1)


def link_accuracy(emb: torch.Tensor, batch) -> torch.Tensor:
    """The share of the valid pairs whose score's sign is their label."""
    score, valid = link_logits(emb, batch)
    hit = (score > 0) == (batch.edge_label > 0.5)
    return torch.where(valid, hit.float(), 0).sum() / valid.sum().clamp(min=1)


def link_step(model, optimizer, batch, embed=None, accuracy: bool = False):
    """One step on a ``LinkBatch``: node embeddings ``embed(batch)``
    (default ``model(batch.x, batch.sample)``), ``link_loss``, backward,
    optimizer update.  Returns the loss (float32, on the device, not
    synchronised), or (loss, ``link_accuracy`` of the step's forward) with
    ``accuracy``.  The parameters' ``.grad`` hold its gradients."""
    optimizer.zero_grad(set_to_none=True)
    emb = embed(batch) if embed is not None else model(batch.x, batch.sample)
    loss = link_loss(emb, batch)
    loss.backward()
    optimizer.step()
    if accuracy:
        return loss.detach(), link_accuracy(emb.detach(), batch)
    return loss.detach()


@torch.no_grad()
def link_eval_scores(model, batch):
    """Host (scores, labels) of one batch's valid pairs, for ``link_auc``."""
    score, valid = link_logits(model(batch.x, batch.sample), batch)
    return (score.float()[valid].cpu().numpy(),
            batch.edge_label.float()[valid].cpu().numpy())


def link_auc(scores, labels) -> float:
    """Rank AUC of the positives (label > 0.5) against the rest, ties ranked
    in input order (a stable sort); nan with no positive or no negative."""
    s = np.asarray(scores)
    lab = np.asarray(labels, np.float64)
    order = np.argsort(s, kind="stable")
    rank = np.empty_like(order, dtype=np.float64)
    rank[order] = np.arange(1, len(s) + 1)
    n_pos, n_neg = int(lab.sum()), int((1 - lab).sum())
    if not (n_pos and n_neg):
        return float("nan")
    return float((rank[lab > 0.5].sum() - n_pos * (n_pos + 1) / 2) / max(n_pos * n_neg, 1))
