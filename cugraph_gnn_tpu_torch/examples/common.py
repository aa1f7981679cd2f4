"""The training and evaluation steps that the example scripts share."""

from __future__ import annotations

import torch
from torch.nn import functional as F


def loader_step(model, optimizer, batch) -> torch.Tensor:
    """One optimizer step on a loader batch: the mean softmax cross-entropy
    of the valid (non -1) seeds against the batch's labels.  Returns the
    loss (f32, on the device, not synchronised)."""
    optimizer.zero_grad(set_to_none=True)
    valid = batch.seeds >= 0
    logits = model(batch.x, batch.sample).float()
    ls = F.cross_entropy(logits, torch.where(valid, batch.y, 0).long(), reduction="none")
    loss = torch.where(valid, ls, 0).sum() / valid.sum().clamp(min=1)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def accuracy(model, loader) -> float:
    """The share of the loader's valid seeds whose argmax logit is their
    label (one host read at the end)."""
    hits = total = 0
    for b in loader:
        valid = b.seeds >= 0
        hits = hits + ((model(b.x, b.sample).argmax(-1) == b.y) & valid).sum()
        total = total + valid.sum()
    return float(hits) / max(int(total), 1)
