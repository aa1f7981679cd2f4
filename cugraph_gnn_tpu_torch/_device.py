"""Where an entry point runs."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` when the caller names one, else the card.

    Raises when no device is named and there is no CUDA device, so that an
    entry point never runs on the CPU unless asked to.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")
