"""The device the port's entry points run on when the caller names none."""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda:0``, without probing and without a fallback: the port is
    written for the card, so on a machine that has none the first tensor
    built there raises from torch itself. Callers that want the CPU (the
    tests do) pass ``device="cpu"``."""
    return torch.device("cuda", 0)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the default device."""
    return default_device() if device is None else torch.device(device)
