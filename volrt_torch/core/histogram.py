"""Display histogram of a volume (reference: ModelBase.cpp:19-33), the
counterpart of ``volrt/core/histogram.py``."""
from __future__ import annotations

import numpy as np

from volrt_torch import native


def compute_histogram(data: np.ndarray) -> np.ndarray:
    """Fourth-root-compressed, max-normalized 256-bin histogram of a uint8
    volume, ``f32[256]``, counted by the host library (``native.histogram``).

    Matches ``ModelBase::compute_histogram``: ``sqrt(sqrt(count))`` then
    normalize by the maximum (reference: ModelBase.cpp:19-33).
    """
    counts = native.histogram(np.asarray(data, np.uint8))
    hist = np.sqrt(np.sqrt(counts.astype(np.float32)))
    max_value = hist.max()
    if max_value > 0:
        hist = hist / max_value
    return hist
