"""``optimizer_stream_ms.vsharded``: the stream's milliseconds of rank 0's
Adam update and its two clamps over its slab (span
``volrt_torch.optimizer``), the mean per step over the traced window's
first pass (``portbench/spans.py``)."""
from __future__ import annotations

from portbench import spans


def read(ctx) -> float | None:
    return spans.read(ctx, "step", "optimizer", "stream_ms")
