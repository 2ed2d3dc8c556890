"""``optimizer_stream_ms.fit``: the stream's milliseconds of the trainer's
Adam update and its two clamps (span ``volrt_torch.optimizer``), any
wait for the host inside it included, the mean per step over the traced
window's first pass (``portbench/spans.py``)."""
from __future__ import annotations

from portbench import spans


def read(ctx) -> float | None:
    return spans.read(ctx, "step", "optimizer", "stream_ms")
