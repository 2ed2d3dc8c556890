"""``optimizer_host_ms.fit``: the host's milliseconds in the trainer's Adam
update and its two clamps (span ``volrt_torch.optimizer``), the mean per
step over the traced window's first pass (``portbench/spans.py``)."""
from __future__ import annotations

from portbench import spans


def read(ctx) -> float | None:
    return spans.read(ctx, "step", "optimizer", "host_ms")
