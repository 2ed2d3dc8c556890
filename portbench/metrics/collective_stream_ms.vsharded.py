"""``collective_stream_ms.vsharded``: the stream's milliseconds of rank 0's
collectives in a step (span ``volrt_torch.collective``: the halo edges'
and planes' ``all_gather``, the opacity scan's two, the segments' and the
TF gradient's ``all_reduce``), summed over the step: each holds its wait
for the slowest rank. The mean per step over the traced window's first
pass (``portbench/spans.py``)."""
from __future__ import annotations

from portbench import spans


def read(ctx) -> float | None:
    return spans.read(ctx, "step", "collective", "stream_ms")
