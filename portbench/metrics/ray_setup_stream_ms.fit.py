"""``ray_setup_stream_ms.fit``: the stream's milliseconds between the entry
and the exit of the L2 step's ray setup (span
``volrt_torch.ray_setup``), any wait for the host inside it included,
the mean per step over the traced window's first pass
(``portbench/spans.py``)."""
from __future__ import annotations

from portbench import spans


def read(ctx) -> float | None:
    return spans.read(ctx, "step", "ray_setup", "stream_ms")
