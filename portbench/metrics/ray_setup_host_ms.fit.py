"""``ray_setup_host_ms.fit``: the host's milliseconds in the L2 step's ray
setup (span ``volrt_torch.ray_setup``), the mean per step over the
traced window's first pass (``portbench/spans.py``)."""
from __future__ import annotations

from portbench import spans


def read(ctx) -> float | None:
    return spans.read(ctx, "step", "ray_setup", "host_ms")
