"""``ray_setup_host_ms.view``: the host's milliseconds in the program's ray
setup (span ``volrt_torch.ray_setup``), the mean per frame over the
traced window's first pass (``portbench/spans.py``)."""
from __future__ import annotations

from portbench import spans


def read(ctx) -> float | None:
    return spans.read(ctx, "frame", "ray_setup", "host_ms")
