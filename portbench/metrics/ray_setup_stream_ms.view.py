"""``ray_setup_stream_ms.view``: the stream's milliseconds between the
entry and the exit of the program's ray setup (span
``volrt_torch.ray_setup``: the rays, the cube's slab test, the ESL leap,
the kernels' scalars), any wait for the host inside it included, the
mean per frame over the traced window's first pass
(``portbench/spans.py``)."""
from __future__ import annotations

from portbench import spans


def read(ctx) -> float | None:
    return spans.read(ctx, "frame", "ray_setup", "stream_ms")
