"""``volume_copy_stream_ms.view``: the stream's milliseconds of the frame's
copy of the uint8 volume to f32 (span ``volrt_torch.volume_copy``:
``fwd_v3.march_args``, ``trilinear.render_float``), the mean per frame
over the traced window's first pass (``portbench/spans.py``)."""
from __future__ import annotations

from portbench import spans


def read(ctx) -> float | None:
    return spans.read(ctx, "frame", "volume_copy", "stream_ms")
