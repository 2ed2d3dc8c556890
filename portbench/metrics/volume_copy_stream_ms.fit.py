"""``volume_copy_stream_ms.fit``: the stream's milliseconds of the step's
bf16 copy of the density (span ``volrt_torch.volume_copy`` in
``diff_v3.l2_loss_grads_v3_onepass``), the mean per step over the traced
window's first pass (``portbench/spans.py``)."""
from __future__ import annotations

from portbench import spans


def read(ctx) -> float | None:
    return spans.read(ctx, "step", "volume_copy", "stream_ms")
