"""``host_enqueue_ms_per_frame``: the host's milliseconds to issue one
frame (ray setup, the leap, the march, the quantisation), up to the
synchronise, the mean over the untraced calls before the traced window."""
from __future__ import annotations


def read(ctx) -> float | None:
    if ctx.call != "frame" or not ctx.host_enqueue_ms:
        return None
    return sum(ctx.host_enqueue_ms) / len(ctx.host_enqueue_ms)
