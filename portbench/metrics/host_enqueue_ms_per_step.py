"""``host_enqueue_ms_per_step``: the host's milliseconds to issue one
training step (ray setup, the step kernel, the loss, Adam and the clamp),
up to the loss's readback, the mean over the untraced calls before the
traced window."""
from __future__ import annotations


def read(ctx) -> float | None:
    if ctx.call != "step" or not ctx.host_enqueue_ms:
        return None
    return sum(ctx.host_enqueue_ms) / len(ctx.host_enqueue_ms)
