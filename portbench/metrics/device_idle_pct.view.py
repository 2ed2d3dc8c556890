"""``device_idle_pct.view``: the share of the traced window in which no
operation ran on the card, in %, where the calls are frames."""
from __future__ import annotations


def read(ctx) -> float | None:
    if ctx.call != "frame" or ctx.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
