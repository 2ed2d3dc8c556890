"""``device_idle_pct.vsharded``: the share of the traced window in which no
operation ran on rank 0's card, in %, where the calls are steps; the
collectives' kernels count as work."""
from __future__ import annotations


def read(ctx) -> float | None:
    if ctx.call != "step" or ctx.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
