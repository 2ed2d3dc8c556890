"""``frame_ms_p95``: the 95th percentile of every frame of the window, each
timed on the host from the call until its image is synchronised on the
card."""
from __future__ import annotations

from portbench.harness import percentile


def read(win) -> float | None:
    if win.call != "frame" or not win.times:
        return None
    return percentile([t * 1e3 for t in win.times], 95.0)
