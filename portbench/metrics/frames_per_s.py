"""``frames_per_s``: the frames completed in the window over its wall
seconds."""
from __future__ import annotations


def read(win) -> float | None:
    if win.call != "frame" or win.calls == 0:
        return None
    return win.calls / win.seconds
