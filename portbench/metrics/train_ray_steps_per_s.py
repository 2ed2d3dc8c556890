"""``train_ray_steps_per_s``: the training steps completed in the window,
times the rays of a step and ``int(2 / ray_step)`` samples a ray (volrt's
accounting), over the window's wall seconds."""
from __future__ import annotations


def read(win) -> float | None:
    if win.call != "step" or win.calls == 0:
        return None
    return win.calls * win.n_rays * win.ray_steps / win.seconds
