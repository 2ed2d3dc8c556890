"""The port's renderer ladder (the counterpart of ``volrt/renderers``).

Only rung 5, ``pallas-v3``, the flagship forward render, is ported; it runs
on the hand-written CUDA march kernel. Rungs 0-4 are still to come.
"""
from __future__ import annotations

from volrt_torch.constants import RENDERER_COUNT

# Rungs not ported yet, with the ROADMAP item that ports each.
_NOT_PORTED = {
    0: "jax-golden (ROADMAP.md, queue 1: Renderer ladder)",
    1: "xla-batched (ROADMAP.md, queue 1: Renderer ladder)",
    2: "pallas-nn (ROADMAP.md, queue 2, row 4: trilinear._kernel, nearest)",
    3: "pallas-trilinear (ROADMAP.md, queue 2, row 4: trilinear._kernel)",
    4: "pallas-blocked (ROADMAP.md, queue 2, row 5: blocked._kernel)",
}


def get_renderer(renderer_id: int):
    """Return the module for a renderer id."""
    if renderer_id == 5:
        from volrt_torch.renderers import fwd_v3
        return fwd_v3
    if renderer_id in _NOT_PORTED:
        raise NotImplementedError(
            f"renderer {renderer_id} is not ported yet: "
            f"{_NOT_PORTED[renderer_id]}")
    raise ValueError(
        f"renderer id {renderer_id} out of range 0..{RENDERER_COUNT - 1}")


def renderer_name(renderer_id: int) -> str:
    return get_renderer(renderer_id).NAME
