"""The port's renderer ladder (the counterpart of ``volrt/renderers``).

Rungs 0-1 are torch ops; rungs 2-5 march on hand-written CUDA kernels.
The names are the JAX package's, so that reports of both read alike.
"""
from __future__ import annotations

import importlib

from volrt_torch.constants import RENDERER_COUNT

# Renderer id -> module under volrt_torch.renderers.
_RENDERERS = ("golden", "batched", "nn", "trilinear", "blocked", "fwd_v3")


def get_renderer(renderer_id: int):
    """Return the module for a renderer id (reference ids 0-4
    correspond to CPU, GPU1, GPU2, GPU3, GPU4; 5 is the flagship)."""
    if not 0 <= renderer_id < RENDERER_COUNT:
        raise ValueError(
            f"renderer id {renderer_id} out of range 0..{RENDERER_COUNT - 1}")
    return importlib.import_module(
        f"volrt_torch.renderers.{_RENDERERS[renderer_id]}")


def renderer_name(renderer_id: int) -> str:
    return get_renderer(renderer_id).NAME
