"""The round-1 differentiable render on the card, second pair: the
counterpart of ``volrt/renderers/pallas/diff_blocked.py`` at the level of
``render_tiles_diff_blocked``.

The same function as ``renderers/diff_tri.py``, through
:class:`DiffBlockedFunction`: on the TPU this pair streams a volume of any
size and its gradient through HBM (bricks by DMA, a flushed accumulator),
where the first keeps both in VMEM; on the card both pairs load and add per
ray, and differ in their entry points only, and in the size of volume
they take: this pair, like ``volrt``'s, any size (its kernels' 64-bit
instance from 2^31 voxels on), ``diff_tri``'s under 2^31 voxels.
"""
from __future__ import annotations

import torch

from volrt_torch.core.types import View
from volrt_torch.renderers.cuda.round1 import DiffBlockedFunction
from volrt_torch.renderers.diff_tri import render_view_round1


def render_view_diff_blocked(density: torch.Tensor, premult_tf: torch.Tensor,
                             ray_step: float, view: View,
                             ray_threshold: float = 0.95) -> torch.Tensor:
    """Premult-level render -> ``f32[H, W, 4]``, differentiable with
    respect to ``density`` ``f32[D, H, W]`` and ``premult_tf``
    ``f32[TF_SIZE, 4]``, through the ``diff_blocked`` kernel pair."""
    return render_view_round1(DiffBlockedFunction, density, premult_tf,
                              ray_step, view, ray_threshold)
