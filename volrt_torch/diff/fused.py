"""High-level API of the differentiable render on the card's kernels (the
counterpart of ``volrt/diff/fused.py``, its v3 route only).

``render_image_fused(scene, view)`` matches ``render_diff_image`` but runs
the march and its analytic backward as CUDA kernels. ``volrt`` chooses
between its v3 kernels and its round-1 kernels by whether the view fits
the v3 kernels' footprint envelope (``_v3_fits``); that test has no
counterpart here, because a kernel with one thread per ray has no
footprint envelope: every view takes the same kernels.
"""
from __future__ import annotations

import torch

from volrt_torch.core.types import View
from volrt_torch.diff.render import DiffScene
from volrt_torch.renderers.diff_v3 import render_image_v3


def render_image_fused(scene: DiffScene, view: View,
                       ray_threshold: float = 0.95,
                       blocked: bool | None = None, fast: bool = False,
                       esl: bool = False, shaded: bool = False,
                       light_kd: float = 0.6, phong: bool = False
                       ) -> torch.Tensor:
    """Differentiable render -> ``f32[H, W, 4]`` through the march kernels.

    ``blocked`` (``volrt``'s switch to its round-1 kernels) raises
    ``NotImplementedError`` when set: those are kernel rows 6-9 of
    ROADMAP.md's table, still to port. ``fast``, ``esl`` and ``phong``
    raise as in :func:`render_image_v3`.
    """
    if blocked is not None:
        raise NotImplementedError(
            "blocked= selects volrt's round-1 kernels, which are not ported "
            "yet (ROADMAP.md, queue 2, rows 6-9)")
    return render_image_v3(scene, view, ray_threshold=ray_threshold,
                           fast=fast, esl=esl, shaded=shaded, phong=phong,
                           light_kd=light_kd if (shaded or phong) else 0.0)


def l2_loss_fused(scene: DiffScene, view: View, target: torch.Tensor,
                  fast: bool = False, shaded: bool = False,
                  light_kd: float = 0.6, phong: bool = False,
                  esl: bool = False) -> torch.Tensor:
    """MSE training loss through the march kernels, under autograd."""
    img = render_image_fused(scene, view, fast=fast, shaded=shaded,
                             light_kd=light_kd, phong=phong, esl=esl)
    return torch.mean((img - target) ** 2)
