"""The round-1 differentiable render on the card, first pair: the
counterpart of ``volrt/renderers/pallas/diff_tri.py`` at the level of
``render_tiles_diff``.

Unshaded trilinear sampling of an f32 density in [0, 1], the linearly
interpolated TF, premultiplied front-to-back compositing with ERT, on the
accumulating lattice, differentiable in the density and the premultiplied
TF through :class:`DiffTriFunction` (the forward kernel, then the backward
kernel). Ray setup is the forward render's (``fwd_v3.ray_args``):
``k0 = knear``, ``alive = hit & (k0 <= kfar)``, as ``volrt``'s
``prepare_ray_tiles_raw`` sets them, without its tile packing and without
the band offset ``j0``. The TPU kernel's ``(wz, wy)`` window and the padding
of density and TF do not exist here; nor does its ``W <= 128`` bound, which
``diff/fused.py`` keeps as the reference's guard of this route.
"""
from __future__ import annotations

import torch

from volrt_torch.core.types import View
from volrt_torch.renderers import fwd_v3
from volrt_torch.renderers.cuda.round1 import DiffTriFunction


def render_view_round1(function, density: torch.Tensor,
                       premult_tf: torch.Tensor, ray_step: float, view: View,
                       ray_threshold: float) -> torch.Tensor:
    """One view through ``function`` (:class:`DiffTriFunction` or
    :class:`DiffBlockedFunction`) -> ``f32[H, W, 4]``."""
    args, kw = fwd_v3.ray_args(view, density, premult_tf, ray_step,
                               ray_threshold, 0.0)
    o, d, knear, kfar, alive, density, premult_tf, scal = args
    colors = function.apply(density, premult_tf, o, d, knear, kfar, alive,
                            scal, kw["ray_step"], kw["no_ert"], kw["width"])
    w, h = view.dims
    return colors.reshape(h, w, 4)


def render_view_diff(density: torch.Tensor, premult_tf: torch.Tensor,
                     ray_step: float, view: View,
                     ray_threshold: float = 0.95) -> torch.Tensor:
    """Premult-level render -> ``f32[H, W, 4]``, differentiable with
    respect to ``density`` ``f32[D, H, W]`` and ``premult_tf``
    ``f32[TF_SIZE, 4]``, through the ``diff_tri`` kernel pair."""
    return render_view_round1(DiffTriFunction, density, premult_tf, ray_step,
                              view, ray_threshold)
