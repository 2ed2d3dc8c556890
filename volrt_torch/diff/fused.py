"""High-level API of the differentiable render on the card's kernels (the
counterpart of ``volrt/diff/fused.py``).

``render_image_fused(scene, view)`` matches ``render_diff_image`` but runs
the march and its analytic backward as CUDA kernels. ``volrt`` chooses
between its v3 kernels and its round-1 kernels by whether the view fits the
v3 kernels' footprint envelope (``_v3_fits``); that test has no counterpart
here, because a kernel with one thread per ray has no footprint envelope.
So ``blocked=None`` takes the v3 kernels (``march_fwd`` / ``march_bwd``)
for every view, also where ``volrt`` would fall back to a round-1 kernel;
``blocked=False`` and ``blocked=True`` select the round-1 pairs
(``diff_tri``, ``diff_blocked``) as they do in ``volrt``. The round-1
kernels march the accumulating lattice and the v3 kernels ``k0 + i*step``,
so the routes agree to the lattice tolerance (2e-4 in the image), not to
the bit. ``fast=True`` (``volrt``'s fast mode, the default of its trainer)
is a mode of the v3 kernels, whose bf16 instances run it; ``volrt``'s
round-1 kernels take ``fast`` as a matrix-unit precision only, which the
round-1 routes here do not have (``ROADMAP.md``, queue 2).
"""
from __future__ import annotations

import torch

from volrt_torch.core import tf as tf_mod
from volrt_torch.core.types import View
from volrt_torch.diff.render import DiffScene
from volrt_torch.renderers import diff_v3
from volrt_torch.renderers.diff_blocked import render_view_diff_blocked
from volrt_torch.renderers.diff_tri import render_view_diff

# The widest volume the VMEM-resident TPU kernels take
# (``volrt/renderers/pallas/common.py:X_LANES``); ``blocked=False`` keeps
# the reference's guard.
X_LANES = 128


def render_image_fused(scene: DiffScene, view: View,
                       ray_threshold: float = 0.95,
                       blocked: bool | None = None, fast: bool = False,
                       esl: bool = False, shaded: bool = False,
                       light_kd: float = 0.6, phong: bool = False,
                       need_tf_grad: bool = True,
                       need_density_grad: bool = True) -> torch.Tensor:
    """Differentiable render -> ``f32[H, W, 4]`` through the march kernels.

    ``blocked=None``: the v3 kernels, with the diffuse tap when ``shaded``
    and gradient Blinn-Phong when ``phong``, skipping empty space when
    ``esl`` (as :func:`diff_v3.render_image_v3` does).
    ``blocked=False``: the ``diff_tri`` pair, which refuses a volume wider
    than 128 voxels with ``ValueError`` as the reference does.
    ``blocked=True``: the ``diff_blocked`` pair, any size. The round-1
    pairs are unshaded and have no ESL, in ``volrt`` too: ``shaded``,
    ``phong`` and ``esl`` raise ``NotImplementedError`` there. ``fast=True``
    renders ``volrt``'s fast mode on ``blocked=None`` (as
    :func:`diff_v3.render_image_v3` does) and raises
    ``NotImplementedError`` on the round-1 routes.

    ``need_tf_grad=False`` / ``need_density_grad=False`` render with that
    leaf detached: it gets no gradient and the backward kernel skips its
    scatter.
    """
    density = scene.density if need_density_grad else scene.density.detach()
    base = scene.tf_base if need_tf_grad else scene.tf_base.detach()
    premult = tf_mod.premultiply(base)
    if blocked is None:
        return diff_v3.render_view_v3(
            density, premult, scene.ray_step, view, ray_threshold,
            light_kd, shaded, phong,
            diff_v3.scene_esl(scene) if esl else None, fast)[0]
    if shaded or phong:
        raise NotImplementedError(
            "shading requires the v3 path (blocked=None): the round-1 "
            "kernels are unshaded")
    if esl:
        raise NotImplementedError(
            "esl=True requires the v3 path (blocked=None): the round-1 "
            "kernels have no ESL")
    if fast:
        raise NotImplementedError(
            "fast=True on the round-1 routes: volrt's is a matrix-unit "
            "precision there, not ported (ROADMAP.md, queue 2, rows 4-9)")
    w = scene.density.shape[2]
    if w > X_LANES and not blocked:
        raise ValueError(
            f"fused VMEM diff path requires volume W <= {X_LANES}; got {w}")
    render = render_view_diff_blocked if blocked else render_view_diff
    return render(density, premult, scene.ray_step, view, ray_threshold)


def l2_loss_fused(scene: DiffScene, view: View, target: torch.Tensor,
                  fast: bool = False, shaded: bool = False,
                  light_kd: float = 0.6, phong: bool = False,
                  esl: bool = False, need_tf_grad: bool = True,
                  need_density_grad: bool = True) -> torch.Tensor:
    """MSE training loss through the march kernels, under autograd
    (``fast=True``: ``volrt``'s fast mode, as its trainer runs it)."""
    img = render_image_fused(scene, view, fast=fast, shaded=shaded,
                             light_kd=light_kd, phong=phong, esl=esl,
                             need_tf_grad=need_tf_grad,
                             need_density_grad=need_density_grad)
    return torch.mean((img - target) ** 2)
