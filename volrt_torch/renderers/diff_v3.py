"""The differentiable rung-5 render on the card's kernels: the counterpart
of the scene-level API of ``volrt/renderers/pallas/diff_v3.py``
(``render_view_v3``, ``render_image_v3``, ``render_image_v3_with_ovf``,
``l2_loss_grads_v3_onepass``).

The ray setup is the forward render's (``fwd_v3.ray_args``). The march
runs under autograd through :class:`MarchFunction` (forward kernel, then
backward kernel), or, for the L2 step, through the one-launch
:func:`l2_step`. None of the TPU kernels' planning arguments (``window``,
``flush``, ``plan``) exist here: a per-ray kernel has no windows to plan.
"""
from __future__ import annotations

import torch

from volrt_torch.core import tf as tf_mod
from volrt_torch.core.types import View
from volrt_torch.diff.render import DiffScene
from volrt_torch.renderers import fwd_v3
from volrt_torch.renderers.cuda.march import MarchFunction, l2_step


def check_modes(fast: bool, esl: bool, shaded: bool = False,
                phong: bool = False) -> None:
    """Refuse the modes the march kernels do not have yet, and ``shaded``
    with ``phong``, which no kernel composes (``diff_v3.py:2608-2609``)."""
    if fast:
        raise NotImplementedError(
            "fast (bf16) storage is not ported yet (ROADMAP.md, queue 2, "
            "row 1)")
    if esl:
        raise NotImplementedError(
            "esl=True is not ported yet (ROADMAP.md, queue 1: ESL)")
    if shaded and phong:
        raise ValueError("shaded and phong are mutually exclusive")


def render_view_v3(density: torch.Tensor, premult_tf: torch.Tensor,
                   ray_step: float, view: View, ray_threshold: float = 0.95,
                   light_kd: float = 0.0, shaded: bool = False,
                   phong: bool = False) -> tuple[torch.Tensor, float]:
    """Premult-level render -> ``(f32[H, W, 4], overflow count)``,
    differentiable with respect to ``density`` ``f32[D, H, W]`` and
    ``premult_tf`` ``f32[TF_SIZE, 4]``. ``shaded`` takes the diffuse tap,
    ``phong`` gradient Blinn-Phong, each with ``light_kd``. The overflow
    count is 0: the kernels have no windows (see
    ``fwd_v3.render_float``)."""
    check_modes(False, False, shaded, phong)
    args, kw = fwd_v3.ray_args(
        view, density, premult_tf, ray_step, ray_threshold,
        light_kd if (shaded or phong) else 0.0, phong=phong)
    o, d, knear, kfar, alive, density, premult_tf, scal = args
    colors = MarchFunction.apply(
        density, premult_tf, o, d, knear, kfar, alive, scal,
        kw["ray_step"], kw["shade"], kw["no_ert"], kw["width"],
        kw.get("phong", False))
    w, h = view.dims
    return colors.reshape(h, w, 4), 0.0


def render_image_v3_with_ovf(scene: DiffScene, view: View,
                             ray_threshold: float = 0.95, fast: bool = False,
                             esl: bool = False, light_kd: float = 0.0,
                             shaded: bool = False, phong: bool = False
                             ) -> tuple[torch.Tensor, float]:
    """As :func:`render_image_v3` but also returns the overflow count."""
    check_modes(fast, esl)
    return render_view_v3(scene.density, scene.premult_tf(), scene.ray_step,
                          view, ray_threshold, light_kd, shaded, phong)


def render_image_v3(scene: DiffScene, view: View,
                    ray_threshold: float = 0.95, fast: bool = False,
                    esl: bool = False, light_kd: float = 0.0,
                    shaded: bool = False, phong: bool = False
                    ) -> torch.Tensor:
    """Differentiable render -> ``f32[H, W, 4]`` through the march kernels.

    Semantics match ``diff.render.render_diff_image`` (with the ``shaded``
    diffuse light tap); gradients flow to ``scene.density`` and, through
    the premultiply, to the un-premultiplied ``scene.tf_base``. A leaf
    with ``requires_grad`` off skips its scatter in the backward kernel.
    ``phong=True`` shades with ``volrt``'s v3 gradient Blinn-Phong, whose
    normal taps lie one clipped voxel to either side (the oracle's move
    the world point by 2/n: the two differ at the volume's faces).
    ``shaded`` with ``phong`` raises ``ValueError``; ``fast`` and ``esl``
    raise ``NotImplementedError``.
    """
    return render_image_v3_with_ovf(scene, view, ray_threshold, fast, esl,
                                    light_kd, shaded, phong)[0]


def l2_loss_grads_v3_onepass(scene: DiffScene, view: View,
                             target: torch.Tensor,
                             ray_threshold: float = 0.95, fast: bool = False,
                             need_dtf: bool = True, need_dvol: bool = True,
                             esl: bool = False, shaded: bool = False,
                             phong: bool = False, light_kd: float = 0.6
                             ) -> tuple[torch.Tensor, dict]:
    """Full-image MSE loss and scene gradients in one kernel launch
    -> ``(loss, {"density": ..., "tf_base": ...})``.

    The same numbers as autograd of ``mean((render_image_v3(scene, view)
    - target) ** 2)``, but the forward march, each ray's cotangent and the
    backward run in one launch (:func:`l2_step`); nothing is recorded for
    autograd. ``target`` is ``f32[H, W, 4]`` on the scene's device.
    ``need_dtf=False`` / ``need_dvol=False`` skip that leaf's scatter and
    return zeros for it. ``shaded`` takes the diffuse tap, ``phong``
    gradient Blinn-Phong (not both), each with ``light_kd``. The TF
    gradient is chained from the premultiplied LUT's to ``tf_base`` here,
    as ``volrt``'s does it in XLA.
    """
    check_modes(fast, esl, shaded, phong)
    w, h = view.dims
    scale = 2.0 / (float(h) * float(w) * 4.0)
    with torch.no_grad():
        base = scene.tf_base
        args, kw = fwd_v3.ray_args(
            view, scene.density, tf_mod.premultiply(base), scene.ray_step,
            ray_threshold, light_kd if (shaded or phong) else 0.0,
            loss_scale=scale, phong=phong)
        tgt = target.to(torch.float32).reshape(-1, 4).contiguous()
        out, d_density, d_premult = l2_step(
            *args, tgt, need_dtf=need_dtf, need_dvol=need_dvol, **kw)
        diff = out - tgt
        loss = (diff * diff).sum() * (scale * 0.5)
        # premult = (rgb * a, a): d_base.rgb = d_premult.rgb * a,
        # d_base.a = d_premult.a + sum(d_premult.rgb * rgb).
        d_rgb = d_premult[:, :3] * base[:, 3:4]
        d_a = d_premult[:, 3:4] + (d_premult[:, :3] * base[:, :3]).sum(
            -1, keepdim=True)
        d_base = torch.cat([d_rgb, d_a], dim=-1)
    return loss, {"density": d_density, "tf_base": d_base}
