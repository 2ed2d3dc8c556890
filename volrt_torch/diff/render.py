"""The differentiable march as plain torch ops under autograd: the port's
own oracle (the counterpart of ``volrt/diff/render.py``).

Forward semantics are the forward render's (trilinear density sampling,
the linearly interpolated TF, front-to-back premultiplied compositing,
ERT as a mask), written as a fixed-length lockstep march with per-ray
masks, so that autograd differentiates the whole of it. The CUDA backward
kernels (``renderers/cuda/march.py``) are held to its gradients.

Trainable leaves of a :class:`DiffScene`:

* ``density``: ``f32[D, H, W]`` voxel grid in [0, 1] (the float analog of
  the uint8 volume: u8/255);
* ``tf_base``: ``f32[TF_SIZE, 4]`` un-premultiplied RGBA LUT; the
  premultiplication happens in the graph, so gradients reach the base TF.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from volrt_torch.core import rays as rays_mod
from volrt_torch.core import tf as tf_mod
from volrt_torch.core.device import resolve_device
from volrt_torch.core.types import View
from volrt_torch.renderers.common import classify_and_shade
from volrt_torch.renderers.cuda.march import max_steps

# March steps per rematerialisation chunk: reverse mode through the march
# would otherwise keep every step's gather intermediates. Each chunk keeps
# only its entering carry and is recomputed during the backward.
CHECKPOINT_CHUNK = 16
# Rays marched together: bounds what one rematerialised chunk holds.
RAY_CHUNK = 1 << 18


class DiffScene(nn.Module):
    """Trainable scene parameters and the static march step.

    Attributes:
      density: ``nn.Parameter f32[D, H, W]`` in [0, 1].
      tf_base: ``nn.Parameter f32[TF_SIZE, 4]``, un-premultiplied.
      ray_step: march step in world units.
    """

    def __init__(self, density: torch.Tensor, tf_base: torch.Tensor,
                 ray_step: float):
        super().__init__()
        self.density = nn.Parameter(density.to(torch.float32).contiguous())
        self.tf_base = nn.Parameter(tf_base.to(torch.float32).contiguous())
        self.ray_step = float(ray_step)

    def premult_tf(self) -> torch.Tensor:
        return tf_mod.premultiply(self.tf_base)


def _unported(esl: bool, phong: bool) -> None:
    if esl:
        raise NotImplementedError(
            "esl=True is not ported yet (ROADMAP.md, queue 1: ESL)")
    if phong:
        raise NotImplementedError(
            "phong shading is not ported yet (ROADMAP.md, queue 1: Shading)")


def render_diff(scene: DiffScene, origins: torch.Tensor,
                directions: torch.Tensor, ray_threshold: float = 0.95,
                esl: bool = False, light_kd: float = 0.0,
                light_pos: torch.Tensor | None = None,
                phong: bool = False) -> torch.Tensor:
    """Render rays differentiably -> premultiplied RGBA ``(..., 4)``.

    ``light_pos`` turns on the reference's gated one-tap diffuse with
    ``light_kd``, differentiable through both taps. ``esl=True`` and
    ``phong=True`` raise ``NotImplementedError``.
    """
    _unported(esl, phong)
    lead = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    knear, kfar, hit = rays_mod.intersect_aabb(o, d)
    n_steps = max_steps(scene.ray_step)
    steps = torch.arange(n_steps, dtype=torch.float32,
                         device=o.device) * scene.ray_step
    premult = scene.premult_tf()
    density = scene.density

    def march_chunk(acc, alive, oc, dc, kn, kf, premult, density, s0):
        for step in steps[s0:s0 + CHECKPOINT_CHUNK]:
            k = kn + step
            pt = oc + dc * k[:, None]
            color = classify_and_shade(density, premult, pt,
                                       light_pos=light_pos,
                                       light_kd=light_kd)
            mask = alive & (k <= kf)
            acc = acc + torch.where(mask[:, None],
                                    color * (1.0 - acc[:, 3:4]), 0.0)
            alive = alive & (acc[:, 3] <= ray_threshold) & (k <= kf)
        return acc, alive

    out = []
    for r0 in range(0, o.shape[0], RAY_CHUNK):
        sl = slice(r0, r0 + RAY_CHUNK)
        acc = torch.zeros((o[sl].shape[0], 4), dtype=torch.float32,
                          device=o.device)
        alive = hit[sl]
        for s0 in range(0, n_steps, CHECKPOINT_CHUNK):
            acc, alive = checkpoint(
                march_chunk, acc, alive, o[sl], d[sl], knear[sl], kfar[sl],
                premult, density, s0, use_reentrant=False)
        out.append(acc)
    return torch.cat(out).reshape(*lead, 4)


def render_diff_image(scene: DiffScene, view: View,
                      ray_threshold: float = 0.95, esl: bool = False,
                      light_kd: float = 0.0, shaded: bool = False,
                      phong: bool = False) -> torch.Tensor:
    """Render a full viewport differentiably -> ``f32[H, W, 4]``.

    ``shaded=True`` applies the diffuse light tap with the view's light
    position and ``light_kd``."""
    _unported(esl, phong)
    origins, directions = rays_mod.get_rays(view)
    return render_diff(scene, origins, directions, ray_threshold,
                       light_kd=light_kd,
                       light_pos=view.light_pos if shaded else None)


def scene_from_volume(volume_u8, tf_base, ray_step: float, *,
                      device: torch.device | str | None = None) -> DiffScene:
    """Wrap a uint8 volume (tensor or array) as a differentiable scene on
    ``device``, the card when ``None`` (u8 -> [0, 1] f32)."""
    device = resolve_device(device)
    vol = torch.as_tensor(volume_u8, device=device)
    return DiffScene(vol.to(torch.float32) / 255.0,
                     torch.as_tensor(tf_base, dtype=torch.float32,
                                     device=device), ray_step)


def scene_from_arrays(density, tf_base, ray_step: float, *,
                      device: torch.device | str | None = None) -> DiffScene:
    """Carry a JAX ``DiffScene`` across as numpy arrays: ``density``
    ``f32[D, H, W]``, ``tf_base`` ``f32[TF_SIZE, 4]`` un-premultiplied.
    Returns the port's :class:`DiffScene` on ``device`` (the card when
    ``None``)."""
    device = resolve_device(device)
    return DiffScene(
        torch.tensor(np.asarray(density, np.float32), device=device),
        torch.tensor(np.asarray(tf_base, np.float32), device=device),
        ray_step)
