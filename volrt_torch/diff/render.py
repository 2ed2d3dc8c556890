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

from volrt_torch.constants import (
    PHONG_KA,
    PHONG_KS,
    PHONG_SHININESS,
    SHADE_ALPHA_GATE,
    SHADE_KD_GATE,
)
from volrt_torch.core import esl as esl_mod
from volrt_torch.core import rays as rays_mod
from volrt_torch.core import sampling
from volrt_torch.core import tf as tf_mod
from volrt_torch.core.device import resolve_device
from volrt_torch.core.types import View, default_esl_block_dims
from volrt_torch.renderers.batched import esl_start_raw
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
        # Copies: training updates the leaves in place, and must not write
        # into the arrays or tensors the scene was made from.
        self.density = nn.Parameter(
            density.detach().to(torch.float32, copy=True).contiguous())
        self.tf_base = nn.Parameter(
            tf_base.detach().to(torch.float32, copy=True).contiguous())
        self.ray_step = float(ray_step)

    def premult_tf(self) -> torch.Tensor:
        return tf_mod.premultiply(self.tf_base)


def scene_empty_grid(scene: DiffScene
                     ) -> tuple[torch.Tensor, int, tuple[float, ...]]:
    """The ESL emptiness grid of a float scene under its live TF
    (``volrt/diff/render.py:57-86``): the density rounded to uint8 drives
    the reference's min/max block grid, and the premultiplied ``tf_base``
    says which blocks are empty -> ``(empty bool[32, 32, 32], block_dims,
    block_size)``, as :func:`batched.esl_start_raw` takes them.

    ESL is a forward optimisation: a skipped sample contributes no colour
    under the current TF, but its (possibly nonzero) TF gradient is
    skipped too, so a TF cannot open a density range that it maps to zero
    opacity while every step skips it (``fit(esl_refresh_every=)``)."""
    with torch.no_grad():
        d, h, w = scene.density.shape
        u8 = torch.round(scene.density * 255.0).clamp(0, 255).to(
            torch.uint8)
        block = default_esl_block_dims((w, h, d))
        empty = esl_mod.derive_empty_grid(
            esl_mod.build_min_max_grid(u8, block),
            tf_mod.premultiply(scene.tf_base))
    return empty, block, (2.0 * block / w, 2.0 * block / h, 2.0 * block / d)


def _safe_normalize(v: torch.Tensor) -> torch.Tensor:
    """``v / |v|`` whose gradient stays finite at ``v == 0`` (flat
    density): the floor under the squared norm has zero derivative
    (``volrt/diff/render.py:148-153``)."""
    n2 = (v * v).sum(-1, keepdim=True)
    return v * torch.rsqrt(n2.clamp(min=1e-24))


def _phong(density: torch.Tensor, color: torch.Tensor, pt: torch.Tensor,
           directions: torch.Tensor, light_pos: torch.Tensor,
           light_kd: float) -> torch.Tensor:
    """Gradient Blinn-Phong on a premultiplied ``color (N, 4)``, the
    semantics of ``renderers.common.phong_shade`` in differentiable form
    (``volrt/diff/render.py:161-183``): six central-difference taps one
    voxel to either side, all under autograd."""
    d_, h_, w_ = density.shape
    ldir = _safe_normalize(light_pos - pt)
    comps = []
    for axis, n in ((0, w_), (1, h_), (2, d_)):
        off = torch.zeros(3, dtype=torch.float32, device=pt.device)
        off[axis] = 2.0 / n
        comps.append(sampling.sample_trilinear_f(density, pt + off)
                     - sampling.sample_trilinear_f(density, pt - off))
    nrm = -_safe_normalize(torch.stack(comps, dim=-1))
    half = _safe_normalize(ldir + _safe_normalize(-directions))
    # torch.maximum halves the gradient at a tie, as jnp.maximum does;
    # clamp would pass it whole.
    zero = torch.zeros((), dtype=torch.float32, device=pt.device)
    ndl = torch.maximum((nrm * ldir).sum(-1), zero)
    ndh = torch.maximum((nrm * half).sum(-1), zero)
    alpha = color[:, 3]
    lit = (color[:, :3] * (PHONG_KA + light_kd * ndl)[:, None]
           + (PHONG_KS * ndh ** PHONG_SHININESS * alpha)[:, None])
    gate = (alpha > SHADE_ALPHA_GATE) & (light_kd > SHADE_KD_GATE)
    return torch.cat([torch.where(gate[:, None], lit, color[:, :3]),
                      color[:, 3:4]], dim=-1)


def render_diff(scene: DiffScene, origins: torch.Tensor,
                directions: torch.Tensor, ray_threshold: float = 0.95,
                esl: bool = False, light_kd: float = 0.0,
                light_pos: torch.Tensor | None = None,
                phong: bool = False) -> torch.Tensor:
    """Render rays differentiably -> premultiplied RGBA ``(..., 4)``.

    ``light_pos`` turns on the reference's gated one-tap diffuse with
    ``light_kd``, differentiable through both taps. ``phong=True``
    (requires ``light_pos``) replaces it with gradient Blinn-Phong.
    ``esl=True`` leaps each ray's leading empty space
    (:func:`batched.esl_start_raw` on :func:`scene_empty_grid`, as
    ``volrt``'s oracle does) and marches from there.
    """
    if phong and light_pos is None:
        raise ValueError("phong=True requires light_pos")
    lead = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    knear, kfar, hit = rays_mod.intersect_aabb(o, d)
    if esl:
        dp, hp, wp = scene.density.shape
        empty, block, bs = scene_empty_grid(scene)
        knear = esl_start_raw(empty, (wp, hp, dp), block, bs,
                              scene.ray_step, o, d, knear, kfar, hit)
    n_steps = max_steps(scene.ray_step)
    steps = torch.arange(n_steps, dtype=torch.float32,
                         device=o.device) * scene.ray_step
    premult = scene.premult_tf()
    density = scene.density

    def march_chunk(acc, alive, oc, dc, kn, kf, premult, density, s0):
        for step in steps[s0:s0 + CHECKPOINT_CHUNK]:
            k = kn + step
            pt = oc + dc * k[:, None]
            if phong:
                color = _phong(density,
                               classify_and_shade(density, premult, pt), pt,
                               dc, light_pos, light_kd)
            else:
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
    position and ``light_kd``; ``phong=True`` applies gradient Blinn-Phong
    instead. ``esl=True`` leaps each ray's leading empty space
    (:func:`render_diff`)."""
    origins, directions = rays_mod.get_rays(view)
    return render_diff(
        scene, origins, directions, ray_threshold, esl=esl,
        light_kd=light_kd,
        light_pos=view.light_pos if (shaded or phong) else None, phong=phong)


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
