"""Renderer 5 (``pallas-v3``) on the card: the counterpart of
``volrt/renderers/pallas/fwd_v3.py:32-74``.

Trilinear sampling, the linearly interpolated TF, premultiplied
front-to-back compositing with ERT, unshaded or with the reference's
one-tap diffuse (reference: GPURenderer4.cu:41-87). Ray setup is torch
ops; the march is :func:`volrt_torch.renderers.cuda.march.march_fwd`.
"""
from __future__ import annotations

import torch

from volrt_torch.constants import SHADE_KD_GATE
from volrt_torch.core import rays as rays_mod
from volrt_torch.core import sampling
from volrt_torch.core.types import Raycaster
from volrt_torch.renderers.cuda.march import march_fwd

NAME = "pallas-v3"


def render_float(rc: Raycaster, fast: bool = False
                 ) -> tuple[torch.Tensor, float]:
    """Render to ``(f32[H, W, 4] image, overflow count)``.

    The overflow count is always 0: the TPU kernel counts samples that fell
    outside its planned window bricks, and the port's kernel has no windows;
    every ray loads its own taps. It stays in the return so that callers of
    both packages match.

    ``rc.esl`` marches every sample: the image is the same, since rung 5's
    ESL drops only groups that contribute exactly zero. The skipping itself
    is still to come (ROADMAP.md, queue 1: ESL). ``shading="phong"`` and
    ``fast=True`` (bf16 storage) raise ``NotImplementedError``.
    """
    if rc.shading == "phong":
        raise NotImplementedError(
            "phong shading is not ported yet (ROADMAP.md, queue 1: Shading)")
    if rc.shading != "diffuse":
        raise ValueError(f"unknown shading: {rc.shading}")
    if fast:
        raise NotImplementedError(
            "fast (bf16) storage is not ported yet (ROADMAP.md, queue 2, row 1)")
    args, kw = march_args(rc)
    w, h = rc.view.dims
    colors = march_fwd(*args, **kw)
    return colors.reshape(h, w, 4), 0.0


def march_args(rc: Raycaster) -> tuple[tuple, dict]:
    """The ray setup: ``(args, kwargs)`` of :func:`march_fwd` for ``rc``.

    Rays come from ``get_rays`` in raster order and march from ``knear``
    (no ESL leap) to ``kfar``, as ``volrt``'s ``prepare_ray_tiles_raw``
    sets them up, without its 16x16 tile packing: the kernel's blocks
    are pixel patches of the raster image already.
    """
    view, dev = rc.view, rc.device
    origins, directions = rays_mod.get_rays(view)
    o = origins.reshape(-1, 3).contiguous()
    d = directions.reshape(-1, 3).contiguous()
    knear, kfar, hit = rays_mod.intersect_aabb(o, d, rc.volume.min_bound)
    alive = hit & (knear <= kfar)
    density = rc.volume.data.to(torch.float32) / 255.0
    # Built from fill kernels. A copy from the host (torch.tensor(...,
    # device=), or item assignment) goes through pageable memory, and the
    # host then waits for the queued work, the previous frame's march too.
    f32 = dict(dtype=torch.float32, device=dev)
    scal = torch.cat([torch.full((1,), rc.ray_threshold, **f32),
                      torch.full((1,), rc.light_kd, **f32),
                      view.light_pos.to(torch.float32),
                      torch.zeros(3, **f32)])
    args = (o, d, knear, kfar, alive, density, rc.transfer_fn.contiguous(),
            scal)
    kw = dict(
        ray_step=rc.ray_step,
        # The tap contributes nothing unless kd passes its gate.
        shade=rc.light_kd > SHADE_KD_GATE,
        # Opacity never exceeds 1, so a threshold >= 1 is never crossed.
        no_ert=rc.ray_threshold >= 1.0,
        width=view.dims[0])
    return args, kw


def render(rc: Raycaster) -> torch.Tensor:
    """Render to ``uint8[H, W, 4]``."""
    img, _ = render_float(rc)
    return sampling.write_color(img)
