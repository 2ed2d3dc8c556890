"""Renderer 1 (``xla-batched``) as torch ops: the counterpart of
``volrt/renderers/batched.py``.

All rays march in lockstep, with masks standing in for each ray's own
``break``: ERT and the end of the ray clear a ray's ``alive`` bit. The ray
parameter is accumulated, ``k += step`` from the ray's own start, and a ray
ends when its next ``k`` exceeds ``kfar`` (reference: CPURenderer.cpp:35-38).
This module also holds the leading empty-space leap that rungs 1-4 share.
"""
from __future__ import annotations

import torch

from volrt_torch.constants import SHADE_KD_GATE
from volrt_torch.core import esl as esl_mod
from volrt_torch.core import rays as rays_mod
from volrt_torch.core import sampling
from volrt_torch.core.types import Raycaster
from volrt_torch.renderers.common import classify_and_shade, composite
from volrt_torch.renderers.cuda.march import max_steps

NAME = "xla-batched"

# A lockstep loop asks the device whether every ray has finished only once
# in this many rounds: each question makes the host wait for the queued
# work. Rounds past the end change nothing.
ROUNDS_PER_CHECK = 8


def esl_start(rc: Raycaster, origins: torch.Tensor, directions: torch.Tensor,
              knear: torch.Tensor, kfar: torch.Tensor,
              hit: torch.Tensor) -> torch.Tensor:
    """Each ray's start after the leading empty-space leap
    (reference: CPURenderer.cpp:18-25), for ``N`` rays in lockstep, on the
    render state's distance grid."""
    return esl_start_raw(
        rc.esl_empty, rc.volume.dims, rc.esl_block_dims, rc.esl_block_size,
        rc.ray_step, origins, directions, knear, kfar, hit, rc.esl_dist)


def esl_start_raw(esl_empty: torch.Tensor, dims, block: int, block_size,
                  step: float, origins: torch.Tensor,
                  directions: torch.Tensor, knear: torch.Tensor,
                  kfar: torch.Tensor, hit: torch.Tensor,
                  dist: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`esl_start` from its parts; ``dist`` is ``esl_empty``'s
    distance grid (:func:`esl_mod.empty_distance_grid`), derived here when
    not given.

    A ray in a block ``m`` blocks (Chebyshev) from the nearest non-empty one
    leaps the larger of the way to its block's exit face and ``m - 1`` block
    widths, rounded down to whole steps, plus one step, until it stands in a
    block with ``m == 0`` or has left the cube. Every sample leapt over lies
    in an empty block, so the image does not change
    (``volrt/renderers/batched.py:41-86``).

    Every operation rounds alike on the CPU and on the card, so that the
    leap kernel (``renderers/cuda/leap.py:esl_start``) is held to this to
    the bit: the divisors are tensors (torch divides a CUDA tensor by a
    Python number as a product with its reciprocal) and the norm is summed
    in a fixed order.

    The loop runs until a check every ``ROUNDS_PER_CHECK`` rounds finds
    every ray stopped, and at most as many rounds as a ray has steps;
    ``esl_start_raw.rounds`` holds the rounds of the last call, and
    ``esl_start_raw.loads`` (a tensor) its loads of the distance grid,
    one a round for each ray not yet stopped.
    """
    if dist is None:
        dist = esl_mod.empty_distance_grid(esl_empty)
    min_bw = min(block_size)
    # Perspective directions are not normalised (reference: ViewBase.h:28):
    # the safe radius in world units becomes one in ray parameters.
    x, y, z = directions.unbind(-1)
    dnorm = torch.sqrt((x * x + y * y) + z * z + 1e-20)
    step_t = knear.new_full((), step)
    k, stopped = knear, ~hit
    esl_start_raw.rounds = 0
    esl_start_raw.loads = torch.zeros((), dtype=torch.int64,
                                      device=knear.device)
    for i in range(max_steps(step)):
        esl_start_raw.rounds += 1
        esl_start_raw.loads = esl_start_raw.loads + (~stopped).sum()
        pt = origins + directions * k[..., None]
        ix, iy, iz = (sampling.world_to_voxel_idx(pt, dims) // block).unbind(-1)
        m = dist[iz, iy, ix]
        do_leap = (k <= kfar) & (m >= 1) & ~stopped
        dk = esl_mod.leap_distance(pt, directions, dims, block, block_size,
                                   step)
        ball = torch.floor(
            (m - 1).to(torch.float32) * min_bw / dnorm / step_t) * step
        k = torch.where(do_leap, k + torch.maximum(dk, ball) + step, k)
        stopped = stopped | ~do_leap
        if i % ROUNDS_PER_CHECK == ROUNDS_PER_CHECK - 1 and stopped.all():
            break
    return k


esl_start_raw.rounds = 0
esl_start_raw.loads = torch.zeros((), dtype=torch.int64)


def ray_bundle(rc: Raycaster) -> tuple[torch.Tensor, ...]:
    """``(o, d, knear, kfar, hit)`` of the view's rays in raster order."""
    origins, directions = rays_mod.get_rays(rc.view)
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    return (o, d, *rays_mod.intersect_aabb(o, d, rc.volume.min_bound))


def march_lockstep(rc: Raycaster, o: torch.Tensor, d: torch.Tensor,
                   k0: torch.Tensor, kfar: torch.Tensor,
                   alive: torch.Tensor) -> torch.Tensor:
    """March ``N`` rays from ``k0`` in lockstep -> ``f32[N, 4]``
    (``volrt/renderers/batched.py:103-119``). A ray composites while it is
    alive; ERT or a next ``k`` beyond ``kfar`` ends it. ``rc.shading``
    is ``"diffuse"`` or ``"phong"``."""
    if rc.shading not in ("diffuse", "phong"):
        raise ValueError(f"unknown shading: {rc.shading}")
    # Neither shading contributes anything unless kd passes its gate.
    light_pos = rc.view.light_pos if rc.light_kd > SHADE_KD_GATE else None
    k = k0
    acc = torch.zeros((o.shape[0], 4), dtype=torch.float32, device=o.device)
    for i in range(max_steps(rc.ray_step)):
        color = classify_and_shade(
            rc.volume.data, rc.transfer_fn, o + d * k[..., None],
            light_pos=light_pos, light_kd=rc.light_kd,
            interpolation=rc.interpolation, shading=rc.shading, view_dir=d)
        acc = torch.where(alive[..., None], composite(acc, color), acc)
        k = k + rc.ray_step
        alive = alive & ~(acc[..., 3] > rc.ray_threshold) & (k <= kfar)
        if i % ROUNDS_PER_CHECK == ROUNDS_PER_CHECK - 1 and not alive.any():
            break
    return acc


def render_float(rc: Raycaster) -> torch.Tensor:
    """Render to a float RGBA image ``f32[H, W, 4]``."""
    o, d, knear, kfar, hit = ray_bundle(rc)
    k0 = esl_start(rc, o, d, knear, kfar, hit) if rc.esl else knear
    w, h = rc.view.dims
    acc = march_lockstep(rc, o, d, k0, kfar, hit & (k0 <= kfar))
    return acc.reshape(h, w, 4)


def render(rc: Raycaster) -> torch.Tensor:
    """Render to ``uint8[H, W, 4]``."""
    return sampling.write_color(render_float(rc))
