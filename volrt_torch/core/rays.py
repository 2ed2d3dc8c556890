"""Ray-bundle generation and AABB intersection, as torch ops, and the
march's step bound (the counterparts of ``volrt/core/rays.py:17-80``)."""
from __future__ import annotations

import torch

from volrt_torch.core.types import View


def get_rays(view: View) -> tuple[torch.Tensor, torch.Tensor]:
    """Generate the full ray bundle for a viewport.

    Returns ``(origins, directions)``, each ``f32[H, W, 3]`` on the view's
    device. Matches the reference (reference: ViewBase.h:23-35): pixel
    offsets are ``pos - dims/2`` with integer division, and perspective
    directions are deliberately not normalised.
    """
    w, h = view.dims
    dev = view.origin.device
    px = (torch.arange(w, dtype=torch.float32, device=dev) - (w // 2))[None, :, None]
    py = (torch.arange(h, dtype=torch.float32, device=dev) - (h // 2))[:, None, None]
    plane_offset = view.right_plane * px + view.up_plane * py  # (H, W, 3)
    if view.perspective:
        origins = view.origin.expand(plane_offset.shape)
        directions = view.direction + plane_offset
    else:
        origins = view.origin + plane_offset
        directions = view.direction.expand(plane_offset.shape)
    return origins, directions


def intersect_aabb(
    origins: torch.Tensor,
    directions: torch.Tensor,
    min_bound: tuple[float, float, float] = (-1.0, -1.0, -1.0),
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab-method ray/AABB intersection over ``(..., 3)`` rays.

    Returns ``(k_near, k_far, hit)`` of shape ``(...)``; ``k_near`` is
    clamped to ``>= 0``. Direction components of exactly 0 are replaced by
    1e-5, as in the reference slab test (reference: RaycasterBase.h:32-42).
    """
    # Filled on the device, not copied from the host (see fwd_v3.march_args).
    lo = torch.cat([origins.new_full((1,), v) for v in min_bound])
    hi = -lo
    d = torch.where(directions == 0.0, 1e-5, directions)
    k1 = (lo - origins) / d
    k2 = (hi - origins) / d
    knear = torch.minimum(k1, k2).amax(dim=-1)
    kfar = torch.maximum(k1, k2).amin(dim=-1)
    knear = knear.clamp(min=0.0)
    hit = (knear < kfar) & (kfar > 0.0)
    return knear, kfar, hit


def max_march_steps(ray_step: float, perspective: bool = False) -> int:
    """Static upper bound on the number of march steps through the cube.

    The chord of the ``[-1,1]^3`` cube is ``2*sqrt(3)``; for unnormalized
    perspective directions the parametric length can only shrink (|dir|>=1 at
    the principal ray and grows off-axis), so the orthographic bound is safe.
    """
    chord = 2.0 * (3.0 ** 0.5)
    return int(chord / ray_step) + 2
