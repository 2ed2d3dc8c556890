"""The ray setup of the marches on the card: the wrapper of
``csrc/ray_setup.cu``.

:func:`ray_setup` makes a view's rays in raster order, where each meets
the cube, and the marches' scalars, in one launch. It has no Pallas
counterpart: ``volrt`` sets up rays with XLA ops
(``volrt/core/rays.py:17-80``), whose torch version,
:func:`volrt_torch.core.rays.get_rays` and ``intersect_aabb``, is this
kernel's plain version (:func:`ray_setup_plain`) and gives the same bits.
"""
from __future__ import annotations

import torch

from volrt_torch.core import rays as rays_mod
from volrt_torch.core.types import View
from volrt_torch.renderers.cuda.march import _F, _I, _P, _launch, check_tensors

# The cube's faces on every axis (intersect_aabb's default min_bound).
LO, HI = -1.0, 1.0
# origin, direction, right, up, light, w, h, perspective, lo, hi,
# threshold, kd, loss_scale, o, d, knear, kfar, hit, scal, stream
_RAY_SETUP_ARGTYPES = [_P] * 5 + [_I] * 3 + [_F] * 5 + [_P] * 7

_VECTORS = ("origin", "direction", "right_plane", "up_plane", "light_pos")


def ray_setup(view: View, ray_threshold: float, light_kd: float,
              loss_scale: float = 0.0) -> tuple[torch.Tensor, ...]:
    """``(o, d, knear, kfar, hit, scal)`` of ``view`` on its device.

    ``o``, ``d``: ``f32[N, 3]``, the ``N = W * H`` rays in raster order;
    ``knear``, ``kfar``: ``f32[N]``, where each ray enters (clamped to 0)
    and leaves the cube ``[-1, 1]^3``; ``hit``: ``bool[N]``, whether it
    meets the cube, which is also whether it marches before a leap (a hit
    has ``knear < kfar``); ``scal``: ``f32[8]``, the marches' scalars
    ``(ray_threshold, light_kd, light_pos, 0, loss_scale, 0)``.

    The view's five vectors are ``f32[3]`` on one device. CPU tensors take
    the plain version (:func:`ray_setup_plain`). CUDA tensors launch the
    kernel or raise.
    """
    dev = view.origin.device
    check_tensors({name: (getattr(view, name), torch.float32, (3,))
                   for name in _VECTORS}, dev)
    if dev.type == "cpu":
        return ray_setup_plain(view, ray_threshold, light_kd, loss_scale)
    w, h = view.dims
    n = w * h
    f32 = dict(dtype=torch.float32, device=dev)
    o, d = torch.empty((n, 3), **f32), torch.empty((n, 3), **f32)
    knear, kfar = torch.empty(n, **f32), torch.empty(n, **f32)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    scal = torch.empty(8, **f32)
    _launch("volrt_ray_setup", _RAY_SETUP_ARGTYPES, dev,
            *(getattr(view, name).data_ptr() for name in _VECTORS), w, h,
            int(view.perspective), LO, HI, ray_threshold, light_kd,
            loss_scale, o.data_ptr(), d.data_ptr(), knear.data_ptr(),
            kfar.data_ptr(), hit.data_ptr(), scal.data_ptr())
    ray_setup.launches += 1
    return o, d, knear, kfar, hit, scal


ray_setup.launches = 0


def ray_setup_plain(view: View, ray_threshold: float, light_kd: float,
                    loss_scale: float = 0.0) -> tuple[torch.Tensor, ...]:
    """The plain torch version of :func:`ray_setup`, same arguments:
    ``get_rays``, ``intersect_aabb``, and ``scal`` built from fill kernels
    (a copy from the host, ``torch.tensor(..., device=)``, would go through
    pageable memory and wait for the queued work)."""
    origins, directions = rays_mod.get_rays(view)
    o = origins.reshape(-1, 3).contiguous()
    d = directions.reshape(-1, 3).contiguous()
    knear, kfar, hit = rays_mod.intersect_aabb(o, d)
    f32 = dict(dtype=torch.float32, device=o.device)
    scal = torch.cat([torch.full((1,), ray_threshold, **f32),
                      torch.full((1,), light_kd, **f32),
                      view.light_pos,
                      torch.zeros(1, **f32),
                      torch.full((1,), loss_scale, **f32),
                      torch.zeros(1, **f32)])
    return o, d, knear, kfar, hit, scal
