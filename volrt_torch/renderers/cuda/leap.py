"""The leading empty-space leap of rungs 2-4 on the card: the wrapper of
``csrc/esl_leap.cu``.

:func:`esl_start` computes where each ray starts its march after leaping
over the leading empty ESL blocks. It has no Pallas counterpart: ``volrt``
leaps with XLA ops (``volrt/renderers/batched.py:41-86``), whose torch
version, :func:`volrt_torch.renderers.batched.esl_start_raw`, is this
kernel's plain version and returns the same ``k0`` to the bit.
"""
from __future__ import annotations

import torch

from volrt_torch.constants import ESL_VOLUME_DIMS
from volrt_torch.renderers import batched
from volrt_torch.renderers.cuda.march import (
    _F, _I, _P, _launch, check_tensors, max_steps)

# o, d, knear, kfar, hit, dist, w, h, depth, block, bw xyz, min_bw, step,
# max_rounds, n, k0, stream
_LEAP_ARGTYPES = [_P] * 6 + [_I] * 4 + [_F] * 5 + [_I, _I, _P, _P]


def _check(o, d, knear, kfar, hit, dist) -> None:
    n = o.shape[0] if o.dim() == 2 else -1
    check_tensors({"o": (o, torch.float32, (n, 3)),
                   "d": (d, torch.float32, (n, 3)),
                   "knear": (knear, torch.float32, (n,)),
                   "kfar": (kfar, torch.float32, (n,)),
                   "hit": (hit, torch.bool, (n,)),
                   "dist": (dist, torch.int32, (ESL_VOLUME_DIMS,) * 3)},
                  o.device)


def esl_start(o, d, knear, kfar, hit, dist, dims, block: int, block_size,
              ray_step: float) -> torch.Tensor:
    """Each ray's first sample's ray parameter after the leading leap
    -> ``f32[N]``.

    Args:
      o, d: ``f32[N, 3]`` ray origins and directions.
      knear, kfar, hit: ``f32[N]``, ``f32[N]``, ``bool[N]``: where each ray
        enters and leaves the cube, and whether it meets it.
      dist: ``int32[32, 32, 32]``, the ESL grid's distance grid
        (``Raycaster.esl_dist``).
      dims: the volume's ``(W, H, D)``; ``block`` the ESL block edge in
        voxels and ``block_size`` in world units per axis.
      ray_step: the march step; a leap is a whole number of steps.

    CPU tensors take the plain version (``batched.esl_start_raw``). CUDA
    tensors launch the kernel or raise.
    """
    _check(o, d, knear, kfar, hit, dist)
    if o.device.type == "cpu":
        return esl_start_plain(o, d, knear, kfar, hit, dist, dims, block,
                               block_size, ray_step)
    n = o.shape[0]
    k0 = torch.empty_like(knear)
    if n == 0:
        return k0
    w, h, depth = dims
    _launch("volrt_esl_start", _LEAP_ARGTYPES, o.device,
            o.data_ptr(), d.data_ptr(), knear.data_ptr(), kfar.data_ptr(),
            hit.data_ptr(), dist.data_ptr(), w, h, depth, block,
            *block_size, min(block_size), ray_step, max_steps(ray_step), n,
            k0.data_ptr())
    esl_start.launches += 1
    return k0


esl_start.launches = 0


def esl_start_plain(o, d, knear, kfar, hit, dist, dims, block: int,
                    block_size, ray_step: float) -> torch.Tensor:
    """The plain torch version of :func:`esl_start`, same arguments: the
    lockstep leap of ``batched.esl_start_raw`` on ``dist``."""
    return batched.esl_start_raw(None, dims, block, block_size, ray_step, o,
                                 d, knear, kfar, hit, dist)
