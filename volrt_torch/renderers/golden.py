"""Renderer 0 (``jax-golden``) as torch ops: the counterpart of
``volrt/renderers/golden.py``, the transcription of the reference algorithm
(reference: CPURenderer.cpp:11-53) that every other rung is held to.

The JAX package marches each ray in its own ``while_loop`` under ``vmap``;
torch has no such thing, so the rays march in lockstep under masks, which
gives each ray the same samples. What sets this rung apart from rung 1 is
its leap: one block per pass through ``sample_empty``, as the reference
leaps, where rung 1 leaps by a distance field. Both skip only empty space
and give the same image, from different starts ``k0``.
"""
from __future__ import annotations

import torch

from volrt_torch.core import esl as esl_mod
from volrt_torch.core import sampling
from volrt_torch.core.types import Raycaster
from volrt_torch.renderers import batched
from volrt_torch.renderers.cuda.march import max_steps

NAME = "jax-golden"


def esl_start(rc: Raycaster, o: torch.Tensor, d: torch.Tensor,
              knear: torch.Tensor, kfar: torch.Tensor,
              hit: torch.Tensor) -> torch.Tensor:
    """The reference's leading leap loop for ``N`` rays in lockstep: while
    the ray stands in an empty block inside the cube, leap to that block's
    exit face in whole steps and advance one step
    (reference: CPURenderer.cpp:18-25; ``volrt/renderers/golden.py:37-56``)."""
    dims, block = rc.volume.dims, rc.esl_block_dims
    k, stopped = knear, ~hit
    for i in range(max_steps(rc.ray_step)):
        pt = o + d * k[..., None]
        do_leap = ((k <= kfar) & ~stopped
                   & esl_mod.sample_empty(rc.esl_empty, pt, dims, block))
        dk = esl_mod.leap_distance(pt, d, dims, block, rc.esl_block_size,
                                   rc.ray_step)
        k = torch.where(do_leap, k + dk + rc.ray_step, k)
        stopped = stopped | ~do_leap
        if (i % batched.ROUNDS_PER_CHECK == batched.ROUNDS_PER_CHECK - 1
                and stopped.all()):
            break
    return k


def render_float(rc: Raycaster) -> torch.Tensor:
    """Render to a float RGBA image ``f32[H, W, 4]`` (before quantisation)."""
    o, d, knear, kfar, hit = batched.ray_bundle(rc)
    k0 = esl_start(rc, o, d, knear, kfar, hit) if rc.esl else knear
    w, h = rc.view.dims
    # No march when the leap ran past the exit or the ray missed
    # (reference: CPURenderer.cpp:26-27).
    acc = batched.march_lockstep(rc, o, d, k0, kfar, hit & (k0 <= kfar))
    return acc.reshape(h, w, 4)


def render(rc: Raycaster) -> torch.Tensor:
    """Render to ``uint8[H, W, 4]``, like the reference's PBO buffer."""
    return sampling.write_color(render_float(rc))
