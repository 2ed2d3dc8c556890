"""Renderer 5 (``pallas-v3``) on the card: the counterpart of
``volrt/renderers/pallas/fwd_v3.py:32-74``.

Trilinear sampling, the linearly interpolated TF, premultiplied
front-to-back compositing with ERT, unshaded, with the reference's one-tap
diffuse (reference: GPURenderer4.cu:41-87) or with v3's gradient
Blinn-Phong (``shading="phong"``, BASELINE config 4's shading), over the
f32 density or, with ``fast=True``, its bf16 copy (``volrt``'s fast mode).
The ray setup is one kernel,
:func:`volrt_torch.renderers.cuda.rays.ray_setup`; the march is
:func:`volrt_torch.renderers.cuda.march.march_fwd`.
"""
from __future__ import annotations

import torch

from volrt_torch.constants import SHADE_KD_GATE
from volrt_torch.core import sampling
from volrt_torch.core.types import Raycaster, View
from volrt_torch.renderers.cuda import rays
from volrt_torch.renderers.cuda.march import march_fwd
from volrt_torch.utils import trace

NAME = "pallas-v3"


def render_float(rc: Raycaster, fast: bool = False
                 ) -> tuple[torch.Tensor, float]:
    """Render to ``(f32[H, W, 4] image, overflow count)``.

    The overflow count is always 0: the TPU kernel counts samples that fell
    outside its planned window bricks, and the port's kernel has no windows;
    every ray loads its own taps. It stays in the return so that callers of
    both packages match.

    ``rc.esl`` skips every sample whose trilinear cell lies in ESL blocks
    that the TF leaves empty (the kernel's ESL mode, on the render state's
    packed grid ``rc.esl_words``): ``volrt``'s rung 5 drops whole groups
    of samples by the same footprint test, so the port skips those and
    more. The leading leap of rungs 0-4 is not this rung's. Where the
    grid is conservative the image is the ESL-off image; where a block
    is called empty by its TF buckets though the lerped TF gives its
    samples some opacity, it is not, in ``volrt`` too (ROADMAP.md, queue
    3). ``rc.shading == "phong"`` shades with gradient Blinn-Phong under
    ``rc.light_kd``, as ``volrt``'s rung 5 does.
    ``fast=True`` is ``volrt``'s fast mode: the f32 density stored as bf16
    and sampled as ``volrt``'s fast kernels sample it, by the kernel's
    bf16 instance (:func:`march_args`).
    """
    w, h = rc.view.dims
    with trace.span("render", rays=w * h):
        if rc.interpolation != "trilinear":
            raise ValueError("pallas-v3 renders trilinear mode only")
        check_modes(rc, phong=True)
        args, kw = march_args(rc, fast)
        return march_fwd(*args, **kw).reshape(h, w, 4), 0.0


def check_modes(rc: Raycaster, phong: bool = False) -> None:
    """Refuse the modes no kernel of the port has (rungs 2-5). Only rung
    5's kernel has phong (``phong=True``): ``volrt``'s rungs 2-4 render
    the diffuse tap when asked for it, and the port's refuse instead."""
    if rc.shading == "phong" and not phong:
        raise NotImplementedError(
            "phong is a mode of rung 5's kernel only (rungs 0-1 render it "
            "as torch ops); rungs 2-4 have none, as in volrt, which falls "
            "back to the diffuse tap there (ROADMAP.md, queue 1: Shading)")
    if rc.shading not in ("diffuse", "phong"):
        raise ValueError(f"unknown shading: {rc.shading}")


def march_args(rc: Raycaster, fast: bool = False) -> tuple[tuple, dict]:
    """The ray setup: ``(args, kwargs)`` of :func:`march_fwd` for ``rc``,
    with the uint8 volume converted to an f32 density (with ``fast``, that
    density's bf16 copy, as ``volrt``'s ``fwd_v3.py:56`` and
    ``_phase_volumes`` make it), and ESL's grid when ``rc.esl``."""
    data = rc.volume.data
    with trace.span("volume_copy", device=data.device, voxels=data.numel()):
        density = data.to(torch.float32) / 255.0
        if fast:
            density = density.to(torch.bfloat16)
    return ray_args(rc.view, density, rc.transfer_fn, rc.ray_step,
                    rc.ray_threshold, rc.light_kd,
                    phong=rc.shading == "phong",
                    esl=(rc.esl_words, rc.esl_block_dims) if rc.esl else None)


def ray_args(view: View, density: torch.Tensor, premult_tf: torch.Tensor,
             ray_step: float, ray_threshold: float, light_kd: float,
             loss_scale: float = 0.0, esl_start=None,
             phong: bool = False, esl=None) -> tuple[tuple, dict]:
    """``(args, kwargs)`` of the march kernels' wrappers for one view of
    a volume (an f32 ``density`` for rung 5 and the differentiable path,
    or its bf16 copy for the v3 kernels' fast mode) under a premultiplied
    TF; both may require grad.

    Rays come from :func:`rays.ray_setup` (``get_rays``'s raster order,
    in one kernel on the card) and march from ``knear`` to ``kfar``, as
    ``volrt``'s ``prepare_ray_tiles_raw`` sets them up, without its 16x16
    tile packing: the kernels' blocks are pixel patches of the raster image
    already. ``esl_start(o, d, knear, kfar, hit)``, when
    given, returns each ray's start after the leading empty-space leap in
    place of ``knear``. ``loss_scale`` goes to ``scal[6]``, which only the
    one-launch L2 step reads. ``phong=True`` shades with gradient
    Blinn-Phong in place of the diffuse tap: it adds the ``phong`` keyword
    of the v3 kernels' wrappers (``march_fwd``, ``march_bwd``,
    ``l2_step``), which the ladder's do not take; ``esl``, the ESL grid
    ``(words, block)`` of their ESL mode, adds their ``esl`` keyword.
    """
    dev = density.device
    w, h = view.dims
    with trace.span("ray_setup", device=dev, rays=w * h):
        o, d, knear, kfar, hit, scal = rays.ray_setup(
            view, ray_threshold, light_kd, loss_scale)
        # A ray that meets the cube has knear < kfar: it marches unless
        # the leap takes it past kfar.
        alive = hit
        if esl_start is not None:
            knear = esl_start(o, d, knear, kfar, hit)
            alive = hit & (knear <= kfar)
        args = (o, d, knear, kfar, alive, density, premult_tf.contiguous(),
                scal)
        kw = dict(
            ray_step=ray_step,
            # The tap contributes nothing unless kd passes its gate.
            shade=light_kd > SHADE_KD_GATE,
            # Opacity never exceeds 1, so a threshold >= 1 is never crossed.
            no_ert=ray_threshold >= 1.0,
            width=view.dims[0])
        if phong:
            kw.update(shade=False, phong=kw["shade"])
        if esl is not None:
            kw["esl"] = esl
    return args, kw


def render(rc: Raycaster) -> torch.Tensor:
    """Render to ``uint8[H, W, 4]``."""
    img, _ = render_float(rc)
    return sampling.write_color(img)
