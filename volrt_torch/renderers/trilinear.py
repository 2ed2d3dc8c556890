"""Renderer 3 (``pallas-trilinear``) on the card: the counterpart of
``volrt/renderers/pallas/trilinear.py:388-418``.

Trilinear sampling with CUDA-texture semantics and the linearly
interpolated TF (reference: GPURenderer4.cu:53-87), after the leading
empty-space leap. Ray setup is torch ops; the leap is
:func:`volrt_torch.renderers.cuda.leap.esl_start` and the march
:func:`volrt_torch.renderers.cuda.march.march_tri` over the volume as f32
raw values. The TPU kernel's ``(wz, wy)`` windows, its ``window=`` argument
and its ``W <= 128`` bound do not exist here: every ray loads its own taps
from a volume of any size.
"""
from __future__ import annotations

import torch

from volrt_torch.core import sampling
from volrt_torch.core.types import Raycaster
from volrt_torch.renderers import fwd_v3
from volrt_torch.renderers.cuda import leap
from volrt_torch.renderers.cuda.march import march_tri

NAME = "pallas-trilinear"


def ladder_args(rc: Raycaster, volume: torch.Tensor,
                shade: bool = True) -> tuple[tuple, dict]:
    """``(args, kwargs)`` of rungs 2-4's march wrappers for ``rc`` over
    ``volume`` (``rc.volume.data`` in the type the rung's kernel reads):
    :func:`fwd_v3.ray_args` with the leading ESL leap (the leap kernel,
    on the render state's distance grid) as each ray's start when
    ``rc.esl``. ``shade=False`` skips the diffuse tap whatever
    ``rc.light_kd`` says."""
    fwd_v3.check_modes(rc)
    esl_start = None
    if rc.esl:
        def esl_start(o, d, knear, kfar, hit):
            return leap.esl_start(o, d, knear, kfar, hit, rc.esl_dist,
                                  rc.volume.dims, rc.esl_block_dims,
                                  rc.esl_block_size, rc.ray_step)
    args, kw = fwd_v3.ray_args(
        rc.view, volume, rc.transfer_fn, rc.ray_step, rc.ray_threshold,
        rc.light_kd, esl_start=esl_start)
    kw["shade"] = kw["shade"] and shade
    return args, kw


def render_float(rc: Raycaster, shade: bool = True
                 ) -> tuple[torch.Tensor, float]:
    """Render to ``(f32[H, W, 4] image, overflow count)``. The count is
    always 0 (no windows) and stays so that callers of both packages match.

    ``shade=False`` skips the diffuse light tap; with ``shade=True`` it is
    taken when ``rc.light_kd`` passes its gate, which gives the same image
    as evaluating the gated tap on every sample."""
    if rc.interpolation != "trilinear":
        raise ValueError("pallas-trilinear renders trilinear mode only")
    args, kw = ladder_args(rc, rc.volume.data.to(torch.float32), shade)
    w, h = rc.view.dims
    return march_tri(*args, nearest=False, **kw).reshape(h, w, 4), 0.0


def render(rc: Raycaster) -> torch.Tensor:
    """Render to ``uint8[H, W, 4]``."""
    img, _ = render_float(rc)
    return sampling.write_color(img)
