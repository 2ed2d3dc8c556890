"""Renderer 4 (``pallas-blocked``) on the card: the counterpart of
``volrt/renderers/pallas/blocked.py:374-404``.

The same trilinear sampling and interpolated TF as rung 3
(reference: GPURenderer4.cu:53-87), marched straight from the uint8 volume
in device memory: :func:`volrt_torch.renderers.cuda.march.march_blocked`
converts each tap after its fetch, so a frame makes no f32 copy of the
volume. The TPU kernel's brick DMA, pads and windows are not carried over.
"""
from __future__ import annotations

import torch

from volrt_torch.core import sampling
from volrt_torch.core.types import Raycaster
from volrt_torch.renderers.cuda.march import march_blocked
from volrt_torch.renderers.trilinear import ladder_args

NAME = "pallas-blocked"


def render_float(rc: Raycaster, shade: bool = True
                 ) -> tuple[torch.Tensor, float]:
    """Render to ``(f32[H, W, 4] image, overflow count)``; the count is
    always 0. ``shade=False`` skips the diffuse light tap."""
    if rc.interpolation != "trilinear":
        raise ValueError("pallas-blocked renders trilinear mode only")
    args, kw = ladder_args(rc, rc.volume.data, shade)
    w, h = rc.view.dims
    return march_blocked(*args, **kw).reshape(h, w, 4), 0.0


def render(rc: Raycaster) -> torch.Tensor:
    """Render to ``uint8[H, W, 4]``."""
    img, _ = render_float(rc)
    return sampling.write_color(img)
