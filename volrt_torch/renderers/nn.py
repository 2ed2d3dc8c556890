"""Renderer 2 (``pallas-nn``) on the card: the counterpart of
``volrt/renderers/pallas/nn.py``.

Nearest sampling by ``map_float_int`` truncation and the bucketed TF
(reference: GPURenderer23.cu:20-53), through rung 3's kernel in its nearest
mode, as the JAX package rides ``trilinear.render_tiles(nearest=True)``.
The TPU rung's ``W <= 128`` bound is a VMEM limit and is not carried over:
this rung takes a volume of any size.
"""
from __future__ import annotations

import torch

from volrt_torch.core import sampling
from volrt_torch.core.types import Raycaster
from volrt_torch.renderers.cuda.march import march_tri
from volrt_torch.renderers.trilinear import ladder_args

NAME = "pallas-nn"


def render_float(rc: Raycaster, shade: bool = True) -> torch.Tensor:
    """Render to a float RGBA image ``f32[H, W, 4]``. ``shade`` is ignored,
    as in the JAX package: this rung takes the diffuse tap whenever
    ``rc.light_kd`` passes its gate. Nor is ``rc.interpolation`` read: the
    rung is nearest by definition."""
    del shade
    args, kw = ladder_args(rc, rc.volume.data.to(torch.float32))
    w, h = rc.view.dims
    return march_tri(*args, nearest=True, **kw).reshape(h, w, 4)


def render(rc: Raycaster) -> torch.Tensor:
    """Render to ``uint8[H, W, 4]``."""
    return sampling.write_color(render_float(rc))
