"""Per-sample march math shared by the port's renderers
(the counterparts of ``volrt/renderers/common.py:69-114``, trilinear mode
with the one-tap diffuse; phong is not ported yet)."""
from __future__ import annotations

import torch

from volrt_torch.constants import (
    SHADE_ALPHA_GATE,
    SHADE_KD_GATE,
    SHADE_LIGHT_OFFSET,
)
from volrt_torch.core import sampling


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def classify_and_shade(density: torch.Tensor, transfer_fn: torch.Tensor,
                       pt: torch.Tensor, light_pos: torch.Tensor | None = None,
                       light_kd: torch.Tensor | float = 0.0) -> torch.Tensor:
    """Sample ``density`` at world points ``pt (..., 3)``, classify through
    the premultiplied TF and, when ``light_pos`` is given, apply the
    reference's one-tap diffuse: a second trilinear tap ``SHADE_LIGHT_OFFSET``
    toward the light adds ``(s_light - s) * kd`` to RGB where alpha and kd
    pass their gates (reference: RaycasterBase.h:87-98,
    GPURenderer4.cu:41-51,76-79). Returns premultiplied RGBA ``(..., 4)``.
    """
    sample = sampling.sample_trilinear_f(density, pt)
    color = sampling.tf_lookup_linear(transfer_fn, sample)
    if light_pos is None:
        return color
    light_dir = normalize(light_pos - pt)
    gate = (color[..., 3] > SHADE_ALPHA_GATE) & (light_kd > SHADE_KD_GATE)
    sample_l = sampling.sample_trilinear_f(
        density, pt + light_dir * SHADE_LIGHT_OFFSET)
    diffuse = torch.where(gate, (sample_l - sample) * light_kd, 0.0)
    rgb = color[..., :3] + diffuse[..., None]
    return torch.cat([rgb, color[..., 3:4]], dim=-1)


def composite(acc: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """Front-to-back premultiplied compositing step:
    ``C_out = C_in + C * (1 - alpha_in)`` (reference: CPURenderer.cpp:34)."""
    return acc + color * (1.0 - acc[..., 3:4])
