"""Per-sample march math shared by the port's renderers
(the counterparts of ``volrt/renderers/common.py:69-114``, both
interpolations with the one-tap diffuse; phong is not ported yet)."""
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


def add_diffuse(color: torch.Tensor, delta: torch.Tensor,
                light_kd: torch.Tensor | float) -> torch.Tensor:
    """Add the one-tap diffuse ``delta * kd`` to the RGB of ``color
    (..., 4)`` where alpha and kd pass their gates; ``delta`` is the light
    tap's sample minus the sample itself, on the [0, 1] scale
    (reference: RaycasterBase.h:87-98)."""
    gate = (color[..., 3] > SHADE_ALPHA_GATE) & (light_kd > SHADE_KD_GATE)
    diffuse = torch.where(gate, delta * light_kd, 0.0)
    rgb = color[..., :3] + diffuse[..., None]
    return torch.cat([rgb, color[..., 3:4]], dim=-1)


def light_tap(pt: torch.Tensor, light_pos: torch.Tensor) -> torch.Tensor:
    """Where the diffuse tap samples: ``SHADE_LIGHT_OFFSET`` from ``pt``
    toward the light (reference: GPURenderer4.cu:44-46)."""
    return pt + normalize(light_pos - pt) * SHADE_LIGHT_OFFSET


def _sample_nearest_01(grid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return sampling.sample_nearest(grid, pos).to(torch.float32) / 255.0


_SAMPLERS = {
    "density": sampling.sample_trilinear_f,
    "trilinear": sampling.sample_trilinear,
    "nearest": _sample_nearest_01,
}


def classify_and_shade(grid: torch.Tensor, transfer_fn: torch.Tensor,
                       pt: torch.Tensor, light_pos: torch.Tensor | None = None,
                       light_kd: torch.Tensor | float = 0.0,
                       interpolation: str = "density") -> torch.Tensor:
    """Sample ``grid [D, H, W]`` at world points ``pt (..., 3)``, classify
    through the premultiplied TF and, when ``light_pos`` is given, apply the
    reference's one-tap diffuse: a second tap toward the light adds
    ``(s_light - s) * kd`` to RGB where alpha and kd pass their gates
    (reference: RaycasterBase.h:87-98, GPURenderer4.cu:41-51,76-79).
    Returns premultiplied RGBA ``(..., 4)``.

    ``interpolation`` says what the grid holds and how it is read:
    ``"density"``, an f32 density in [0, 1], trilinear with the lerped TF
    (the differentiable path and rung 5); ``"trilinear"``, raw voxel values
    0..255, the same after ``/255``; ``"nearest"``, raw voxel values read
    by truncation, the bucketed TF, and both taps ``/255`` before they are
    subtracted (reference: CPURenderer.cpp:30-33).
    """
    sampler = _SAMPLERS[interpolation]
    if interpolation == "nearest":
        raw = sampling.sample_nearest(grid, pt)
        color = sampling.tf_lookup_bucket(transfer_fn, raw)
        sample = raw.to(torch.float32) / 255.0
    else:
        sample = sampler(grid, pt)
        color = sampling.tf_lookup_linear(transfer_fn, sample)
    if light_pos is None:
        return color
    return add_diffuse(
        color, sampler(grid, light_tap(pt, light_pos)) - sample, light_kd)


def composite(acc: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """Front-to-back premultiplied compositing step:
    ``C_out = C_in + C * (1 - alpha_in)`` (reference: CPURenderer.cpp:34)."""
    return acc + color * (1.0 - acc[..., 3:4])
