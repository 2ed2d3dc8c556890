"""Per-sample march math shared by the port's renderers (the counterparts
of ``volrt/renderers/common.py``: both interpolations, the one-tap diffuse
and gradient Blinn-Phong)."""
from __future__ import annotations

import torch

from volrt_torch.constants import (
    PHONG_KA,
    PHONG_KS,
    PHONG_SHININESS,
    SHADE_ALPHA_GATE,
    SHADE_KD_GATE,
    SHADE_LIGHT_OFFSET,
)
from volrt_torch.core import sampling


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _safe_normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / n.clamp(min=eps)


def gradient_normal(grid: torch.Tensor, pt: torch.Tensor,
                    sampler) -> torch.Tensor:
    """Central-difference density gradient at world points -> unit normals
    pointing against increasing density (outward from dense features).
    ``sampler(grid, pos)`` reads the grid on the [0, 1] scale; the taps lie
    one voxel to either side along each axis."""
    d, h, w = grid.shape
    comps = []
    for axis, n in ((0, w), (1, h), (2, d)):
        off = torch.zeros(3, dtype=torch.float32, device=pt.device)
        off[axis] = 2.0 / n
        comps.append(sampler(grid, pt + off) - sampler(grid, pt - off))
    return -_safe_normalize(torch.stack(comps, dim=-1))


def phong_shade(grid: torch.Tensor, pt: torch.Tensor, color: torch.Tensor,
                sampler, light_pos: torch.Tensor,
                light_kd: torch.Tensor | float,
                view_dir: torch.Tensor) -> torch.Tensor:
    """Blinn-Phong over gradient normals, applied to the RGB of the
    premultiplied ``color (..., 4)``
    (``volrt/renderers/common.py:phong_shade``)::

        rgb' = rgb * (ka + kd * max(N.L, 0)) + ks * max(N.H, 0)^n * alpha

    with N the central-difference gradient normal, L the light direction
    and H the half vector between L and the reversed ray direction
    ``view_dir`` (unnormalised). Gated like the diffuse tap."""
    rgb, alpha = color[..., :3], color[..., 3]
    light_dir = normalize(light_pos - pt)
    nrm = gradient_normal(grid, pt, sampler)
    half = _safe_normalize(light_dir + _safe_normalize(-view_dir))
    ndl = (nrm * light_dir).sum(-1).clamp(min=0.0)
    ndh = (nrm * half).sum(-1).clamp(min=0.0)
    lit = rgb * (PHONG_KA + light_kd * ndl)[..., None] + (
        PHONG_KS * ndh ** PHONG_SHININESS * alpha)[..., None]
    gate = (alpha > SHADE_ALPHA_GATE) & (light_kd > SHADE_KD_GATE)
    return torch.cat([torch.where(gate[..., None], lit, rgb),
                      color[..., 3:4]], dim=-1)


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
                       interpolation: str = "density",
                       shading: str = "diffuse",
                       view_dir: torch.Tensor | None = None) -> torch.Tensor:
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

    ``shading="phong"`` replaces the one-tap diffuse with gradient
    Blinn-Phong (:func:`phong_shade`) and needs ``view_dir``, the
    unnormalised ray direction.
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
    if shading == "phong":
        if view_dir is None:
            raise ValueError("phong shading requires the ray direction")
        return phong_shade(grid, pt, color, sampler, light_pos, light_kd,
                           view_dir)
    return add_diffuse(
        color, sampler(grid, light_tap(pt, light_pos)) - sample, light_kd)


def composite(acc: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """Front-to-back premultiplied compositing step:
    ``C_out = C_in + C * (1 - alpha_in)`` (reference: CPURenderer.cpp:34)."""
    return acc + color * (1.0 - acc[..., 3:4])
