"""Core render-state types of the port.

The counterparts of ``volrt/core/types.py``, as small frozen dataclasses
over torch tensors in place of jax pytrees. The voxel grid is stored
z-major as ``(D, H, W)`` = ``[z, y, x]`` (reference: ModelBase.h:17-23);
world positions are ``(x, y, z)`` in the cube ``[-1, 1]^3``.

Scalars that the JAX package traces (``ray_threshold``, ``light_kd``) are
plain Python floats here: PyTorch runs eagerly, so the renderer can decide
on the host whether ERT and the shade tap can ever fire and pick the
kernel's variant without reading the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from volrt_torch.constants import (
    DEFAULT_LIGHT_KD,
    DEFAULT_RAY_THRESHOLD,
    DEFAULT_WIN_HEIGHT,
    DEFAULT_WIN_WIDTH,
)
from volrt_torch.core import tf as tf_mod
from volrt_torch.core.device import default_device, resolve_device  # noqa: F401


def _vec3(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32).reshape(3),
                        device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class Volume:
    """A scalar voxel volume in the cube ``[-1, 1]^3``.

    Attributes:
      data: ``uint8[D, H, W]`` voxel grid, ``[z, y, x]`` order.
      dims: ``(W, H, D)``, the reference's ``dims.{x,y,z}`` convention
        (reference: ModelBase.h:14).
    """

    data: torch.Tensor
    dims: tuple[int, int, int]

    @property
    def min_bound(self) -> tuple[float, float, float]:
        # Reference: ModelBase.cpp:13 — the cube is always [-1,1]^3.
        return (-1.0, -1.0, -1.0)

    @classmethod
    def from_numpy(cls, arr: np.ndarray,
                   device: torch.device | str | None = None) -> "Volume":
        """Build from a ``(D, H, W)`` uint8 array on ``device`` (the card
        when ``None``)."""
        if arr.ndim != 3:
            raise ValueError(f"expected 3D array, got shape {arr.shape}")
        arr = np.asarray(arr, dtype=np.uint8)
        d, h, w = arr.shape
        return cls(data=torch.tensor(arr, device=resolve_device(device)),
                   dims=(w, h, d))


@dataclasses.dataclass(frozen=True)
class View:
    """Projection parameters for one frame (reference: ViewBase.h:14-36).

    ``origin``, ``direction``, ``right_plane``, ``up_plane`` and
    ``light_pos`` are ``f32[3]`` tensors on one device; ``dims`` is the
    viewport ``(W, H)``.
    """

    origin: torch.Tensor
    direction: torch.Tensor
    right_plane: torch.Tensor
    up_plane: torch.Tensor
    light_pos: torch.Tensor
    dims: tuple[int, int]
    perspective: bool

    @classmethod
    def from_arrays(cls, origin, direction, right_plane, up_plane, light_pos,
                    dims, perspective,
                    device: torch.device | str | None = None) -> "View":
        return cls(
            origin=_vec3(origin, device),
            direction=_vec3(direction, device),
            right_plane=_vec3(right_plane, device),
            up_plane=_vec3(up_plane, device),
            light_pos=_vec3(light_pos, device),
            dims=(int(dims[0]), int(dims[1])),
            perspective=bool(perspective),
        )

    @classmethod
    def default(cls, device: torch.device | str | None = None) -> "View":
        # Reference: ViewBase.cpp:8-15.
        w, h = DEFAULT_WIN_WIDTH, DEFAULT_WIN_HEIGHT
        step_px = np.float32(3.0 / min(w, h))
        return cls.from_arrays(
            origin=[0.0, 0.0, 3.0],
            direction=[0.0, 0.0, -1.0],
            right_plane=np.array([0.0, 0.0, -1.0], np.float32) * step_px,
            up_plane=np.array([0.0, 1.0, 0.0], np.float32) * step_px,
            light_pos=[0.0, 0.0, 3.0],
            dims=(w, h), perspective=False, device=device)

    def to(self, device: torch.device | str) -> "View":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in (
                "origin", "direction", "right_plane", "up_plane",
                "light_pos")})


@dataclasses.dataclass(frozen=True)
class Raycaster:
    """The full render state for one frame (reference: RaycasterBase.h:20-31).

    Attributes:
      volume: the voxel grid; its device is the render's device.
      view: camera and projection, on the volume's device.
      transfer_fn: premultiplied RGBA LUT ``f32[TF_SIZE, 4]``
        (reference: RaycasterBase.cpp:46-52).
      ray_step: march step in world units (reference: RaycasterBase.h:24).
      ray_threshold: ERT opacity threshold; ``>= 1`` turns ERT off
        (reference: RaycasterBase.h:25).
      light_kd: diffuse light intensity.
      esl: empty-space leaping requested. The port has no ESL grid yet and
        marches every sample, which gives the same image.
      shading: ``"diffuse"`` (the reference's one-tap diffuse, a no-op when
        ``light_kd <= SHADE_KD_GATE``) or ``"phong"`` (not ported yet).
    """

    volume: Volume
    view: View
    transfer_fn: torch.Tensor
    ray_step: float
    ray_threshold: float
    light_kd: float
    esl: bool = False
    shading: str = "diffuse"

    @property
    def device(self) -> torch.device:
        return self.volume.data.device

    def replace(self, **kw: Any) -> "Raycaster":
        return dataclasses.replace(self, **kw)


def default_ray_step(dims: tuple[int, int, int]) -> float:
    """Auto ray step from the largest dimension (reference: RaycasterBase.cpp:86-92)."""
    max_dim = max(dims)
    step = 2.0 / max_dim
    return step - step / max_dim


def make_raycaster(
    volume: Volume,
    view: View | None = None,
    base_transfer_fn=None,
    *,
    ray_step: float | None = None,
    ray_threshold: float = DEFAULT_RAY_THRESHOLD,
    esl: bool = True,
    light_kd: float = DEFAULT_LIGHT_KD,
    shading: str = "diffuse",
) -> Raycaster:
    """Assemble a render state on the volume's device, premultiplying the
    base TF like the reference's ``reset_transfer_fn``
    (reference: RaycasterBase.cpp:76-125)."""
    device = volume.data.device
    view = View.default(device) if view is None else view.to(device)
    if base_transfer_fn is None:
        base_transfer_fn = tf_mod.default_transfer_fn(device)
    base = torch.as_tensor(base_transfer_fn, dtype=torch.float32,
                           device=device)
    if ray_step is None:
        ray_step = default_ray_step(volume.dims)
    return Raycaster(
        volume=volume,
        view=view,
        transfer_fn=tf_mod.premultiply(base),
        ray_step=float(ray_step),
        ray_threshold=float(ray_threshold),
        light_kd=float(light_kd),
        esl=bool(esl),
        shading=shading,
    )


def raycaster_from_arrays(
    volume, premult_tf, origin, direction, right_plane, up_plane, light_pos,
    dims, perspective, ray_step, ray_threshold, light_kd,
    shading: str = "diffuse", *, device: torch.device | str | None = None,
) -> Raycaster:
    """Carry a JAX render state across as numpy arrays.

    ``volume`` is the ``uint8[D, H, W]`` grid, ``premult_tf`` the already
    premultiplied ``f32[TF_SIZE, 4]`` LUT, and the view vectors, ``dims``
    ``(W, H)`` and ``perspective`` those of a ``volrt`` ``View``. Returns
    the port's :class:`Raycaster` on ``device`` (the card when ``None``)
    with ESL off.
    """
    device = resolve_device(device)
    return Raycaster(
        volume=Volume.from_numpy(np.asarray(volume), device),
        view=View.from_arrays(origin, direction, right_plane, up_plane,
                              light_pos, dims, perspective, device),
        transfer_fn=torch.tensor(
            np.asarray(premult_tf, np.float32), device=device),
        ray_step=float(ray_step),
        ray_threshold=float(ray_threshold),
        light_kd=float(light_kd),
        esl=False,
        shading=shading,
    )
