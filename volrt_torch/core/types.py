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
    ESL_MIN_BLOCK_SIZE,
    ESL_VOLUME_DIMS,
)
from volrt_torch.core import esl as esl_mod
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
      esl: empty-space leaping. Rungs 0-4 leap over the leading empty
        blocks of each ray; rung 5 skips every sample whose trilinear
        cell lies in empty blocks (``volrt``'s group compaction, taken a
        sample at a time).
      esl_empty: ``bool[32, 32, 32]`` per-block emptiness, ``[z, y, x]``,
        on the volume's device.
      esl_block_dims: voxels per ESL block edge
        (reference: RaycasterBase.cpp:97-99).
      interpolation: ``"nearest"`` (renderers 0-2: uint8 sample, bucketed
        TF) or ``"trilinear"`` (renderers 0-1 and 3-5: trilinear sample in
        [0, 1], linearly interpolated TF).
      shading: ``"diffuse"`` (the reference's one-tap diffuse, a no-op when
        ``light_kd <= SHADE_KD_GATE``) or ``"phong"`` (gradient Blinn-Phong;
        rungs 0-1).
      esl_dist: ``int32[32, 32, 32]``, ``esl_empty``'s distance grid (the
        leading leap's) and
      esl_words: ``int32[1024]``, ``esl_empty`` packed (rung 5's skipping):
        what the kernels read of ``esl_empty``, derived from it
        (:func:`esl_mod.esl_tables`) when a state is made without them,
        and by :meth:`replace` whenever it is given a new ``esl_empty``; a
        ``replace`` of anything else carries them over, so a frame's new
        view does not rebuild them. ``volrt``'s state holds ``esl_empty``
        alone, so this keeps the two packages' ``replace`` alike.
    """

    volume: Volume
    view: View
    transfer_fn: torch.Tensor
    ray_step: float
    ray_threshold: float
    light_kd: float
    esl_empty: torch.Tensor
    esl_block_dims: int
    esl: bool = False
    interpolation: str = "trilinear"
    shading: str = "diffuse"
    esl_dist: torch.Tensor | None = None
    esl_words: torch.Tensor | None = None

    def __post_init__(self):
        if self.esl_dist is None or self.esl_words is None:
            dist, words = esl_mod.esl_tables(self.esl_empty)
            object.__setattr__(self, "esl_dist", dist)
            object.__setattr__(self, "esl_words", words)

    @property
    def device(self) -> torch.device:
        return self.volume.data.device

    @property
    def esl_block_size(self) -> tuple[float, float, float]:
        # Reference: RaycasterBase.cpp:118-122.
        w, h, d = self.volume.dims
        b = float(self.esl_block_dims)
        return (2.0 * b / w, 2.0 * b / h, 2.0 * b / d)

    def replace(self, **kw: Any) -> "Raycaster":
        """A copy with the fields ``kw`` changed. A new ``esl_empty``
        brings new ``esl_dist`` and ``esl_words``, derived from it; the
        tables cannot be replaced on their own."""
        tables = {"esl_dist", "esl_words"} & kw.keys()
        if tables:
            raise ValueError(f"{sorted(tables)} are derived from esl_empty: "
                             f"replace esl_empty instead")
        if "esl_empty" in kw:
            kw.update(esl_dist=None, esl_words=None)
        return dataclasses.replace(self, **kw)


def default_esl_block_dims(dims: tuple[int, int, int]) -> int:
    """Voxels per ESL block edge (reference: RaycasterBase.cpp:97-99)."""
    return max(ESL_MIN_BLOCK_SIZE, -(-max(dims) // ESL_VOLUME_DIMS))


def _check_interpolation(interpolation: str) -> str:
    if interpolation not in ("nearest", "trilinear"):
        raise ValueError(f"unknown interpolation: {interpolation}")
    return interpolation


def default_ray_step(dims: tuple[int, int, int]) -> float:
    """Auto ray step from the largest dimension (reference: RaycasterBase.cpp:86-92)."""
    max_dim = max(dims)
    step = 2.0 / max_dim
    return step - step / max_dim


def ray_step_limits(dims: tuple[int, int, int]) -> tuple[float, float]:
    """Legal ray-step range (reference: RaycasterBase.cpp:90-91)."""
    step = default_ray_step(dims)
    return (step / 3.0, step * 1.666)


def make_raycaster(
    volume: Volume,
    view: View | None = None,
    base_transfer_fn=None,
    *,
    ray_step: float | None = None,
    ray_threshold: float = DEFAULT_RAY_THRESHOLD,
    esl: bool = True,
    light_kd: float = DEFAULT_LIGHT_KD,
    interpolation: str = "nearest",
    shading: str = "diffuse",
) -> Raycaster:
    """Assemble a render state on the volume's device, premultiplying the
    base TF and deriving the ESL grid from volume and TF like the
    reference's ``set_volume`` and ``reset_transfer_fn``
    (reference: RaycasterBase.cpp:76-125), and what the kernels read of
    it (:func:`esl_mod.esl_tables`)."""
    device = volume.data.device
    view = View.default(device) if view is None else view.to(device)
    if base_transfer_fn is None:
        base_transfer_fn = tf_mod.default_transfer_fn(device)
    base = torch.as_tensor(base_transfer_fn, dtype=torch.float32,
                           device=device)
    if ray_step is None:
        ray_step = default_ray_step(volume.dims)
    premult = tf_mod.premultiply(base)
    block_dims = default_esl_block_dims(volume.dims)
    empty = esl_mod.derive_empty_grid(
        esl_mod.build_min_max_grid(volume.data, block_dims), premult)
    return Raycaster(
        volume=volume,
        view=view,
        transfer_fn=premult,
        ray_step=float(ray_step),
        ray_threshold=float(ray_threshold),
        light_kd=float(light_kd),
        esl_empty=empty,
        esl_block_dims=block_dims,
        esl=bool(esl),
        interpolation=_check_interpolation(interpolation),
        shading=shading,
    )


def raycaster_from_arrays(
    volume, premult_tf, origin, direction, right_plane, up_plane, light_pos,
    dims, perspective, ray_step, ray_threshold, light_kd,
    shading: str = "diffuse", *, interpolation: str = "trilinear",
    esl: bool = False, esl_empty=None, esl_block_dims: int | None = None,
    device: torch.device | str | None = None,
) -> Raycaster:
    """Carry a JAX render state across as numpy arrays.

    ``volume`` is the ``uint8[D, H, W]`` grid, ``premult_tf`` the already
    premultiplied ``f32[TF_SIZE, 4]`` LUT, and the view vectors, ``dims``
    ``(W, H)`` and ``perspective`` those of a ``volrt`` ``View``.
    ``esl_empty`` (``bool[32, 32, 32]``) and ``esl_block_dims`` carry the
    other package's emptiness grid; left ``None`` they are derived here
    from volume and TF. Returns the port's :class:`Raycaster` on ``device``
    (the card when ``None``).
    """
    device = resolve_device(device)
    vol = Volume.from_numpy(np.asarray(volume), device)
    premult = torch.tensor(np.asarray(premult_tf, np.float32), device=device)
    if esl_block_dims is None:
        esl_block_dims = default_esl_block_dims(vol.dims)
    if esl_empty is None:
        empty = esl_mod.derive_empty_grid(
            esl_mod.build_min_max_grid(vol.data, esl_block_dims), premult)
    else:
        empty = torch.tensor(np.asarray(esl_empty, np.bool_), device=device)
        if empty.shape != (ESL_VOLUME_DIMS,) * 3:
            raise ValueError(
                f"esl_empty must be {(ESL_VOLUME_DIMS,) * 3}, "
                f"got {tuple(empty.shape)}")
    return Raycaster(
        volume=vol,
        view=View.from_arrays(origin, direction, right_plane, up_plane,
                              light_pos, dims, perspective, device),
        transfer_fn=premult,
        ray_step=float(ray_step),
        ray_threshold=float(ray_threshold),
        light_kd=float(light_kd),
        esl_empty=empty,
        esl_block_dims=int(esl_block_dims),
        esl=bool(esl),
        interpolation=_check_interpolation(interpolation),
        shading=shading,
    )
