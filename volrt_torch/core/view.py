"""Orbit camera (the counterpart of ``volrt/core/view.py``).

Host-side numpy state that snapshots a :class:`View` per frame. Rebuilds
the reference's ``ViewBase`` (reference: ViewBase.cpp) without OpenGL: the
GL matrix stack collapses to one effective rotation ``C``, right-multiplied
by ``R_axis(-angle)`` per axis (reference: ViewBase.cpp:26-47).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from volrt_torch.constants import DEFAULT_WIN_HEIGHT, DEFAULT_WIN_WIDTH
from volrt_torch.core.types import View

# Camera distance limits (reference: ViewBase.cpp:17).
DISTANCE_LIMITS = (0.1, 3.0)
# Virtual view-plane size in model space for perspective mode
# (reference: ViewBase.cpp:103).
PERSPECTIVE_VIEW_SIZE = 1.5


def _rot_x(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rot_y(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_z(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _compose(angles: tuple[float, float, float]) -> np.ndarray:
    """The per-update rotation increment: ``Rx(-ax) @ Ry(-ay) @ Rz(-az)``."""
    ax, ay, az = angles
    return _rot_x(-ax) @ _rot_y(-ay) @ _rot_z(-az)


class Camera:
    """Mutable orbit-camera state (the ``ViewBase`` equivalent)."""

    def __init__(
        self,
        dims: tuple[int, int] = (DEFAULT_WIN_WIDTH, DEFAULT_WIN_HEIGHT),
        perspective: bool = False,
    ):
        self.dims = dims
        self.perspective = perspective
        self.cam_rot = np.eye(3, dtype=np.float32)
        self.light_rot = np.eye(3, dtype=np.float32)
        self.cam_dist = 3.0           # reference: ViewBase.cpp:18 cam_pos.z
        self.light_dist = 3.0
        self.virtual_view_size = 3.0  # reference: ViewBase.cpp:24

    def rotate(self, angles: tuple[float, float, float],
               reset: bool = False) -> None:
        inc = _compose(angles)
        self.cam_rot = (
            np.eye(3, dtype=np.float32) if reset else self.cam_rot) @ inc

    def zoom(self, distance: float) -> None:
        self.cam_dist = float(
            np.clip(self.cam_dist + distance, *DISTANCE_LIMITS))
        if not self.perspective:
            self.virtual_view_size = self.cam_dist

    def set_camera_position(
        self, angles: tuple[float, float, float], distance: float = 3.0
    ) -> None:
        # Reference: ViewBase.cpp:85-89.
        self.cam_dist = 0.0
        self.zoom(distance)
        self.rotate(angles, reset=True)

    def toggle_perspective(self, update_mode: bool = False) -> None:
        # Reference: ViewBase.cpp:100-105.
        if not update_mode:
            self.perspective = not self.perspective
        self.virtual_view_size = (
            PERSPECTIVE_VIEW_SIZE if self.perspective else self.cam_dist)

    def view(self, device: torch.device | str = "cpu") -> View:
        """Snapshot the current state as a :class:`View` on ``device``
        (reference: ViewBase.cpp:49-55 update_view)."""
        origin = self.cam_rot @ np.array([0, 0, self.cam_dist], np.float32)
        direction = -origin / np.linalg.norm(origin)
        w, h = self.dims
        step_px = self.virtual_view_size / min(w, h)
        right = self.cam_rot @ np.array([step_px, 0, 0], np.float32)
        up = self.cam_rot @ np.array([0, step_px, 0], np.float32)
        light = self.light_rot @ np.array([0, 0, self.light_dist], np.float32)
        return View.from_arrays(origin, direction, right, up, light,
                                self.dims, self.perspective, device)
