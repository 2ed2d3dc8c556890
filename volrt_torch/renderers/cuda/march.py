"""The forward march: the CUDA kernel's wrapper and its plain torch version.

``march_fwd`` is the port of ``volrt/renderers/pallas/diff_v3.py:_fwd_kernel``
(unshaded and diffuse modes, f32). On CUDA tensors it launches
``csrc/march_fwd.cu``; on CPU tensors it runs ``march_fwd_plain``, the
lockstep torch march built from ``core/sampling`` and
``renderers/common``, which is also the reference the kernel is held to.
"""
from __future__ import annotations

import ctypes
import math

import torch

from volrt_torch import _build
from volrt_torch.constants import TF_SIZE
from volrt_torch.renderers.common import classify_and_shade, composite

# Pixel block edge of the kernel (csrc/march_fwd.cu: TILE).
TILE = 16
# Rays per lockstep chunk of the plain march: keeps 1024^2 in memory.
PLAIN_CHUNK = 1 << 18

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I,
             ctypes.c_float, _I, _I, _I, _P]


def max_steps(ray_step: float) -> int:
    """Samples a ray may take: the cube's chord over the step, plus two
    (as ``volrt/diff/render.py:_march_n_steps``). Every ray a view builds
    has ``|d| >= 1``, so none needs more."""
    return int(math.ceil(2.0 * math.sqrt(3.0) / ray_step)) + 2


def _check(o, d, k0, kfar, alive, density, premult_tf, scal, width) -> None:
    n = o.shape[0] if o.dim() == 2 else -1
    want = {
        "o": (o, torch.float32, (n, 3)),
        "d": (d, torch.float32, (n, 3)),
        "k0": (k0, torch.float32, (n,)),
        "kfar": (kfar, torch.float32, (n,)),
        "alive": (alive, torch.bool, (n,)),
        "density": (density, torch.float32, tuple(density.shape)),
        "premult_tf": (premult_tf, torch.float32, (TF_SIZE, 4)),
        "scal": (scal, torch.float32, (8,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != o.device:
            raise ValueError(f"{name} is on {t.device}, o on {o.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if density.dim() != 3 or density.numel() >= 2 ** 31:
        raise ValueError("density must be [D, H, W] with under 2^31 voxels")
    if width <= 0 or n % width:
        raise ValueError(f"width {width} does not divide the {n} rays")
    if -(-(n // width) // TILE) > 65535:
        raise ValueError(f"{n // width} image rows exceed the launch grid")


def march_fwd(o, d, k0, kfar, alive, density, premult_tf, scal, *,
              ray_step: float, shade: bool, no_ert: bool,
              width: int) -> torch.Tensor:
    """March N rays through ``density`` and composite them -> ``f32[N, 4]``.

    Args:
      o, d: ``f32[N, 3]`` ray origins and directions, in image raster order
        (``width`` rays per row), so that the kernel's 16x16 blocks are
        16x16 pixel patches.
      k0, kfar: ``f32[N]`` first-sample and exit ray parameters; samples
        lie at ``k0 + i*ray_step`` for ``k <= kfar``.
      alive: ``bool[N]``, rays that take any sample.
      density: ``f32[D, H, W]`` volume.
      premult_tf: ``f32[TF_SIZE, 4]`` premultiplied RGBA LUT.
      scal: ``f32[8]``: ERT threshold, light kd, light position xyz, then
        three unused slots (the JAX kernel's ``scal`` row).
      shade: apply the one-tap diffuse.
      no_ert: the threshold is >= 1 and can never be crossed.

    CPU tensors take :func:`march_fwd_plain`. CUDA tensors launch the
    kernel, building it at first use, and raise if it cannot launch.
    """
    _check(o, d, k0, kfar, alive, density, premult_tf, scal, width)
    if o.device.type == "cpu":
        return march_fwd_plain(
            o, d, k0, kfar, alive, density, premult_tf, scal,
            ray_step=ray_step, shade=shade, no_ert=no_ert, width=width)
    if o.device.type != "cuda":
        raise ValueError(f"march_fwd runs on cpu or cuda, not {o.device}")
    n = o.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=o.device)
    if n == 0:
        return out
    lib = _build.load()
    fn = lib.volrt_march_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    depth, h, w = density.shape
    with torch.cuda.device(o.device):
        err = fn(o.data_ptr(), d.data_ptr(), k0.data_ptr(), kfar.data_ptr(),
                 alive.data_ptr(), density.data_ptr(), w, h, depth,
                 premult_tf.data_ptr(), scal.data_ptr(), out.data_ptr(),
                 n, width, ray_step, max_steps(ray_step), int(shade),
                 int(no_ert), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"march_fwd kernel launch failed: CUDA error {err}")
    march_fwd.launches += 1
    return out


march_fwd.launches = 0


def march_fwd_plain(o, d, k0, kfar, alive, density, premult_tf, scal, *,
                    ray_step: float, shade: bool, no_ert: bool,
                    width: int) -> torch.Tensor:
    """The plain torch version of :func:`march_fwd`, same arguments.

    All rays of a chunk step in lockstep for ``max_steps(ray_step)`` steps,
    with masks in place of the kernel's per-ray ``break``. ``width`` only
    shapes the kernel's blocks and is unused here.
    """
    del width
    out = torch.empty((o.shape[0], 4), dtype=torch.float32, device=o.device)
    steps = torch.arange(max_steps(ray_step), dtype=torch.float32,
                         device=o.device) * ray_step
    thr, kd, light_pos = scal[0], scal[1], scal[2:5]
    for lo in range(0, o.shape[0], PLAIN_CHUNK):
        sl = slice(lo, lo + PLAIN_CHUNK)
        oc, dc, kc, kf = o[sl], d[sl], k0[sl], kfar[sl]
        live = alive[sl].clone()
        acc = torch.zeros((oc.shape[0], 4), dtype=torch.float32,
                          device=o.device)
        for step in steps:
            k = kc + step
            active = live & (k <= kf)
            pt = oc + dc * k[:, None]
            color = classify_and_shade(
                density, premult_tf, pt,
                light_pos=light_pos if shade else None, light_kd=kd)
            acc = torch.where(active[:, None], composite(acc, color), acc)
            if not no_ert:
                live &= ~(active & (acc[:, 3] > thr))
        out[sl] = acc
    return out
