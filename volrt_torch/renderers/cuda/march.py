"""The march kernels' wrappers and their plain torch versions.

Hand-written CUDA kernels, one thread per ray. Three replace kernels of
``volrt/renderers/pallas/diff_v3.py`` (unshaded, diffuse and phong modes,
each with ESL and without, f32):

- :func:`march_fwd` (``csrc/march_fwd.cu``): ``_fwd_kernel``, the forward
  march, also in its slab mode (``slab=``: one Z-slab of a deeper volume,
  seeded with the opacity in front of it);
- :func:`march_bwd` (``csrc/march_bwd.cu``): ``_bwd_kernel``, the analytic
  backward, a replay march that scatters ``d_density`` and
  ``d_premult_tf`` (and in slab mode gives the seed's cotangent);
- :func:`l2_step` (``csrc/l2_step.cu``): ``_fused_kernel``, the forward,
  the mean-square loss's cotangent and the backward in one launch.

:class:`MarchFunction` ties the first two into autograd, as the JAX
package's ``render_tiles_v3`` custom_vjp does.

Two more are the forward marches of the renderer ladder
(``csrc/march_ladder.cu``), which accumulate the ray parameter ``k += step``
as rungs 0-1 do instead of ``k0 + i*step``:

- :func:`march_tri`: ``trilinear.py:_kernel`` (rung 3; rung 2 in its nearest
  mode), over an f32 volume of raw values 0..255;
- :func:`march_blocked`: ``blocked.py:_kernel`` (rung 4), over the uint8
  volume, converted on fetch.

The four kernels of the round-1 differentiable routes have their wrappers
in ``round1.py`` beside this file, and the leading ESL leap of rungs 2-4
in ``leap.py``, on this file's helpers.

On CUDA tensors a wrapper launches its kernel (built at first use) or
raises; on CPU tensors it runs its plain version (``*_plain``), a lockstep
torch march built from ``core/sampling`` and ``renderers/common``, which is
also what the kernel is held to on the card. The plain backward repeats
the analytic backward step by step with ``index_add_``; it does not use
autograd, so that autograd through ``diff/render.py`` stays an independent
check of both. Phong is v3's (:func:`phong_v3`: the gradient's taps one
clipped voxel to either side), not rungs 0-1's (``renderers/common.py``:
the world point moved by 2/n, normalised by a division), so that kernel
and plain version take the same operations. ESL (``esl=(words,
block)``) skips a sample when every ESL block of its trilinear cell is
empty (:class:`EslSkip`), where ``volrt`` drops whole groups of samples by
the same footprint test; the forward and the replay skip the same ones.

Gradients are summed with atomics on the card, in an order that changes
from run to run, so two runs agree to rounding, not to the bit. Images do
agree to the bit.
"""
from __future__ import annotations

import ctypes
import math

import torch

from volrt_torch import _build
from volrt_torch.constants import (
    PHONG_KA,
    PHONG_KS,
    PHONG_SHININESS,
    SHADE_ALPHA_GATE,
    SHADE_KD_GATE,
    SHADE_LIGHT_OFFSET,
    TF_SIZE,
)
from volrt_torch.core import esl as esl_mod
from volrt_torch.core import sampling
from volrt_torch.renderers.common import (
    add_diffuse,
    classify_and_shade,
    composite,
    light_tap,
    normalize,
)

# Pixel block edge of the kernels (csrc/march_common.cuh: TILE).
TILE = 16
# Words of the packed ESL grid (csrc/march_common.cuh: ESL_DIMS^2).
ESL_WORDS = 32 * 32
# Rays per lockstep chunk of the plain marches: keeps 1024^2 in memory.
PLAIN_CHUNK = 1 << 18
# Samples a ray may take, at most (exclusive): the kernels' f32 count of
# them is exact below 2^24.
MAX_STEPS_LIMIT = 1 << 24
# Voxels a volume may hold for the 32-bit voxel offsets of every kernel
# (exclusive). march_blocked, diff_blocked_fwd and diff_blocked_bwd, the
# rows volrt builds for a volume of any size, have a 64-bit instance for
# larger ones (csrc/march_common.cuh:Unsigned).
OFFSET_LIMIT = 1 << 31
# An edge of the volume, at most (exclusive): the per-sample code's floor
# is exact for a voxel coordinate under 2^22 (march_common.cuh:cell_axis).
EDGE_LIMIT = 1 << 22

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# o, d, k0, kfar, alive, vol, w, h, depth, tf, scal
_RAY_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P]
_FWD_ARGTYPES = _RAY_ARGTYPES + [_P, _I, _I, _F, _I, _I, _I, _P]
# ..., out, n, width, step, max_steps, nearest, shade, no_ert, stream
_TRI_ARGTYPES = _RAY_ARGTYPES + [_P, _I, _I, _F, _I, _I, _I, _I, _P]
# ..., out, n, width, step, max_steps, shade, no_ert, wide, stream
_BLOCKED_ARGTYPES = _FWD_ARGTYPES[:-1] + [_I, _P]
# The v3 kernels' ESL grid after their other arguments: words, block.
_ESL_ARGTYPES = [_P, _I]
# ..., out, n, width, step, max_steps, shade, no_ert, esl, acc0, full_d,
# stream
_V3_FWD_ARGTYPES = _FWD_ARGTYPES[:-1] + _ESL_ARGTYPES + [_P, _I, _P]
# ..., image in, image or cotangent, d_vol, d_tf, n, width, step,
# max_steps, shade, no_ert, need_dtf, need_dvol, esl, stream
_GRAD_ARGTYPES = _RAY_ARGTYPES + [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I,
                                  _I] + _ESL_ARGTYPES + [_P]
# march_bwd's: ..., esl, acc0, dacc0, full_d, stream
_BWD_ARGTYPES = _GRAD_ARGTYPES[:-1] + [_P, _P, _I, _P]


def max_steps(ray_step: float) -> int:
    """Samples a ray may take: the cube's chord over the step, plus two
    (as ``volrt/diff/render.py:_march_n_steps``). Every ray a view builds
    has ``|d| >= 1``, so none needs more. The v3 kernels count a ray's
    samples in f32, exact below 2^24 (``csrc/march_common.cuh:
    march_forward``), so a step that needs more is refused."""
    n = int(math.ceil(2.0 * math.sqrt(3.0) / ray_step)) + 2
    if n >= MAX_STEPS_LIMIT:
        raise ValueError(f"ray_step {ray_step} needs {n} samples a ray, "
                         f"{MAX_STEPS_LIMIT} or more")
    return n


def wide_offsets(shape) -> bool:
    """Whether a volume of ``shape`` ``(D, H, W)`` needs 64-bit voxel
    offsets: it holds 2^31 voxels or more, past what a 32-bit offset can
    address. A function of the shape alone; the wrappers of the kernels
    with a 64-bit instance launch it where this is true."""
    return math.prod(int(n) for n in shape) >= OFFSET_LIMIT


def check_volume_shape(shape, any_size: bool) -> None:
    """Refuse a volume of ``shape`` that a kernel cannot address: not
    ``(D, H, W)``; 2^31 voxels or more for a kernel with 32-bit voxel
    offsets only (not ``any_size``); for one with a 64-bit instance
    (``any_size``), an edge of 2^22 voxels or more or an ``H * W`` slice of
    2^31 (the per-sample code keeps a tap's stride in 32 bits). A function
    of the shape alone."""
    if len(shape) != 3:
        raise ValueError(f"density must be [D, H, W], got {tuple(shape)}")
    _, h, w = (int(n) for n in shape)
    if not any_size and wide_offsets(shape):
        raise ValueError(
            f"density {tuple(shape)} has 2^31 voxels or more: this kernel "
            f"addresses under 2^31 ({OFFSET_LIMIT}) with 32-bit voxel "
            f"offsets; march_blocked (rung 4) and diff_blocked_fwd/_bwd "
            f"take a volume of any size")
    if any_size and (max(int(n) for n in shape) >= EDGE_LIMIT
                     or h * w >= OFFSET_LIMIT):
        raise ValueError(
            f"density {tuple(shape)}: every edge must lie under 2^22 voxels "
            f"and an H * W slice under 2^31")


def _check(o, d, k0, kfar, alive, density, premult_tf, scal, width,
           volume_dtype: torch.dtype = torch.float32, shade: bool = False,
           phong: bool = False, esl=None, any_size: bool = False,
           slab=None, **images) -> None:
    """Refuse what the kernels do not take. ``density`` is the volume, of
    ``volume_dtype``: under 2^31 voxels (32-bit voxel offsets), unless
    ``any_size`` (a kernel with a 64-bit instance, which takes any volume
    whose edges lie under 2^22 voxels and whose ``H * W`` slice under 2^31).
    ``shade`` and ``phong`` are the shading modes asked for, of which a
    kernel takes one at most. ``esl`` is ``None`` or the v3 kernels' ESL
    grid ``(words, block)``. ``slab`` is ``None`` or the slab mode's
    ``(acc0, full_d)`` (:func:`march_fwd`), which takes no phong; the
    offset guard reads the slab's own shape. ``images`` are further
    ``f32[N, 4]`` tensors in raster order (an image, a cotangent, a
    target), by name."""
    if shade and phong:
        raise ValueError("phong composes with no diffuse tap (shade)")
    n = o.shape[0] if o.dim() == 2 else -1
    if slab is not None:
        if phong:
            raise NotImplementedError(
                "the slab mode has no phong, as in volrt (diff_v3.py:1448, "
                "2920): render phong volume-sharded with backend='xla'")
        acc0, full_d = slab
        if not (isinstance(full_d, int) and full_d >= 1):
            raise ValueError(f"full_d must be an int >= 1, got {full_d!r}")
        images["acc0"] = acc0
    want = {
        "o": (o, torch.float32, (n, 3)),
        "d": (d, torch.float32, (n, 3)),
        "k0": (k0, torch.float32, (n,)),
        "kfar": (kfar, torch.float32, (n,)),
        "alive": (alive, torch.bool, (n,)),
        "density": (density, volume_dtype, tuple(density.shape)),
        "premult_tf": (premult_tf, torch.float32, (TF_SIZE, 4)),
        "scal": (scal, torch.float32, (8,)),
    }
    for name, t in images.items():
        want[name] = (t, torch.float32, (n,) if name == "acc0" else (n, 4))
    if esl is not None:
        words, block = esl
        want["esl words"] = (words, torch.int32, (ESL_WORDS,))
        if not (isinstance(block, int) and block >= 1):
            raise ValueError(f"the ESL block edge must be an int >= 1, "
                             f"got {block!r}")
    check_tensors(want, o.device)
    check_volume_shape(density.shape, any_size)
    if width <= 0 or n % width:
        raise ValueError(f"width {width} does not divide the {n} rays")
    if -(-(n // width) // TILE) > 65535:
        raise ValueError(f"{n // width} image rows exceed the launch grid")


def check_tensors(want: dict, device: torch.device) -> None:
    """Refuse a tensor that a kernel cannot take: ``want`` maps a name to
    ``(tensor, dtype, shape)``; each must be on ``device`` (the CPU or a
    card), of that dtype and shape, and contiguous."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda, not {device}")
    for name, (t, dtype, shape) in want.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ray_pointers(o, d, k0, kfar, alive, density, premult_tf, scal) -> tuple:
    depth, h, w = density.shape
    return (o.data_ptr(), d.data_ptr(), k0.data_ptr(), kfar.data_ptr(),
            alive.data_ptr(), density.data_ptr(), w, h, depth,
            premult_tf.data_ptr(), scal.data_ptr())


def _esl_pointers(esl) -> tuple:
    """The kernels' ``esl_words`` and ``esl_block`` for ``esl``: null and 0
    without ESL."""
    return (None, 0) if esl is None else (esl[0].data_ptr(), esl[1])


def slab_cell(shape: tuple[int, int, int], slab: tuple[float, int],
              pos: torch.Tensor) -> tuple:
    """The trilinear cell ``(i0, i1, frac)`` of a sample at ``pos (..., 3)``
    in a Z-slab of ``shape (L, H, W)`` that holds rows ``z_off .. z_off + L
    - 1`` of a volume ``full_d`` deep (``slab = (z_off, full_d)``): the whole
    volume's cell (:func:`sampling.trilinear_cell`), its z taps then moved
    to the slab's rows and clamped to them, as
    ``csrc/march_common.cuh:cell_at_slab`` takes it."""
    z_off, full_d = slab
    depth, h, w = shape
    _, (i0, i1, frac) = sampling.trilinear_cell((full_d, h, w), pos)
    z_off = int(z_off)
    i0 = torch.cat([i0[..., :2], (i0[..., 2:] - z_off).clamp(0, depth - 1)],
                   -1)
    i1 = torch.cat([i1[..., :2], (i1[..., 2:] - z_off).clamp(0, depth - 1)],
                   -1)
    return i0, i1, frac


def _cells(shape, slab):
    """``pos -> cell`` of a volume of ``shape``, or of a slab of it
    (:func:`slab_cell`) where ``slab`` is ``(z_off, full_d)``."""
    if slab is None:
        return lambda pos: sampling.trilinear_cell(shape, pos)[1]
    return lambda pos: slab_cell(shape, slab, pos)


def _classify_slab(density, premult_tf, pt, light_pos, kd, cells):
    """``classify_and_shade`` of a density (trilinear, the lerped TF, the
    diffuse tap where ``light_pos`` is given) with the cells of ``cells``:
    the slab mode's per-sample code, in the same operations."""
    s = sampling.cell_sample(density, cells(pt))
    color = sampling.tf_lookup_linear(premult_tf, s)
    if light_pos is None:
        return color
    s2 = sampling.cell_sample(density, cells(light_tap(pt, light_pos)))
    return add_diffuse(color, s2 - s, kd)


def _slab_z(scal: torch.Tensor, slab):
    """``(z_off, full_d)`` of the slab mode's ``slab = (acc0, full_d)``,
    z_off read from ``scal[5]``, or None."""
    if slab is None:
        return None
    return int(round(float(scal[5]))), slab[1]


class EslSkip:
    """The v3 kernels' ESL predicate as torch ops
    (``csrc/march_common.cuh:esl_empty_cell``): a sample is skipped when
    every ESL block of its clamp-addressed trilinear cell, the blocks of
    its low and high tap on each axis, is empty. ``esl`` is ``(words,
    block)``, the packed grid (``core/esl.py:pack_words``) and its block
    edge in voxels; ``shape`` the volume's ``(D, H, W)``."""

    def __init__(self, esl, shape):
        words, self.block = esl
        self.empty = esl_mod.unpack_bitmask(words)
        self.shape = tuple(shape)

    def __call__(self, pt: torch.Tensor) -> torch.Tensor:
        """``bool[N]``: which samples at ``pt (N, 3)`` are skipped."""
        _, (i0, i1, _) = sampling.trilinear_cell(self.shape, pt)
        lo, hi = i0 // self.block, i1 // self.block
        skip = torch.ones(pt.shape[0], dtype=torch.bool, device=pt.device)
        for z in (lo[:, 2], hi[:, 2]):
            for y in (lo[:, 1], hi[:, 1]):
                for x in (lo[:, 0], hi[:, 0]):
                    skip &= self.empty[z, y, x]
        return skip


def _shade_mode(shade: bool, phong: bool) -> int:
    """The kernels' ``shade`` argument: 0 none, 1 the diffuse tap, 2 phong
    (``csrc/march_common.cuh:Shade``)."""
    return 2 if phong else int(shade)


def _launch(name: str, argtypes: list, device: torch.device, *args) -> None:
    """Call the library's ``name`` on ``device``'s current stream and raise
    if the launch was refused."""
    fn = getattr(_build.load(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def march_fwd(o, d, k0, kfar, alive, density, premult_tf, scal, *,
              ray_step: float, shade: bool, no_ert: bool, width: int,
              phong: bool = False, esl=None, slab=None) -> torch.Tensor:
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
      scal: ``f32[8]``: ERT threshold, light kd, light position xyz, one
        unused slot, the loss scale (read by :func:`l2_step` only), one
        unused slot (the JAX kernel's ``scal`` row).
      shade: apply the one-tap diffuse.
      no_ert: the threshold is >= 1 and can never be crossed.
      phong: apply gradient Blinn-Phong (:func:`phong_v3`) with the light
        of ``scal``; not with ``shade``.
      esl: ``None``, or ``(words, block)``: skip the samples whose trilinear
        cell lies in empty ESL blocks (:class:`EslSkip`); ``words`` is the
        packed grid ``int32[1024]`` (``core/esl.py:pack_words``) on the
        rays' device, ``block`` its block edge in voxels. In slab mode the
        grid is the whole volume's, and so is each sample's ESL cell.
      slab: ``None``, or ``(acc0, full_d)``, the slab mode
        (``volrt``'s ``_fwd_kernel(slab=True)``): ``density`` is rows
        ``z_off .. z_off + L - 1`` of a volume ``full_d`` deep, ``z_off``
        (the slab's start less its halo, an integer) in ``scal[5]``; each
        sample's cell is the whole volume's, moved to the slab's rows
        (:func:`slab_cell`); ``acc0`` ``f32[N]`` seeds each ray's opacity
        (the opacity in front of the slab): the output's alpha keeps it,
        on a dead ray too, and a ray whose seed is over the ERT threshold
        takes no sample. ``k0`` and ``kfar`` bound the slab's samples
        (``renderers/diff_v3.py:slab_rays``). No phong.

    CPU tensors take :func:`march_fwd_plain`. CUDA tensors launch the
    kernel, building it at first use, and raise if it cannot launch.
    """
    _check(o, d, k0, kfar, alive, density, premult_tf, scal, width,
           shade=shade, phong=phong, esl=esl, slab=slab)
    if o.device.type == "cpu":
        return march_fwd_plain(
            o, d, k0, kfar, alive, density, premult_tf, scal,
            ray_step=ray_step, shade=shade, no_ert=no_ert, width=width,
            phong=phong, esl=esl, slab=slab)
    n = o.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=o.device)
    if n == 0:
        return out
    acc0, full_d = (None, 0) if slab is None else (slab[0].data_ptr(),
                                                  slab[1])
    _launch("volrt_march_fwd", _V3_FWD_ARGTYPES, o.device,
            *_ray_pointers(o, d, k0, kfar, alive, density, premult_tf, scal),
            out.data_ptr(), n, width, ray_step, max_steps(ray_step),
            _shade_mode(shade, phong), int(no_ert), *_esl_pointers(esl),
            acc0, full_d)
    march_fwd.launches += 1
    return out


march_fwd.launches = 0


def march_fwd_plain(o, d, k0, kfar, alive, density, premult_tf, scal, *,
                    ray_step: float, shade: bool, no_ert: bool,
                    width: int, phong: bool = False,
                    esl=None, slab=None) -> torch.Tensor:
    """The plain torch version of :func:`march_fwd`, same arguments.

    All rays of a chunk step in lockstep for ``max_steps(ray_step)`` steps
    (in slab mode for as many as the slab's longest ray takes), with masks
    in place of the kernel's per-ray ``break``; a sample that ESL skips is
    masked as one past the ray's end is. ``width`` only shapes the
    kernel's blocks and is unused here. Differentiable with respect to
    ``density`` and ``premult_tf`` (the tests hold the plain backward to
    its autograd), and in slab mode to the seed.
    """
    del width
    zs = _slab_z(scal, slab)
    shape = density.shape if zs is None else (zs[1], *density.shape[1:])
    skip = None if esl is None else EslSkip(esl, shape)
    out = torch.empty((o.shape[0], 4), dtype=torch.float32, device=o.device)
    steps = _plain_steps(k0, kfar, alive, ray_step, zs is not None)
    thr, kd, light_pos = scal[0], scal[1], scal[2:5]
    cells = _cells(density.shape, zs)
    for lo in range(0, o.shape[0], PLAIN_CHUNK):
        sl = slice(lo, lo + PLAIN_CHUNK)
        oc, dc, kc, kf = o[sl], d[sl], k0[sl], kfar[sl]
        eye = eye_dir(dc) if phong else None
        live = alive[sl].clone()
        acc = torch.zeros((oc.shape[0], 4), dtype=torch.float32,
                          device=o.device)
        if slab is not None:
            acc = torch.cat([acc[:, :3], slab[0][sl, None]], -1)
            if not no_ert:
                live &= ~(acc[:, 3] > thr)
        for step in steps:
            k = kc + step
            active = live & (k <= kf)
            pt = oc + dc * k[:, None]
            if skip is not None:
                active = active & ~skip(pt)
            if zs is None:
                color = classify_and_shade(
                    density, premult_tf, pt,
                    light_pos=light_pos if shade else None, light_kd=kd)
            else:
                color = _classify_slab(density, premult_tf, pt,
                                       light_pos if shade else None, kd,
                                       cells)
            if phong:
                color = phong_v3(density, color, pt, eye, light_pos, kd)[0]
            acc = torch.where(active[:, None], composite(acc, color), acc)
            if not no_ert:
                live &= ~(active & (acc[:, 3] > thr))
        out[sl] = acc
    return out


def _plain_steps(k0, kfar, alive, ray_step: float, short: bool
                 ) -> torch.Tensor:
    """The lockstep loop's ray parameters past ``k0``: ``max_steps``
    of them, or with ``short`` only as many as the longest live ray can
    take (``(kfar - k0) / step`` and two more for rounding): a slab's rays
    cross a part of the volume."""
    n = max_steps(ray_step)
    if short:
        span = torch.where(alive, kfar - k0, 0.0)
        n = min(n, int(span.max().item() / ray_step) + 2) if span.numel() \
            else 0
    return torch.arange(n, dtype=torch.float32, device=k0.device) * ray_step


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)`` in two rounded operations, on the CPU and the card
    alike, as ``csrc/march_common.cuh:rsqrt_rn`` takes it (``torch.rsqrt``
    on the card is not correctly rounded)."""
    return torch.sqrt(x).reciprocal()


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` over the last axis of ``(N, 3)`` tensors, summed left to
    right as the kernels sum it."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _positive(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` whose gradient, under autograd, passes only where
    ``x > 0``: the strict masks of the analytic chain."""
    return torch.where(x > 0.0, x, 0.0)


def eye_dir(d: torch.Tensor) -> torch.Tensor:
    """Phong's view direction of rays ``d (N, 3)``:
    ``V = -d rsqrt(|d|^2 + 1e-20)``."""
    return -d * _rsqrt(_dot(d, d) + 1e-20)[:, None]


def phong_v3(density: torch.Tensor, color: torch.Tensor, pt: torch.Tensor,
             eye: torch.Tensor, light_pos: torch.Tensor, kd: torch.Tensor
             ) -> tuple[torch.Tensor, dict]:
    """Gradient Blinn-Phong on the premultiplied ``color (N, 4)`` of the
    density samples at ``pt (N, 3)``, as ``volrt``'s v3 kernels shade
    (``volrt/renderers/pallas/diff_v3.py:1219-1262, 1349-1380``) and
    ``csrc/march_common.cuh:shade_phong`` does, op for op
    -> ``(shaded colour, terms of the backward chain)``::

        g   = (S(x+1) - S(x-1), S(y+1) - S(y-1), S(z+1) - S(z-1))
        n   = -g rsqrt(|g|^2 + 1e-16),  L = (light - p) rsqrt(|.|^2 + 1e-20)
        H   = L + V (``eye``),  hinv = rsqrt(|H|^2 + 1e-20)
        rgb = rgb (KA + kd max(n.L, 0)) + KS max((n.H) hinv, 0)^16 alpha

    where alpha > 0.05 and kd > 0.01; elsewhere, and in alpha, the colour
    stays. The taps are :func:`sampling.gradient_cells`'. Differentiable
    with respect to ``density`` and ``color``."""
    cells = sampling.gradient_cells(density.shape, pt)
    s = [sampling.cell_sample(density, c) for c in cells]
    g = torch.stack([s[0] - s[1], s[2] - s[3], s[4] - s[5]], -1)
    ginv = _rsqrt(_dot(g, g) + 1e-16)
    nrm = -g * ginv[:, None]
    lv = light_pos - pt
    ldir = lv * _rsqrt(_dot(lv, lv) + 1e-20)[:, None]
    half = ldir + eye
    hinv = _rsqrt(_dot(half, half) + 1e-20)
    ndl = _positive(_dot(nrm, ldir))
    ndh = _positive(_dot(nrm, half) * hinv)
    s2 = ndh * ndh
    s4 = s2 * s2
    s8 = s4 * s4
    alpha = color[:, 3]
    spec = PHONG_KS * (s8 * s8) * alpha
    lit = PHONG_KA + kd * ndl
    gate = (alpha > SHADE_ALPHA_GATE) & (kd > SHADE_KD_GATE)
    rgb = torch.where(gate[:, None],
                      color[:, :3] * lit[:, None] + spec[:, None],
                      color[:, :3])
    terms = dict(cells=cells, g=g, ginv=ginv, l=ldir, h=half, hinv=hinv,
                 ndl=ndl, ndh=ndh, lit=lit, rgb0=color[:, :3], gate=gate)
    return torch.cat([rgb, color[:, 3:4]], -1), terms


def phong_chain(terms: dict, alpha: torch.Tensor, dcol: torch.Tensor,
                kd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The analytic backward of :func:`phong_v3`
    (``volrt/renderers/pallas/diff_v3.py:1918-1942``, and
    ``csrc/march_common.cuh:phong_chain``): the cotangent ``dcol (N, 4)``
    of the shaded colour -> ``(cotangent of the colour before phong, dg
    (N, 3) of the raw gradient)``. With ``drgb = dc.r + dc.g + dc.b``::

        dlit = rgb0 . dc.rgb,  dndl = kd dlit,
        dndh = KS 16 ndh^15 alpha drgb,  dc.a += KS ndh^16 drgb,
        dn = [n.L > 0] dndl L + [(n.H) hinv > 0] dndh hinv H,
        dg = -ginv dn + ginv^3 (dn . g) g

    on gated samples; elsewhere ``dcol`` passes and ``dg`` is zero. The
    masks are strict: on a flat density (``g = 0``) no cotangent flows
    through the normal."""
    assert PHONG_SHININESS == 16.0
    ndh, ginv = terms["ndh"], terms["ginv"]
    drgb = dcol[:, 0] + dcol[:, 1] + dcol[:, 2]
    dlit = (terms["rgb0"] * dcol[:, :3]).sum(-1)
    s2 = ndh * ndh
    s4 = s2 * s2
    s8 = s4 * s4
    dndl = torch.where(terms["ndl"] > 0.0, kd * dlit, 0.0)
    dnh = torch.where(ndh > 0.0, PHONG_KS * 16.0 * (s8 * s4 * s2 * ndh)
                      * alpha * drgb * terms["hinv"], 0.0)
    dn = dndl[:, None] * terms["l"] + dnh[:, None] * terms["h"]
    dng = (dn * terms["g"]).sum(-1)
    dg = -ginv[:, None] * dn + (ginv * ginv * ginv * dng)[:, None] * terms["g"]
    new = torch.cat([dcol[:, :3] * terms["lit"][:, None],
                     (dcol[:, 3] + PHONG_KS * (s8 * s8) * drgb)[:, None]], -1)
    gate = terms["gate"][:, None]
    return torch.where(gate, new, dcol), torch.where(gate, dg, 0.0)


def march_tri(o, d, k0, kfar, alive, volume, premult_tf, scal, *,
              ray_step: float, nearest: bool, shade: bool, no_ert: bool,
              width: int) -> torch.Tensor:
    """March N rays through an f32 volume of raw voxel values 0..255 and
    composite them -> ``f32[N, 4]``: rung 3's march, and rung 2's with
    ``nearest=True``.

    The arguments are :func:`march_fwd`'s, with two differences. ``volume``
    is ``f32[D, H, W]`` on the 0..255 scale: trilinear mode lerps the raw
    taps and divides by 255 once before the lerped TF; nearest mode reads
    one voxel by truncation, the TF bucket ``int(v) // TF_RATIO`` with no
    lerp, and scales the shade delta by 1/255. And the ray parameter is
    accumulated: samples lie at ``k0, k0 + step, (k0 + step) + step, ...``
    and a ray ends when its next ``k`` exceeds ``kfar``, as rungs 0-1 march
    (``k0`` carries the leading empty-space leap).

    CPU tensors take :func:`march_tri_plain`. CUDA tensors launch the
    kernel, building it at first use, and raise if it cannot launch.
    """
    _check(o, d, k0, kfar, alive, volume, premult_tf, scal, width)
    if o.device.type == "cpu":
        return march_tri_plain(
            o, d, k0, kfar, alive, volume, premult_tf, scal,
            ray_step=ray_step, nearest=nearest, shade=shade, no_ert=no_ert,
            width=width)
    n = o.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=o.device)
    if n == 0:
        return out
    _launch("volrt_march_tri", _TRI_ARGTYPES, o.device,
            *_ray_pointers(o, d, k0, kfar, alive, volume, premult_tf, scal),
            out.data_ptr(), n, width, ray_step, max_steps(ray_step),
            int(nearest), int(shade), int(no_ert))
    march_tri.launches += 1
    return out


march_tri.launches = 0


def march_blocked(o, d, k0, kfar, alive, volume, premult_tf, scal, *,
                  ray_step: float, shade: bool, no_ert: bool,
                  width: int, wide: bool | None = None) -> torch.Tensor:
    """March N rays through the ``uint8[D, H, W]`` volume and composite
    them -> ``f32[N, 4]``: rung 4's march. As :func:`march_tri` in
    trilinear mode, with each tap converted to f32 after its fetch. The
    volume may hold any number of voxels: ``wide`` (by default
    :func:`wide_offsets` of its shape) launches the kernel's instance with
    64-bit voxel offsets, which a volume of 2^31 voxels or more needs.

    CPU tensors take :func:`march_blocked_plain`. CUDA tensors launch the
    kernel or raise.
    """
    _check(o, d, k0, kfar, alive, volume, premult_tf, scal, width,
           volume_dtype=torch.uint8, any_size=True)
    if wide is None:
        wide = wide_offsets(volume.shape)
    if o.device.type == "cpu":
        return march_blocked_plain(
            o, d, k0, kfar, alive, volume, premult_tf, scal,
            ray_step=ray_step, shade=shade, no_ert=no_ert, width=width)
    n = o.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=o.device)
    if n == 0:
        return out
    _launch("volrt_march_blocked", _BLOCKED_ARGTYPES, o.device,
            *_ray_pointers(o, d, k0, kfar, alive, volume, premult_tf, scal),
            out.data_ptr(), n, width, ray_step, max_steps(ray_step),
            int(shade), int(no_ert), int(wide))
    march_blocked.launches += 1
    return out


march_blocked.launches = 0


def div255_mismatches(x: torch.Tensor) -> int:
    """How many of the f32 values ``x`` the ladder's division by 255 puts
    elsewhere than the IEEE quotient ``x / 255``, bit for bit.

    ``csrc/march_common.cuh:div255`` divides in three rounded operations,
    ``q = x * r`` with ``r = RN(1/255)``, ``e = fma(-q, 255, x)`` and
    ``fma(e, r, q)``, where ``__fdiv_rn`` takes a longer sequence.
    ``chip_smoke.py`` runs this over every f32 in [0, 256), the range of
    the kernels' lerps of raw values 0..255, and needs 0. CUDA tensors
    launch ``volrt_div255_check`` (one pass, one count); CPU tensors take
    :func:`div255_mismatches_plain`.
    """
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous f32 vector")
    if x.device.type == "cpu":
        return div255_mismatches_plain(x)
    count = torch.zeros(1, dtype=torch.int64, device=x.device)
    if x.numel():
        _launch("volrt_div255_check", [_P, ctypes.c_longlong, _P], x.device,
                x.data_ptr(), x.numel(), count.data_ptr())
    return int(count.item())


def div255_mismatches_plain(x: torch.Tensor) -> int:
    """The plain version of :func:`div255_mismatches`: the three
    operations in f64, where the products are exact and each f32 rounding
    is taken once, against torch's f32 division."""
    r = torch.tensor(1.0, dtype=torch.float32) / 255.0
    x64, r64 = x.double(), r.double()
    q = (x64 * r64).float()
    e = (x64 - q.double() * 255.0).float()  # fma(-q, 255, x)
    # fma(e, r, q): e r is exact in f64; q + e r as an unevaluated pair
    # (Fast2Sum), rounded once to the nearest f32, ties to even.
    s = e.double() * r64
    hi = q.double() + s
    lo = (q.double() - hi) + s
    got = hi.float()
    for side in (math.inf, -math.inf):
        nb = torch.nextafter(got, torch.full_like(got, side))
        mid = (hi == (got.double() + nb.double()) / 2) & (lo != 0)
        got = torch.where(mid & ((lo > 0) == (side > 0)), nb, got)
    want = x / torch.tensor(255.0, dtype=torch.float32)
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def _classify_nearest_raw(volume, premult_tf, pt, light_pos, kd):
    """Nearest mode in the kernel's order: the sample stays on the 0..255
    scale and the shade delta is scaled, ``(s_light - s) * (1/255) * kd``
    (``volrt/renderers/pallas/trilinear.py:259-262``)."""
    s = sampling.sample_nearest(volume, pt)
    color = sampling.tf_lookup_bucket(premult_tf, s)
    if light_pos is None:
        return color
    sl = sampling.sample_nearest(volume, light_tap(pt, light_pos))
    return add_diffuse(color, (sl - s) * (1.0 / 255.0), kd)


def march_tri_plain(o, d, k0, kfar, alive, volume, premult_tf, scal, *,
                    ray_step: float, nearest: bool, shade: bool,
                    no_ert: bool, width: int) -> torch.Tensor:
    """The plain torch version of :func:`march_tri` and, with a uint8
    ``volume``, of :func:`march_blocked`: same arguments.

    All rays of a chunk step in lockstep for at most ``max_steps(ray_step)``
    steps, with masks in place of the kernel's per-ray ``break``; ``k``
    gains one ``+ ray_step`` per step. ``width`` only shapes the kernel's
    blocks and is unused here.
    """
    del width
    out = torch.empty((o.shape[0], 4), dtype=torch.float32, device=o.device)
    thr, kd = scal[0], scal[1]
    light_pos = scal[2:5] if shade else None
    for lo in range(0, o.shape[0], PLAIN_CHUNK):
        sl = slice(lo, lo + PLAIN_CHUNK)
        oc, dc, kf = o[sl], d[sl], kfar[sl]
        k, live = k0[sl], alive[sl]
        acc = torch.zeros((oc.shape[0], 4), dtype=torch.float32,
                          device=o.device)
        for _ in range(max_steps(ray_step)):
            pt = oc + dc * k[:, None]
            if nearest:
                color = _classify_nearest_raw(volume, premult_tf, pt,
                                              light_pos, kd)
            else:
                color = classify_and_shade(
                    volume, premult_tf, pt, light_pos=light_pos,
                    light_kd=kd, interpolation="trilinear")
            acc = torch.where(live[:, None], composite(acc, color), acc)
            k = k + ray_step
            live = live & (k <= kf)
            if not no_ert:
                live = live & ~(acc[:, 3] > thr)
        out[sl] = acc
    return out


def march_blocked_plain(o, d, k0, kfar, alive, volume, premult_tf, scal, *,
                        ray_step: float, shade: bool, no_ert: bool,
                        width: int) -> torch.Tensor:
    """The plain torch version of :func:`march_blocked`, same arguments:
    the trilinear plain march, whose taps convert after the fetch."""
    return march_tri_plain(o, d, k0, kfar, alive, volume, premult_tf, scal,
                           ray_step=ray_step, nearest=False, shade=shade,
                           no_ert=no_ert, width=width)


def march_bwd(o, d, k0, kfar, alive, density, premult_tf, scal, out, g, *,
              ray_step: float, shade: bool, no_ert: bool, width: int,
              need_dtf: bool = True, need_dvol: bool = True,
              phong: bool = False, esl=None, slab=None) -> tuple:
    """The backward of :func:`march_fwd`
    -> ``(d_density f32[D, H, W], d_premult_tf f32[TF_SIZE, 4])``, and in
    slab mode also ``dacc0 f32[N]``, the seed's cotangent.

    The first eight arguments and the keywords are the forward's (``esl``
    too: the replay skips the forward's samples; ``slab`` the same
    ``(acc0, full_d)``); ``out``
    is the image it returned and ``g`` the cotangent of that image, both
    ``f32[N, 4]``. A ray that is not alive, or whose cotangent is zero,
    sends no gradient. ``need_dtf=False`` / ``need_dvol=False`` skip that
    leaf's scatter and return zeros for it. In slab mode the replay starts
    from the seed, the suffix total leaves the seed's share ``g.a acc0``
    out, and ``dacc0 = g.a - P / max(1 - acc0, 1e-6)`` for every ray, ``P``
    the replay's prefix of contributions (``volrt``'s ``_bwd_kernel(slab=
    True)``, ``diff_v3.py:1503-1506, 2358-2366``).

    CPU tensors take :func:`march_bwd_plain`. CUDA tensors launch the
    kernel or raise. Both gradients are zero-filled here and accumulated
    into with atomics, so two runs on the card differ by rounding.
    """
    _check(o, d, k0, kfar, alive, density, premult_tf, scal, width,
           shade=shade, phong=phong, esl=esl, slab=slab, out=out, g=g)
    if o.device.type == "cpu":
        return march_bwd_plain(
            o, d, k0, kfar, alive, density, premult_tf, scal, out, g,
            ray_step=ray_step, shade=shade, no_ert=no_ert, width=width,
            need_dtf=need_dtf, need_dvol=need_dvol, phong=phong, esl=esl,
            slab=slab)
    d_density = torch.zeros_like(density)
    d_tf = torch.zeros_like(premult_tf)
    n = o.shape[0]
    dacc0 = None if slab is None else torch.empty_like(slab[0])
    grads = (d_density, d_tf) + (() if slab is None else (dacc0,))
    if n == 0 or (slab is None and not (need_dtf or need_dvol)):
        return grads
    acc0, full_d = (None, 0) if slab is None else (slab[0].data_ptr(),
                                                  slab[1])
    _launch("volrt_march_bwd", _BWD_ARGTYPES, o.device,
            *_ray_pointers(o, d, k0, kfar, alive, density, premult_tf, scal),
            out.data_ptr(), g.data_ptr(), d_density.data_ptr(),
            d_tf.data_ptr(), n, width, ray_step, max_steps(ray_step),
            _shade_mode(shade, phong), int(no_ert), int(need_dtf),
            int(need_dvol), *_esl_pointers(esl), acc0,
            None if dacc0 is None else dacc0.data_ptr(), full_d)
    march_bwd.launches += 1
    return grads


march_bwd.launches = 0


class PlainReplay:
    """The analytic backward's per-sample step as torch ops, shared by the
    plain backwards of both lattices (:func:`march_bwd_plain` here, the
    round-1 pair's in ``round1.py``).

    With ``T_i`` the transmittance entering sample ``i``, ``c_i`` its
    colour, ``G = g . out`` and ``P`` the running prefix of
    ``contrib_i = (g . c_i) T_i``::

        dL/dc_i.rgb = g.rgb T_i
        dL/dc_i.a   = g.a T_i - S_next / (1 - c_i.a),
        S_next      = G - (P + contrib_i)

    where the division is dropped for an opaque sample
    (``1 - c_i.a <= 1e-6``), as the reference guards it. ``dL/dc_i``
    scatters with ``index_add_`` to the two TF rows of the lerp and,
    through the TF's slope (and the diffuse tap's ``-kd`` / ``+kd``), to
    the sample's eight voxels (and the light tap's eight). With ``phong``
    the cotangent first goes through :func:`phong_chain`, and ``+-dg``
    scatters to the gradient's six cells. ``in_range``
    drops the slope at the TF's end points and for a density outside
    (0, 1), as the v3 reference's flag does; without it the slope of the
    clamped rows stands, zero only where they coincide, as round 1 takes
    it.

    Use: :meth:`start` for a chunk of rays, :meth:`sample` once per
    lockstep step, :meth:`gradients` at the end.
    """

    def __init__(self, density, premult_tf, scal, *, shade: bool,
                 need_dtf: bool, need_dvol: bool, in_range: bool,
                 phong: bool = False):
        self.density, self.premult_tf = density, premult_tf
        self.kd, self.light_pos = scal[1], scal[2:5]
        self.shade, self.in_range, self.phong = shade, in_range, phong
        self.need_dtf, self.need_dvol = need_dtf, need_dvol
        self.d_density = torch.zeros_like(density)
        # Every sample of every ray adds to a few of the LUT's 512 entries:
        # at 1024^2 rays that is 1e8 terms an entry, more than an f32
        # accumulator can take in without dropping the small ones. The
        # reference sums them in f64; a voxel's few hundred terms stay f32.
        self.d_tf = torch.zeros_like(premult_tf, dtype=torch.float64)
        # slope[i] = (tf[i+1] - tf[i]) * TF_SIZE; the clamped lerp is flat
        # beyond the last row.
        self.slope = torch.cat([premult_tf[1:] - premult_tf[:-1],
                                torch.zeros_like(premult_tf[:1])]) * TF_SIZE
        self.chan = torch.arange(4, device=density.device)

    def start(self, g: torch.Tensor, out: torch.Tensor,
              d: torch.Tensor | None = None,
              acc0: torch.Tensor | None = None) -> None:
        """Begin a chunk of rays with cotangent ``g`` of the image ``out``
        (and, in phong mode, directions ``d``; in slab mode the seed
        ``acc0``, whose share ``g.a acc0`` of ``out`` the suffix total
        leaves out)."""
        self.g = g
        self.eye = eye_dir(d) if self.phong else None
        self.big_g = (g * out).sum(-1)
        self.acc_a = torch.zeros_like(self.big_g)
        self.prefix = torch.zeros_like(self.big_g)
        if acc0 is not None:
            self.big_g = self.big_g - g[:, 3] * acc0
            self.acc_a = acc0.clone()

    def seed_cotangent(self, acc0: torch.Tensor) -> torch.Tensor:
        """The slab mode's ``dacc0 = g.a - P / max(1 - acc0, 1e-6)`` of
        the chunk's rays, after their last sample."""
        return self.g[:, 3] - self.prefix / (1.0 - acc0).clamp(min=1e-6)

    def sample(self, pt: torch.Tensor, active: torch.Tensor,
               cells=None) -> torch.Tensor:
        """Replay the sample at ``pt (N, 3)`` for the rays that are
        ``active`` and return the opacity composited so far. ``cells``
        (``pos -> cell``) gives a slab's cells (:func:`slab_cell`) in
        place of the density's own."""
        density, premult_tf, gc = self.density, self.premult_tf, self.g
        flat_dv, flat_dtf = self.d_density.view(-1), self.d_tf.view(-1)
        kd = self.kd
        if cells is None:
            s = sampling.sample_trilinear_f(density, pt)
            color = classify_and_shade(
                density, premult_tf, pt,
                light_pos=self.light_pos if self.shade else None,
                light_kd=kd)
        else:
            s = sampling.cell_sample(density, cells(pt))
            color = _classify_slab(
                density, premult_tf, pt,
                self.light_pos if self.shade else None, kd, cells)
        if self.phong:
            color, terms = phong_v3(density, color, pt, self.eye,
                                    self.light_pos, kd)
        m = active.to(torch.float32)
        t_in = (1.0 - self.acc_a) * m
        contrib = (gc * color).sum(-1) * t_in
        s_next = self.big_g - (self.prefix + contrib)
        self.prefix = self.prefix + contrib
        denom = 1.0 - color[:, 3]
        t8 = torch.where(denom > 1e-6,
                         s_next / denom.clamp(min=1e-6), 0.0) * m
        dcol = gc * t_in[:, None]
        dcol = torch.cat([dcol[:, :3], (dcol[:, 3] - t8)[:, None]], -1)
        if self.phong:
            dcol, dg = phong_chain(terms, color[:, 3], dcol, kd)

        tc = s * TF_SIZE - 0.5
        i0 = torch.floor(tc)
        f = tc - i0
        i0 = i0.to(torch.int64)
        lo = i0.clamp(0, TF_SIZE - 1)
        hi = (i0 + 1).clamp(0, TF_SIZE - 1)
        if self.need_dtf:
            flat_dtf.index_add_(
                0, (lo[:, None] * 4 + self.chan).reshape(-1),
                (dcol * (1.0 - f)[:, None]).reshape(-1).double())
            flat_dtf.index_add_(
                0, (hi[:, None] * 4 + self.chan).reshape(-1),
                (dcol * f[:, None]).reshape(-1).double())
        if self.need_dvol:
            if self.in_range:
                ds = (self.slope[lo] * dcol).sum(-1) * (
                    (tc > 0.0) & (tc < TF_SIZE - 1.0) & (s > 0.0) & (s < 1.0))
            else:
                ds = ((premult_tf[hi] - premult_tf[lo]) * TF_SIZE
                      * dcol).sum(-1)
            if self.shade:
                gate = ((color[:, 3] > SHADE_ALPHA_GATE)
                        & (kd > SHADE_KD_GATE))
                ds2 = torch.where(gate, kd * dcol[:, :3].sum(-1), 0.0)
                ds = ds - ds2
                light_dir = normalize(self.light_pos - pt)
                idx, wgt = self._taps(pt + light_dir * SHADE_LIGHT_OFFSET,
                                      cells)
                flat_dv.index_add_(0, idx.reshape(-1),
                                   (wgt * ds2[:, None]).reshape(-1))
            idx, wgt = self._taps(pt, cells)
            flat_dv.index_add_(0, idx.reshape(-1),
                               (wgt * ds[:, None]).reshape(-1))
            if self.phong:
                for k, cell in enumerate(terms["cells"]):
                    idx, wgt = sampling.cell_taps(density.shape, cell)
                    v = -dg[:, k // 2] if k % 2 else dg[:, k // 2]
                    flat_dv.index_add_(0, idx.reshape(-1),
                                       (wgt * v[:, None]).reshape(-1))

        self.acc_a = self.acc_a + color[:, 3] * t_in
        return self.acc_a

    def _taps(self, pos: torch.Tensor, cells) -> tuple:
        """The eight taps of the sample at ``pos``: the density's own
        cell's, or ``cells``'."""
        if cells is None:
            return sampling.trilinear_taps(self.density.shape, pos)
        return sampling.cell_taps(self.density.shape, cells(pos))

    def gradients(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(d_density, d_premult_tf)``, both f32."""
        return self.d_density, self.d_tf.to(torch.float32)


def march_bwd_plain(o, d, k0, kfar, alive, density, premult_tf, scal, out, g,
                    *, ray_step: float, shade: bool, no_ert: bool,
                    width: int, need_dtf: bool = True,
                    need_dvol: bool = True, phong: bool = False,
                    esl=None, slab=None) -> tuple:
    """The plain torch version of :func:`march_bwd`, same arguments.

    The analytic backward of ``volrt/renderers/pallas/diff_v3.py:
    1907-1957``, one lockstep step at a time (:class:`PlainReplay`), on the
    forward's lattice ``k0 + i*ray_step``, where a sample that ESL skips
    is replayed as inactive: its colour is 0 and it adds nothing. In slab
    mode the replay starts from the seed and ``dacc0`` comes third.
    """
    del width
    zs = _slab_z(scal, slab)
    shape = density.shape if zs is None else (zs[1], *density.shape[1:])
    skip = None if esl is None else EslSkip(esl, shape)
    cells = None if zs is None else _cells(density.shape, zs)
    replay = PlainReplay(density, premult_tf, scal, shade=shade,
                         need_dtf=need_dtf, need_dvol=need_dvol,
                         in_range=True, phong=phong)
    steps = _plain_steps(k0, kfar, alive, ray_step, zs is not None)
    thr = scal[0]
    dacc0 = []
    for c0 in range(0, o.shape[0], PLAIN_CHUNK):
        sl = slice(c0, c0 + PLAIN_CHUNK)
        oc, dc, kc, kf = o[sl], d[sl], k0[sl], kfar[sl]
        live = alive[sl].clone()
        seed = None if slab is None else slab[0][sl]
        replay.start(g[sl], out[sl], dc, seed)
        if seed is not None and not no_ert:
            live &= ~(seed > thr)
        for step in steps:
            k = kc + step
            active = live & (k <= kf)
            pt = oc + dc * k[:, None]
            if skip is not None:
                active = active & ~skip(pt)
            acc_a = replay.sample(pt, active, cells)
            if not no_ert:
                live &= ~(active & (acc_a > thr))
        if seed is not None:
            dacc0.append(replay.seed_cotangent(seed))
    grads = replay.gradients()
    if slab is None:
        return grads
    return grads + (torch.cat(dacc0) if dacc0 else slab[0].clone(),)


def l2_step(o, d, k0, kfar, alive, density, premult_tf, scal, tgt, *,
            ray_step: float, shade: bool, no_ert: bool, width: int,
            need_dtf: bool = True, need_dvol: bool = True,
            phong: bool = False, esl=None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole L2 step in one launch
    -> ``(out f32[N, 4], d_density, d_premult_tf)``.

    Marches forward to the image ``out``, forms the cotangent
    ``g = (out - tgt) * scal[6] * alive`` of
    ``L = sum((out - tgt)^2) * scal[6] / 2`` (the image's mean square
    error when ``scal[6] = 2 / (H*W*4)``), and marches backward as
    :func:`march_bwd` does. ``tgt`` is the target, ``f32[N, 4]`` in raster
    order; the other arguments are :func:`march_bwd`'s. The caller takes
    the loss from ``out``.

    CPU tensors take :func:`l2_step_plain`. CUDA tensors launch the
    kernel or raise.
    """
    _check(o, d, k0, kfar, alive, density, premult_tf, scal, width,
           shade=shade, phong=phong, esl=esl, tgt=tgt)
    if o.device.type == "cpu":
        return l2_step_plain(
            o, d, k0, kfar, alive, density, premult_tf, scal, tgt,
            ray_step=ray_step, shade=shade, no_ert=no_ert, width=width,
            need_dtf=need_dtf, need_dvol=need_dvol, phong=phong, esl=esl)
    n = o.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=o.device)
    d_density = torch.zeros_like(density)
    d_tf = torch.zeros_like(premult_tf)
    if n == 0:
        return out, d_density, d_tf
    _launch("volrt_l2_step", _GRAD_ARGTYPES, o.device,
            *_ray_pointers(o, d, k0, kfar, alive, density, premult_tf, scal),
            tgt.data_ptr(), out.data_ptr(), d_density.data_ptr(),
            d_tf.data_ptr(), n, width, ray_step, max_steps(ray_step),
            _shade_mode(shade, phong), int(no_ert), int(need_dtf),
            int(need_dvol), *_esl_pointers(esl))
    l2_step.launches += 1
    return out, d_density, d_tf


l2_step.launches = 0


def l2_step_plain(o, d, k0, kfar, alive, density, premult_tf, scal, tgt, *,
                  ray_step: float, shade: bool, no_ert: bool, width: int,
                  need_dtf: bool = True, need_dvol: bool = True,
                  phong: bool = False, esl=None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain torch version of :func:`l2_step`, same arguments: the
    plain forward, the cotangent, the plain backward."""
    kw = dict(ray_step=ray_step, shade=shade, no_ert=no_ert, width=width,
              phong=phong, esl=esl)
    out = march_fwd_plain(o, d, k0, kfar, alive, density, premult_tf, scal,
                          **kw)
    g = (out - tgt) * (scal[6] * alive[:, None])
    d_density, d_tf = march_bwd_plain(
        o, d, k0, kfar, alive, density, premult_tf, scal, out, g,
        need_dtf=need_dtf, need_dvol=need_dvol, **kw)
    return out, d_density, d_tf


class MarchFunction(torch.autograd.Function):
    """:func:`march_fwd` under autograd, with :func:`march_bwd` as its
    backward (the counterpart of ``render_tiles_v3``'s custom_vjp).

    ``MarchFunction.apply(density, premult_tf, o, d, k0, kfar, alive, scal,
    ray_step, shade, no_ert, width[, phong, esl[, acc0, full_d]])`` returns
    the image ``f32[N, 4]``; ``acc0`` and ``full_d`` are the slab mode's
    (:func:`march_fwd`'s ``slab``).
    Gradients flow to ``density``, ``premult_tf`` and ``acc0`` only; a leaf
    that does not require one skips its scatter (``need_dtf`` /
    ``need_dvol``).
    """

    @staticmethod
    def forward(ctx, density, premult_tf, o, d, k0, kfar, alive, scal,
                ray_step, shade, no_ert, width, phong=False, esl=None,
                acc0=None, full_d=None):
        slab = None if acc0 is None else (acc0, full_d)
        ctx.kw = dict(ray_step=ray_step, shade=shade, no_ert=no_ert,
                      width=width, phong=phong, esl=esl)
        ctx.full_d = full_d
        out = march_fwd(o, d, k0, kfar, alive, density, premult_tf, scal,
                        slab=slab, **ctx.kw)
        ctx.save_for_backward(o, d, k0, kfar, alive, density, premult_tf,
                              scal, out, acc0)
        return out

    @staticmethod
    def backward(ctx, g):
        need_dvol, need_dtf = ctx.needs_input_grad[:2]
        *saved, acc0 = ctx.saved_tensors
        slab = None if acc0 is None else (acc0, ctx.full_d)
        grads = march_bwd(*saved, g.contiguous(), need_dtf=need_dtf,
                          need_dvol=need_dvol, slab=slab, **ctx.kw)
        dacc0 = grads[2] if slab is not None else None
        return (grads[0] if need_dvol else None,
                grads[1] if need_dtf else None) + (None,) * 12 + (
                    dacc0, None)
