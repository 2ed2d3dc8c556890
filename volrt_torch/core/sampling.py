"""Volume and transfer-function sampling, as torch ops
(the counterparts of ``volrt/core/sampling.py``).

Positions are ``(..., 3)`` tensors of world coordinates ``(x, y, z)`` in
``[-1, 1]^3``; grids are ``[D, H, W]`` tensors. The arithmetic is written
op for op as in the JAX package, and the CUDA march kernels
(``csrc/march_common.cuh``, ``csrc/march_ladder.cu``) repeat it op for op,
so the three agree to the last bit wherever no square root is involved.
"""
from __future__ import annotations

import torch

from volrt_torch.constants import TF_RATIO, TF_SIZE


def map_float_int(f: torch.Tensor, n: int) -> torch.Tensor:
    """Map float [0,1] to int [0, n-1], truncating toward zero like the
    reference's ``(long)(f * n)``; out-of-range values clamp
    (reference: common.h:105-110)."""
    return (f * n).to(torch.int32).clamp(0, n - 1)


def world_to_voxel_idx(pos: torch.Tensor,
                       dims: tuple[int, int, int]) -> torch.Tensor:
    """Nearest-neighbour voxel index ``int64[..., 3]`` as ``(ix, iy, iz)``
    for a volume of ``dims (W, H, D)``: ``map_float_int((pos+1)*0.5, dims)``
    per axis (reference: ModelBase.h:19-21)."""
    n = torch.tensor(dims, dtype=torch.float32, device=pos.device)
    i = ((pos + 1.0) * 0.5 * n).to(torch.int64)
    return torch.minimum(i.clamp(min=0), (n - 1).to(torch.int64))


def sample_nearest(grid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample of a ``[D, H, W]`` grid, in the grid's own
    type and scale (reference: ModelBase.h:17-23)."""
    d, h, w = grid.shape
    ix, iy, iz = world_to_voxel_idx(pos, (w, h, d)).unbind(-1)
    return grid.reshape(-1)[(iz * h + iy) * w + ix]


def _lerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return a * (1 - f) + b * f


def sample_trilinear(grid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a grid of raw voxel values 0..255 (``uint8`` or
    ``f32``) -> ``f32`` in [0, 1]: the eight taps are converted after the
    fetch, lerped along x, then y, then z, and the result divided by 255
    once (``volrt/core/sampling.py:56-102``).

    The divisor is a tensor on the grid's device: torch divides a CUDA
    tensor by a Python number as a product with its reciprocal, which
    rounds otherwise than the division that the CPU, the JAX package and
    the march kernels do."""
    raw = sample_trilinear_f(grid, pos)
    return raw / raw.new_full((), 255.0)


def sample_trilinear_f(grid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a grid ``[D, H, W]`` at world positions
    ``(..., 3)`` -> ``f32`` in grid units, with CUDA-texture clamp
    addressing: normalised coordinate ``u`` samples voxel space at
    ``u*N - 0.5``, voxel centres at integers, both taps clamped to
    ``[0, N-1]``. Weights are full f32 (hardware texture filtering would
    round them to 9 bits)."""
    d, h, w = grid.shape
    n = torch.tensor([w, h, d], dtype=torch.float32, device=grid.device)
    t = (pos + 1.0) * 0.5 * n - 0.5
    i0 = torch.floor(t)
    frac = t - i0
    i0 = i0.to(torch.int64)
    nmax = torch.tensor([w - 1, h - 1, d - 1], device=grid.device)
    i1 = torch.minimum(torch.clamp(i0 + 1, min=0), nmax)
    i0 = torch.minimum(torch.clamp(i0, min=0), nmax)

    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    fx, fy, fz = frac.unbind(-1)
    flat = grid.reshape(-1)

    def tap(z, y, x):
        return flat[(z * h + y) * w + x].to(torch.float32)

    c00 = _lerp(tap(z0, y0, x0), tap(z0, y0, x1), fx)
    c01 = _lerp(tap(z0, y1, x0), tap(z0, y1, x1), fx)
    c10 = _lerp(tap(z1, y0, x0), tap(z1, y0, x1), fx)
    c11 = _lerp(tap(z1, y1, x0), tap(z1, y1, x1), fx)
    c0 = _lerp(c00, c01, fy)
    c1 = _lerp(c10, c11, fy)
    return _lerp(c0, c1, fz)


def trilinear_taps(shape: tuple[int, int, int], pos: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The eight taps of :func:`sample_trilinear_f` at ``pos (..., 3)`` in
    a grid of ``shape (D, H, W)``: flat voxel indices ``int64[..., 8]`` and
    their weights ``f32[..., 8]``. The sample is ``sum(grid.flatten()[idx]
    * w)``, so a cotangent ``ds`` of the sample scatters as ``ds * w`` to
    ``idx``: what the backward march does. Taps that clamp to one voxel
    appear twice, each with its own weight."""
    d, h, w = shape
    n = torch.tensor([w, h, d], dtype=torch.float32, device=pos.device)
    t = (pos + 1.0) * 0.5 * n - 0.5
    i0 = torch.floor(t)
    frac = t - i0
    i0 = i0.to(torch.int64)
    nmax = torch.tensor([w - 1, h - 1, d - 1], device=pos.device)
    i1 = torch.minimum(torch.clamp(i0 + 1, min=0), nmax)
    i0 = torch.minimum(torch.clamp(i0, min=0), nmax)
    x, y, z = (torch.stack(a, -1) for a in zip(i0.unbind(-1), i1.unbind(-1)))
    fx, fy, fz = (torch.stack((1 - f, f), -1) for f in frac.unbind(-1))
    # Tap order: z major, then y, then x, each (low, high).
    idx = ((z[..., :, None, None] * h + y[..., None, :, None]) * w
           + x[..., None, None, :])
    wgt = (fz[..., :, None, None] * fy[..., None, :, None]
           * fx[..., None, None, :])
    return idx.flatten(-3), wgt.flatten(-3)


def tf_lookup_bucket(transfer_fn: torch.Tensor,
                     sample: torch.Tensor) -> torch.Tensor:
    """Bucketed TF lookup for raw samples 0..255 (any integer or float
    type): ``tf[int(sample) // TF_RATIO]``, no lerp
    (reference: CPURenderer.cpp:31). Returns ``(..., 4)``."""
    bucket = sample.to(torch.int64) // TF_RATIO
    return transfer_fn[bucket.clamp(0, TF_SIZE - 1)]


def tf_lookup_linear(transfer_fn: torch.Tensor,
                     sample: torch.Tensor) -> torch.Tensor:
    """Linearly interpolated TF lookup for float samples in [0, 1], like
    ``tex1D`` with linear filtering and clamp addressing
    (reference: GPURenderer4.cu:77,94-96): the fetch position is
    ``sample*TF_SIZE - 0.5`` with entries at integer centres.
    Returns ``(..., 4)`` premultiplied RGBA."""
    t = sample * TF_SIZE - 0.5
    i0 = torch.floor(t)
    frac = (t - i0)[..., None]
    i0 = i0.to(torch.int64)
    lo = i0.clamp(0, TF_SIZE - 1)
    hi = (i0 + 1).clamp(0, TF_SIZE - 1)
    return _lerp(transfer_fn[lo], transfer_fn[hi], frac)


def write_color(color: torch.Tensor) -> torch.Tensor:
    """Quantise float RGBA to uint8 with the reference's mapping,
    ``map_float_int(c, 256)`` (reference: RaycasterBase.h:44-50)."""
    return map_float_int(color, 256).to(torch.uint8)
