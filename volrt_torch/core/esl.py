"""Empty-space-leaping (ESL) block grid, as torch ops
(the counterpart of ``volrt/core/esl.py``).

The volume is cut into blocks of ``block_dims^3`` voxels on a fixed
``ESL_VOLUME_DIMS^3`` grid. A block is empty under a transfer function when
no value between its minimum and maximum maps to nonzero opacity; rays leap
over leading empty blocks in whole ray steps, so the image does not change
(reference: RaycasterBase.cpp:53-67, 94-125, RaycasterBase.h:52-85).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from volrt_torch.constants import ESL_VOLUME_DIMS, TF_RATIO
from volrt_torch.core.sampling import world_to_voxel_idx
from volrt_torch.core.tf import first_opaque_index


def build_min_max_grid(data: torch.Tensor, block_dims: int) -> torch.Tensor:
    """Per-block (min, max) voxel values of a ``uint8[D, H, W]`` volume as
    ``uint8[32, 32, 32, 2]``, ``[z, y, x]``. Blocks outside the volume keep
    the init values ``(255, 0)`` and so read as empty
    (reference: RaycasterBase.cpp:101-104)."""
    d, h, w = data.shape
    b = block_dims
    nbx, nby, nbz = -(-w // b), -(-h // b), -(-d // b)
    if max(nbx, nby, nbz) > ESL_VOLUME_DIMS:
        raise ValueError(
            f"volume {(w, h, d)} with block {b} exceeds the "
            f"{ESL_VOLUME_DIMS}^3 ESL grid")
    pad = (0, nbx * b - w, 0, nby * b - h, 0, nbz * b - d)

    def block_reduce(fill: int, op):
        x = F.pad(data, pad, value=fill).reshape(nbz, b, nby, b, nbx, b)
        return op(x, dim=(1, 3, 5))

    n = ESL_VOLUME_DIMS
    full = torch.empty((n, n, n, 2), dtype=torch.uint8, device=data.device)
    full[..., 0] = 255
    full[..., 1] = 0
    full[:nbz, :nby, :nbx, 0] = block_reduce(255, torch.amin)
    full[:nbz, :nby, :nbx, 1] = block_reduce(0, torch.amax)
    return full


def derive_empty_grid(min_max: torch.Tensor,
                      premult_tf: torch.Tensor) -> torch.Tensor:
    """Per-block emptiness ``bool[32, 32, 32]`` under the current TF:
    ``first_opaque[min / TF_RATIO] > max / TF_RATIO``
    (reference: RaycasterBase.cpp:62-67)."""
    first_opaque = first_opaque_index(premult_tf)
    lo_bucket = min_max[..., 0].to(torch.int64) // TF_RATIO
    hi_bucket = min_max[..., 1].to(torch.int64) // TF_RATIO
    return first_opaque[lo_bucket] > hi_bucket


def pack_bitmask(empty: torch.Tensor) -> torch.Tensor:
    """Pack ``bool[32, 32, 32]`` into the reference's 1024 words, word
    ``z*32 + y``, bit ``x`` (reference: RaycasterBase.h:59-64). torch has no
    uint32 arithmetic, so the words come back as ``int64`` in
    ``[0, 2^32)``."""
    weights = torch.ones((), dtype=torch.int64, device=empty.device) << (
        torch.arange(32, device=empty.device))
    return (empty.to(torch.int64) * weights).sum(-1).reshape(-1)


def pack_words(empty: torch.Tensor) -> torch.Tensor:
    """:func:`pack_bitmask` as the kernels read it: ``int32[1024]`` holding
    the ``uint32`` words' bits (torch has no ``uint32`` arithmetic)."""
    words = pack_bitmask(empty)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def unpack_bitmask(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bitmask` and :func:`pack_words`."""
    words = (words.to(torch.int64) & 0xFFFFFFFF).reshape(
        ESL_VOLUME_DIMS, ESL_VOLUME_DIMS, 1)
    shifts = torch.arange(32, device=words.device)
    return ((words >> shifts) & 1).to(torch.bool)


def empty_distance_grid(empty: torch.Tensor) -> torch.Tensor:
    """Chebyshev distance in blocks to the nearest non-empty block,
    ``int64[32, 32, 32]``: 0 at non-empty blocks, and ``m >= 1`` means every
    block within max-norm radius ``m - 1`` is empty. 31 rounds of a 3x3x3
    minimum (a negated max-pool; its border padding never wins, as the
    JAX package's border value 32 never does), each adding one
    (``volrt/core/esl.py:85-104``)."""
    n = ESL_VOLUME_DIMS
    d = torch.where(empty, float(n), 0.0)[None, None]
    for _ in range(n - 1):
        m = -F.max_pool3d(-d, kernel_size=3, stride=1, padding=1)
        d = torch.minimum(d, m + 1.0)
    return d[0, 0].to(torch.int64)


def esl_tables(empty: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """What the kernels read of an emptiness grid, built once per TF:
    ``(dist, words)``, the distance grid as ``int32[32, 32, 32]`` (the
    leading leap's, :func:`empty_distance_grid`) and the packed words
    ``int32[1024]`` (the v3 kernels' ESL mode, :func:`pack_words`)."""
    return empty_distance_grid(empty).to(torch.int32), pack_words(empty)


def _block_idx(pos: torch.Tensor, dims: tuple[int, int, int],
               block_dims: int) -> torch.Tensor:
    return world_to_voxel_idx(pos, dims) // block_dims


def sample_empty(empty: torch.Tensor, pos: torch.Tensor,
                 dims: tuple[int, int, int], block_dims: int) -> torch.Tensor:
    """Is the ESL block that holds world position ``pos (..., 3)`` empty?
    (reference: RaycasterBase.h:52-65)."""
    bx, by, bz = _block_idx(pos, dims, block_dims).unbind(-1)
    return empty[bz, by, bx]


def leap_distance(pos: torch.Tensor, directions: torch.Tensor,
                  dims: tuple[int, int, int], block_dims: int,
                  block_size: tuple[float, float, float], ray_step: float,
                  min_bound: tuple[float, float, float] = (-1.0, -1.0, -1.0),
                  ) -> torch.Tensor:
    """Ray parameter to leap to the exit face of the ESL block holding
    ``pos``, rounded down to whole ray steps so that the ray keeps its
    sampling lattice (reference: RaycasterBase.h:67-85). ``pos`` and
    ``directions`` are ``(..., 3)``; returns ``f32 (...)``."""
    idx = _block_idx(pos, dims, block_dims)
    # The far face along the axes on which the ray moves forward.
    idx = idx + (directions > 0.0).to(torch.int64)
    lo = torch.cat([pos.new_full((1,), v) for v in min_bound])
    size = torch.cat([pos.new_full((1,), v) for v in block_size])
    boundary = lo + size * idx.to(torch.float32)
    kp = (boundary - pos) / directions
    kp = torch.where(directions == 0.0, 100.0, kp)
    dk = kp.amin(dim=-1).clamp(min=0.0)
    # The divisor is a tensor on dk's device: torch divides a CUDA tensor
    # by a Python number as a product with its reciprocal, which rounds
    # otherwise than the CPU's division and the leap kernel's.
    return torch.floor(dk / dk.new_full((), ray_step)) * ray_step
