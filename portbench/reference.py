"""The benchmark's plain reference: what the cells drive, as plain torch ops.

It imports nothing of the program. It works out again, from the inputs the
benchmark makes, everything the program derives from them: the rays, the
premultiplied transfer function (TF), the empty-space (ESL) block grid,
its distance grid, the leading leap, the bf16 density copy of the fast
mode, and the marches (rung 5's, the ladder's and the training step's).
Each per-sample operation is written in the order of the marches'
definition (trilinear taps lerped along x, then y, then z; the TF lerped
at ``s * 128 - 0.5``; front-to-back premultiplied compositing), every
multiply and add a torch op of its own, so that on a card the reference
rounds as a march that rounds each operation does.

The marches step their rays in lockstep, dropping those that have ended;
the training step's, under autograd, classifies a chunk of rays' samples
at once and composites them by a product scan.
``dtype`` computes a march in a lower precision than f32 (the controls);
``rnd`` is the fast mode's storage rounding (bf16, or fp8 for a control).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

TF_SIZE = 128
TF_RATIO = 256 // TF_SIZE
ESL_DIMS = 32
ESL_MIN_BLOCK = 8
SHADE_ALPHA_GATE = 0.05
SHADE_KD_GATE = 0.01
SHADE_LIGHT_OFFSET = 0.01
PHONG_KA = 0.3
PHONG_KS = 0.2
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each stream of one run's inputs."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), int(stream)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


# ---------------------------------------------------------------- inputs

def default_tf_base(device) -> torch.Tensor:
    """The default RGB ramp TF, un-premultiplied ``f32[128, 4]``: R over the
    first third, G the middle, B the last; alpha ramps, zero below
    ``255 * 0.1 / TF_RATIO`` (VolR, RaycasterBase.cpp:76-84)."""
    i = np.arange(TF_SIZE, dtype=np.float32)
    third = TF_SIZE // 3
    r = np.where(i <= third, (i * 3) / TF_SIZE, 0.0)
    g = np.where((i > third) & (i <= 2 * third),
                 ((i - third) * 3) / TF_SIZE, 0.0)
    b = np.where(i > 2 * third, ((i - 2 * third) * 3) / TF_SIZE, 0.0)
    a = np.where(i > (255.0 * 0.1) / TF_RATIO, i / TF_SIZE, 0.0)
    return torch.tensor(np.stack([r, g, b, a], -1), dtype=torch.float32,
                        device=device)


def synthetic_volume(n: int, seed: int, device, stream: int = 0,
                     noise: float = 20.0) -> torch.Tensor:
    """The synthetic ``uint8[n, n, n]`` volume, made on ``device``: a soft
    shell at 0.7 of the radius (200), a central blob (255) and uniform noise
    in ``[0, noise)`` drawn from ``seed`` and ``stream``, clipped and
    truncated to uint8. Made a z-slice block at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, stream))
    out = torch.empty((n, n, n), dtype=torch.uint8, device=device)
    c = (n - 1) / 2.0
    ax = (torch.arange(n, dtype=torch.float32, device=device) - c) ** 2
    yx = ax[:, None] + ax[None, :]
    rows = max(1, (1 << 24) // (n * n))
    for z0 in range(0, n, rows):
        z = ax[z0:z0 + rows, None, None]
        r = torch.sqrt(z + yx) / c
        v = (torch.exp(-((r - 0.7) ** 2) / 0.02) * 200.0
             + torch.exp(-(r ** 2) / 0.08) * 255.0
             + torch.rand(r.shape, generator=gen, device=device) * noise)
        out[z0:z0 + rows] = v.clamp(0.0, 255.0).to(torch.uint8)
    return out


def default_ray_step(dims) -> float:
    """The march step from the largest dimension (RaycasterBase.cpp:86-92)."""
    step = 2.0 / max(dims)
    return step - step / max(dims)


def max_steps(ray_step: float) -> int:
    """Samples a ray may take: the cube's chord over the step, plus two."""
    return int(math.ceil(2.0 * math.sqrt(3.0) / ray_step)) + 2


def _rot(axis: int, deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    m = {0: [[1, 0, 0], [0, c, -s], [0, s, c]],
         1: [[c, 0, s], [0, 1, 0], [-s, 0, c]],
         2: [[c, -s, 0], [s, c, 0], [0, 0, 1]]}[axis]
    return np.array(m, np.float32)


def pose(angles, perspective: bool, distance: float, dims) -> dict:
    """An orbit camera's view: the camera ``distance`` from the centre,
    rotated by ``Rx(-ax) Ry(-ay) Rz(-az)``; an orthographic plane as wide
    as the distance, a perspective one 1.5 wide at unit distance
    (ViewBase.cpp:26-55, 85-105). The light stays at (0, 0, 3). Returns
    f32 numpy vectors and the viewport ``dims (W, H)``."""
    ax, ay, az = angles
    rot = _rot(0, -ax) @ _rot(1, -ay) @ _rot(2, -az)
    dist = float(np.clip(distance, 0.1, 3.0))
    size = 1.5 if perspective else dist
    origin = rot @ np.array([0, 0, dist], np.float32)
    w, h = dims
    step_px = size / min(w, h)
    return {
        "origin": origin,
        "direction": -origin / np.linalg.norm(origin),
        "right": rot @ np.array([step_px, 0, 0], np.float32),
        "up": rot @ np.array([0, step_px, 0], np.float32),
        "light": np.array([0, 0, 3.0], np.float32),
        "dims": (int(w), int(h)),
        "perspective": bool(perspective),
    }


def poses(spec: dict, dims) -> list[dict]:
    """The views of a traffic file's ``poses``: each angle triple, in
    each projection, at ``distance``."""
    return [pose(a, proj == "persp", spec["distance"], dims)
            for a in spec["angles"] for proj in spec["projections"]]


def _vec(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32).reshape(3),
                        device=device).to(dtype)


def rays(view: dict, device, dtype=torch.float32) -> dict:
    """A view's rays in raster order and where each meets the cube
    ``[-1, 1]^3``: ``o``, ``d`` ``[N, 3]``, ``knear`` (clamped to 0),
    ``kfar``, ``hit`` (ViewBase.h:23-35, RaycasterBase.h:32-42)."""
    w, h = view["dims"]
    px = (torch.arange(w, dtype=dtype, device=device) - (w // 2))[None, :, None]
    py = (torch.arange(h, dtype=dtype, device=device) - (h // 2))[:, None, None]
    plane = (_vec(view["right"], device, dtype) * px
             + _vec(view["up"], device, dtype) * py)
    origin = _vec(view["origin"], device, dtype)
    direction = _vec(view["direction"], device, dtype)
    if view["perspective"]:
        o, d = origin.expand(plane.shape), direction + plane
    else:
        o, d = origin + plane, direction.expand(plane.shape)
    o = o.reshape(-1, 3).contiguous()
    d = d.reshape(-1, 3).contiguous()
    lo = torch.cat([o.new_full((1,), -1.0) for _ in range(3)])
    hi = -lo
    dd = torch.where(d == 0.0, 1e-5, d)
    k1 = (lo - o) / dd
    k2 = (hi - o) / dd
    knear = torch.minimum(k1, k2).amax(dim=-1).clamp(min=0.0)
    kfar = torch.maximum(k1, k2).amin(dim=-1)
    hit = (knear < kfar) & (kfar > 0.0)
    return {"o": o, "d": d, "knear": knear, "kfar": kfar, "hit": hit,
            "light": _vec(view["light"], device, dtype)}


def premultiply(base: torch.Tensor) -> torch.Tensor:
    return torch.cat([base[:, :3] * base[:, 3:4], base[:, 3:4]], -1)


# ------------------------------------------------------------------- ESL

def esl_block(dims) -> int:
    """Voxels per ESL block edge (RaycasterBase.cpp:97-99)."""
    return max(ESL_MIN_BLOCK, -(-max(dims) // ESL_DIMS))


def esl_empty(vol_u8: torch.Tensor, premult_tf: torch.Tensor
              ) -> tuple[torch.Tensor, int]:
    """Which ``32^3`` ESL blocks the TF leaves empty -> ``(bool[32, 32,
    32], block)``: a block is empty when the first TF bucket at or above
    its minimum's with nonzero opacity lies above its maximum's; blocks
    outside the volume read as empty (RaycasterBase.cpp:53-67, 94-125)."""
    d, h, w = vol_u8.shape
    b = esl_block((w, h, d))
    nz, ny, nx = -(-d // b), -(-h // b), -(-w // b)
    pad = (0, nx * b - w, 0, ny * b - h, 0, nz * b - d)
    lo = F.pad(vol_u8, pad, value=255).reshape(nz, b, ny, b, nx, b).amin(
        dim=(1, 3, 5))
    hi = F.pad(vol_u8, pad, value=0).reshape(nz, b, ny, b, nx, b).amax(
        dim=(1, 3, 5))
    idx = torch.arange(TF_SIZE, device=vol_u8.device)
    cand = torch.where(premult_tf[:, 3] != 0.0, idx, TF_SIZE)
    first = torch.cummin(cand.flip(0), 0).values.flip(0)
    empty = torch.ones((ESL_DIMS,) * 3, dtype=torch.bool,
                       device=vol_u8.device)
    empty[:nz, :ny, :nx] = (first[lo.to(torch.int64) // TF_RATIO]
                            > hi.to(torch.int64) // TF_RATIO)
    return empty, b


def esl_distance(empty: torch.Tensor) -> torch.Tensor:
    """Chebyshev distance in blocks to the nearest non-empty block,
    ``int32[32, 32, 32]``."""
    d = torch.where(empty, float(ESL_DIMS), 0.0)[None, None]
    for _ in range(ESL_DIMS - 1):
        m = -F.max_pool3d(-d, kernel_size=3, stride=1, padding=1)
        d = torch.minimum(d, m + 1.0)
    return d[0, 0].to(torch.int32)


def voxel_idx(pos: torch.Tensor, dims) -> torch.Tensor:
    """Nearest voxel ``(ix, iy, iz)`` of world positions, truncated and
    clamped to the volume ``dims (W, H, D)``."""
    n = torch.tensor(dims, dtype=pos.dtype, device=pos.device)
    i = ((pos + 1.0) * 0.5 * n).to(torch.int64)
    return torch.minimum(i.clamp(min=0), (n - 1).to(torch.int64))


def leap_start(r: dict, dist: torch.Tensor, dims, block: int,
               ray_step: float) -> torch.Tensor:
    """Each ray's first sample after the leading empty-space leap: a ray
    in a block ``m`` blocks from the nearest non-empty one leaps the larger
    of the way to its block's exit face and ``m - 1`` block widths, each
    rounded down to whole steps, plus one step, until it stands in a block
    with ``m == 0`` or has left the cube (RaycasterBase.h:67-85,
    CPURenderer.cpp:18-25). Divisions are by tensors, as IEEE divisions."""
    o, d, k, kfar = r["o"], r["d"], r["knear"], r["kfar"]
    w, h, depth = dims
    size = (2.0 * block / w, 2.0 * block / h, 2.0 * block / depth)
    min_bw = min(size)
    x, y, z = d.unbind(-1)
    dnorm = torch.sqrt((x * x + y * y) + z * z + 1e-20)
    step_t = k.new_full((), ray_step)
    lo = torch.cat([o.new_full((1,), -1.0) for _ in range(3)])
    size_t = torch.cat([o.new_full((1,), v) for v in size])
    stopped = ~r["hit"]
    for i in range(max_steps(ray_step)):
        pt = o + d * k[..., None]
        bidx = voxel_idx(pt, dims) // block
        ix, iy, iz = bidx.unbind(-1)
        m = dist[iz, iy, ix]
        do_leap = (k <= kfar) & (m >= 1) & ~stopped
        face = lo + size_t * (bidx + (d > 0.0).to(torch.int64)).to(pt.dtype)
        kp = torch.where(d == 0.0, 100.0, (face - pt) / d)
        dk = kp.amin(dim=-1).clamp(min=0.0)
        dk = torch.floor(dk / dk.new_full((), ray_step)) * ray_step
        ball = torch.floor(
            (m - 1).to(pt.dtype) * min_bw / dnorm / step_t) * ray_step
        k = torch.where(do_leap, k + torch.maximum(dk, ball) + ray_step, k)
        stopped = stopped | ~do_leap
        if i % 8 == 7 and bool(stopped.all()):
            break
    return k


# ----------------------------------------------------------- per sample

def _lerp(a, b, f):
    return a * (1 - f) + b * f


def cell(shape, pos: torch.Tensor) -> tuple:
    """The clamp-addressed trilinear cell at world ``pos (N, 3)`` of a grid
    ``shape (D, H, W)``: voxel coordinate ``t = (pos + 1) * 0.5 * n - 0.5``,
    the two taps (clamped to ``[0, n - 1]``) and the second's weight."""
    d, h, w = shape
    n = torch.tensor([w, h, d], dtype=pos.dtype, device=pos.device)
    t = (pos + 1.0) * 0.5 * n - 0.5
    i0 = torch.floor(t)
    frac = t - i0
    i0 = i0.to(torch.int64)
    top = torch.tensor([w - 1, h - 1, d - 1], device=pos.device)
    i1 = torch.minimum(torch.clamp(i0 + 1, min=0), top)
    i0 = torch.minimum(torch.clamp(i0, min=0), top)
    return t, (i0, i1, frac)


def _taps(grid, c):
    _, h, w = grid.shape
    (x0, y0, z0), (x1, y1, z1), (fx, fy, fz) = (a.unbind(-1) for a in c)
    flat = grid.reshape(-1)

    def tap(z, y, x):
        return flat.index_select(0, ((z * h + y) * w + x).reshape(-1)
                                 ).reshape(x.shape)

    return (x0, y0, z0), (x1, y1, z1), (fx, fy, fz), tap


def sample(grid: torch.Tensor, c: tuple, dtype) -> torch.Tensor:
    """The trilinear sample over a cell: the eight taps lerped along x,
    then y, then z."""
    (x0, y0, z0), (x1, y1, z1), (fx, fy, fz), tap = _taps(grid, c)

    def t(z, y, x):
        return tap(z, y, x).to(dtype)

    c0 = _lerp(_lerp(t(z0, y0, x0), t(z0, y0, x1), fx),
               _lerp(t(z0, y1, x0), t(z0, y1, x1), fx), fy)
    c1 = _lerp(_lerp(t(z1, y0, x0), t(z1, y0, x1), fx),
               _lerp(t(z1, y1, x0), t(z1, y1, x1), fx), fy)
    return _lerp(c0, c1, fz)


def _fast_axis(u, n):
    i0 = torch.floor(u)
    lo = 1.0 - (u - i0)
    i0 = i0.to(torch.int64)
    return i0, torch.minimum(i0 + 1, (n - 1).to(torch.int64)), 1.0 - lo


def fast_cell(shape, pos: torch.Tensor) -> tuple:
    """The fast mode's cell: the voxel coordinate clipped to ``[0, n - 1]``,
    its floor and the next voxel (clamped), the second tap's hat weight
    ``1 - RN(1 - frac)``."""
    d, h, w = shape
    n = torch.tensor([w, h, d], dtype=pos.dtype, device=pos.device)
    u = torch.minimum(((pos + 1.0) * 0.5 * n - 0.5).clamp(min=0.0), n - 1.0)
    i0, i1, fr = zip(*(_fast_axis(u[..., a], n[a]) for a in range(3)))
    return torch.stack(i0, -1), torch.stack(i1, -1), torch.stack(fr, -1)


def fast_sample(grid: torch.Tensor, c: tuple, rnd,
                grad: bool = False) -> torch.Tensor:
    """The fast mode's sample of a grid that holds stored (rounded) values:
    each (z, y) weight product rounded by ``rnd``, the four taps of a row
    summed z-major, then ``sum_x hat_x * row_x``.

    Its gradient (``grad``) takes the taps' weights unrounded, as the fast
    mode's scatter does: the value is the fast sample's, the derivative
    that of the sum with f32 weights ``(w_z w_y) w_x``."""
    (x0, y0, z0), (x1, y1, z1), (fx, fy, fz), tap = _taps(grid, c)
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    w00, w01, w10, w11 = rnd(gz * gy), rnd(gz * fy), rnd(fz * gy), rnd(fz * fy)

    def row(x):
        return (((w00 * tap(z0, y0, x) + w01 * tap(z0, y1, x))
                 + w10 * tap(z1, y0, x)) + w11 * tap(z1, y1, x))

    value = gx * row(x0) + fx * row(x1)
    if not grad:
        return value
    f32 = sum(((wz * wy) * wx) * tap(z, y, x)
              for z, wz in ((z0, gz), (z1, fz)) for y, wy in ((y0, gy), (y1, fy))
              for x, wx in ((x0, gx), (x1, fx)))
    return f32 + (value - f32).detach()


def tf_lerp(tf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The TF lerped at ``s * 128 - 0.5``, entries at integer centres."""
    t = s * TF_SIZE - 0.5
    i0 = torch.floor(t)
    frac = (t - i0)[..., None]
    i0 = i0.to(torch.int64)

    def row(i):
        i = i.clamp(0, TF_SIZE - 1)
        return tf.index_select(0, i.reshape(-1)).reshape(*i.shape, 4)

    return _lerp(row(i0), row(i0 + 1), frac)


def composite(acc, color):
    return acc + color * (1.0 - acc[..., 3:4])


def _rsqrt(x):
    return torch.sqrt(x).reciprocal()


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _positive(x):
    return torch.where(x > 0.0, x, 0.0)


def eye_dir(d):
    return -d * _rsqrt(_dot(d, d) + 1e-20)[:, None]


def gradient_cells(shape, pos, fast: bool) -> list:
    """The six cells of the central-difference gradient, x + 1, x - 1,
    y + 1, ...: the sample's voxel coordinate on one axis clipped to
    ``[0, n - 1]``, moved one voxel and clipped again, the sample's own
    cell on the other two."""
    d, h, w = shape
    t, (i0, i1, frac) = cell(shape, pos)
    if fast:
        i0, i1, frac = fast_cell(shape, pos)
    top = torch.tensor([w - 1, h - 1, d - 1], dtype=pos.dtype,
                       device=pos.device)
    tc = torch.minimum(t.clamp(min=0.0), top)
    cells = []
    for axis in range(3):
        for by in (1.0, -1.0):
            u = torch.minimum((tc[:, axis] + by).clamp(min=0.0), top[axis])
            if fast:
                j0, j1, f = _fast_axis(u, top[axis] + 1.0)
            else:
                j0 = torch.floor(u)
                f = u - j0
                j0 = j0.to(torch.int64)
                j1 = torch.minimum(j0 + 1, top[axis].to(torch.int64))
            lo, hi, fr = i0.clone(), i1.clone(), frac.clone()
            lo[:, axis], hi[:, axis], fr[:, axis] = j0, j1, f
            cells.append((lo, hi, fr))
    return cells


def phong(sampler, shape, fast, color, pt, eye, light, kd):
    """Gradient Blinn-Phong on premultiplied ``color``: ``rgb (KA + kd
    max(n.L, 0)) + KS max(n.H / |H|, 0)^16 alpha`` with ``n`` the negated,
    normalised central difference, where alpha > 0.05 and kd > 0.01
    -> ``(colour, gate)``."""
    s = [sampler(c) for c in gradient_cells(shape, pt, fast)]
    g = torch.stack([s[0] - s[1], s[2] - s[3], s[4] - s[5]], -1)
    nrm = -g * _rsqrt(_dot(g, g) + 1e-16)[:, None]
    lv = light - pt
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
    rgb = torch.where(gate[:, None], color[:, :3] * lit[:, None]
                      + spec[:, None], color[:, :3])
    return torch.cat([rgb, color[:, 3:4]], -1), gate


def esl_skip(empty, block, shape, pt) -> torch.Tensor:
    """A sample is skipped when every ESL block of its clamp-addressed
    trilinear cell (low and high tap on each axis) is empty."""
    _, (i0, i1, _) = cell(shape, pt.to(torch.float32))
    lo, hi = i0 // block, i1 // block
    skip = torch.ones(pt.shape[0], dtype=torch.bool, device=pt.device)
    for z in (lo[:, 2], hi[:, 2]):
        for y in (lo[:, 1], hi[:, 1]):
            for x in (lo[:, 0], hi[:, 0]):
                skip &= empty[z, y, x]
    return skip


# --------------------------------------------------------------- marches

class Counts:
    """Samples a march took, skipped (ESL) and shaded (phong's gate)."""

    def __init__(self, device):
        self.taken = torch.zeros((), dtype=torch.int64, device=device)
        self.skipped = torch.zeros_like(self.taken)
        self.gated = torch.zeros_like(self.taken)

    def as_dict(self) -> dict:
        return {"taken": int(self.taken), "skipped": int(self.skipped),
                "gated": int(self.gated)}


def _span_steps(r, sl, ray_step) -> int:
    """Lattice points the longest live ray of ``sl`` can take, and two."""
    span = torch.where(r["alive"][sl], r["kfar"][sl] - r["k0"][sl], 0.0)
    if not span.numel():
        return 0
    return min(max_steps(ray_step), int(span.max().item() / ray_step) + 2)


class _Live:
    """The rays still marching, kept packed: each step works on those
    alone, and a ray that has ended leaves its colour in ``out``."""

    def __init__(self, r: dict, n_out: int, fields: dict):
        self.idx = torch.nonzero(r["alive"]).squeeze(1)
        self.t = {k: v.index_select(0, self.idx) for k, v in fields.items()}
        self.acc = torch.zeros((self.idx.numel(), 4), dtype=r["o"].dtype,
                               device=r["o"].device)
        self.out = torch.zeros((n_out, 4), dtype=r["o"].dtype,
                               device=r["o"].device)

    def retire(self, live: torch.Tensor) -> None:
        if bool(live.all()):
            return
        done = ~live
        self.out[self.idx[done]] = self.acc[done]
        self.idx, self.acc = self.idx[live], self.acc[live]
        self.t = {k: v[live] for k, v in self.t.items()}

    def result(self) -> torch.Tensor:
        self.out[self.idx] = self.acc
        return self.out


def v3_rays(view: dict, device, dtype=torch.float32) -> dict:
    """Rung 5's and the training step's rays: start at ``knear``, alive
    where they meet the cube."""
    r = rays(view, device, dtype)
    r["k0"] = r["knear"]
    r["alive"] = r["hit"] & (r["knear"] <= r["kfar"])
    return r


def _v3_classify(grid, tf, dtype, fast, grad):
    """``(sampler, classify)`` of a density: ``sampler(cell)`` the sample,
    ``classify(pt)`` the lerped TF's colour at ``pt``."""
    shape = grid.shape
    if fast is None:
        def sampler(c):
            return sample(grid, c, dtype)

        def classify(pt):
            return tf_lerp(tf, sampler(cell(shape, pt)[1]))
    else:
        def sampler(c):
            return fast_sample(grid, c, fast, grad)

        def classify(pt):
            return tf_lerp(tf, sampler(fast_cell(shape, pt)))
    return sampler, classify


def march_v3(r: dict, grid: torch.Tensor, tf: torch.Tensor, *,
             ray_step: float, thr: float, kd: float = 0.0,
             phong_on: bool = False, esl=None, fast=None,
             counts: Counts | None = None) -> torch.Tensor:
    """Rung 5's march (and the training step's forward) -> ``[N, 4]``.

    Samples lie at ``k0 + i * step`` while ``k <= kfar``; ERT ends a ray
    once its opacity passes ``thr`` (never where ``thr >= 1``); ``esl =
    (empty, block)`` skips a sample whose cell lies in empty blocks. The
    grid is an f32 density in [0, 1], sampled trilinearly, or with
    ``fast`` (the storage rounding) the fast mode's sample of a grid that
    holds rounded values. ``phong_on`` shades with gradient Blinn-Phong
    under ``kd`` and ``r["light"]``. The rays march in lockstep, those
    that have ended dropped after each step."""
    dtype = r["o"].dtype
    shape = grid.shape
    sampler, classify = _v3_classify(grid, tf, dtype, fast, False)
    steps = torch.arange(max_steps(ray_step), dtype=dtype,
                         device=r["o"].device) * ray_step
    lv = _Live(r, r["o"].shape[0], {k: r[k] for k in ("o", "d", "k0",
                                                      "kfar")})
    if phong_on:
        lv.t["eye"] = eye_dir(lv.t["d"])
    for i in range(steps.shape[0]):
        if lv.idx.numel() == 0:
            break
        t = lv.t
        k = t["k0"] + steps[i]
        inside = k <= t["kfar"]
        pt = t["o"] + t["d"] * k[:, None]
        active = inside
        if esl is not None:
            sk = esl_skip(esl[0], esl[1], shape, pt)
            if counts is not None:
                counts.skipped += (inside & sk).sum()
            active = inside & ~sk
        color = classify(pt)
        if phong_on:
            color, gate = phong(sampler, shape, fast is not None, color, pt,
                                t["eye"], r["light"], kd)
            if counts is not None:
                counts.gated += (active & gate).sum()
        if counts is not None:
            counts.taken += active.sum()
        lv.acc = torch.where(active[:, None], composite(lv.acc, color),
                             lv.acc)
        live = inside
        if thr < 1.0:
            live = live & ~(active & (lv.acc[:, 3] > thr))
        lv.retire(live)
    return lv.result()


def march_scan(r: dict, grid: torch.Tensor, tf: torch.Tensor, *,
               ray_step: float, thr: float, kd: float = 0.0,
               phong_on: bool = False, fast=None, points: int = 1 << 24
               ) -> torch.Tensor:
    """:func:`march_v3` (without ESL) for autograd: every sample of a chunk
    of rays (``points`` samples at most) classified at once and composited
    by a product scan, each colour weighed by the transmittance in front
    of it, ``prod (1 - alpha)`` over the samples before; ERT ends a ray
    after the first sample whose opacity ``1 - prod (1 - alpha)`` passes
    ``thr``. The same function rounded in another order (a few f32 ulps),
    at a memory autograd can hold."""
    dtype = r["o"].dtype
    shape = grid.shape
    sampler, classify = _v3_classify(grid, tf, dtype, fast,
                                     torch.is_grad_enabled())
    n_all = max(1, _span_steps(r, slice(None), ray_step))
    chunk = max(1, points // n_all)
    out = []
    for lo in range(0, r["o"].shape[0], chunk):
        sl = slice(lo, lo + chunk)
        n = _span_steps(r, sl, ray_step)
        oc, dc, kf = r["o"][sl], r["d"][sl], r["kfar"][sl]
        rays_n = oc.shape[0]
        steps = torch.arange(n, dtype=dtype, device=oc.device) * ray_step
        k = r["k0"][sl][:, None] + steps[None, :]
        valid = r["alive"][sl][:, None] & (k <= kf[:, None])
        pt = (oc[:, None, :] + dc[:, None, :] * k[..., None]).reshape(-1, 3)
        color = classify(pt)
        if phong_on:
            eye = eye_dir(dc)[:, None, :].expand(rays_n, n, 3).reshape(-1, 3)
            color = phong(sampler, shape, fast is not None, color, pt, eye,
                          r["light"], kd)[0]
        color = color.reshape(rays_n, n, 4) * valid[..., None]
        trans = torch.cumprod(1.0 - color[..., 3], dim=1)
        before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
        active = valid
        if thr < 1.0:
            ended = valid & (1.0 - trans.detach() > thr)
            active = valid & ((ended.cumsum(1) - ended.to(torch.int64)) == 0)
        out.append((color * (before * active)[..., None]).sum(1))
    return torch.cat(out)


def cat_rays(rs: list[dict]) -> dict:
    """The rays of several views as one set (one light for all)."""
    return {k: (rs[0][k] if k == "light" else torch.cat([r[k] for r in rs]))
            for k in rs[0]}


def ladder_start(r: dict, vol_u8: torch.Tensor, tf: torch.Tensor,
                 ray_step: float, leap: bool) -> dict:
    """The ladder's rays: start after the leading leap (on the distance
    grid of the volume under ``tf``) where ``leap``, alive where they meet
    the cube and start inside it."""
    k0 = r["knear"]
    if leap:
        d, h, w = vol_u8.shape
        empty, block = esl_empty(vol_u8, tf.to(torch.float32))
        k0 = leap_start(r, esl_distance(empty), (w, h, d), block, ray_step)
    return dict(r, k0=k0, alive=r["hit"] & (k0 <= r["kfar"]))


def march_ladder(r: dict, raw: torch.Tensor, tf: torch.Tensor, *,
                 ray_step: float, thr: float, kd: float,
                 counts: Counts | None = None) -> torch.Tensor:
    """Rung 3's march over raw voxel values 0..255 -> ``[N, 4]``: the ray
    parameter accumulated ``k += step`` from ``k0`` while ``k <= kfar``,
    the trilinear sample divided by 255 (a division) before the lerped TF,
    the one-tap diffuse ``(s(p + 0.01 L) - s) kd`` where alpha and kd pass
    their gates (GPURenderer4.cu:41-87), ERT past ``thr``. The rays march
    in lockstep, those that have ended dropped after each step."""
    dtype = r["o"].dtype
    shape = raw.shape
    light = r["light"]

    def sample01(pt):
        s = sample(raw, cell(shape, pt)[1], dtype)
        return s / s.new_full((), 255.0)

    lv = _Live(r, r["o"].shape[0], {"o": r["o"], "d": r["d"],
                                    "k": r["k0"], "kfar": r["kfar"]})
    for _ in range(max_steps(ray_step)):
        if lv.idx.numel() == 0:
            break
        t = lv.t
        pt = t["o"] + t["d"] * t["k"][:, None]
        s = sample01(pt)
        color = tf_lerp(tf, s)
        if kd > SHADE_KD_GATE:
            to_light = light - pt
            tap = pt + to_light / torch.linalg.vector_norm(
                to_light, dim=-1, keepdim=True) * SHADE_LIGHT_OFFSET
            gate = color[:, 3] > SHADE_ALPHA_GATE
            diffuse = torch.where(gate, (sample01(tap) - s) * kd, 0.0)
            color = torch.cat([color[:, :3] + diffuse[:, None],
                               color[:, 3:4]], -1)
        if counts is not None:
            counts.taken += t["k"].numel()
        lv.acc = composite(lv.acc, color)
        t["k"] = t["k"] + ray_step
        live = t["k"] <= t["kfar"]
        if thr < 1.0:
            live = live & ~(lv.acc[:, 3] > thr)
        lv.retire(live)
    return lv.result()


def write_color(img: torch.Tensor) -> torch.Tensor:
    """Float RGBA to uint8, ``(long)(c * 256)`` clamped (RaycasterBase.h:
    44-50)."""
    return (img * 256).to(torch.int32).clamp(0, 255).to(torch.uint8)


# -------------------------------------------------------------- training

def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).to(torch.float32)


def l2_loss_grads(density: torch.Tensor, tf_base: torch.Tensor, r: dict,
                  target: torch.Tensor, *, ray_step: float, thr: float,
                  kd: float, phong_on: bool, rnd, points: int
                  ) -> tuple[float, torch.Tensor, torch.Tensor]:
    """The mean-square loss of the march of ``density`` (stored rounded by
    ``rnd``: the fast mode) under the premultiplied ``tf_base`` against
    ``target [N, 4]``, and its gradients with respect to both leaves, by
    autograd of :func:`march_scan`, a chunk of rays at a time -> ``(loss,
    d_density, d_tf_base)``. The storage rounding passes the gradient
    through unrounded."""
    dens = density.detach().clone().requires_grad_(True)
    base = tf_base.detach().clone().requires_grad_(True)
    n = r["o"].shape[0]
    scale = 1.0 / (n * 4.0)
    n_all = max(1, _span_steps(r, slice(None), ray_step))
    chunk = max(1, points // n_all)
    loss = 0.0
    for lo in range(0, n, chunk):
        sl = slice(lo, lo + chunk)
        stored = dens + (rnd(dens.detach()) - dens.detach())
        part = {k: (v[sl] if torch.is_tensor(v) and v.dim() and k != "light"
                    else v) for k, v in r.items()}
        out = march_scan(part, stored, premultiply(base), ray_step=ray_step,
                         thr=thr, kd=kd, phong_on=phong_on, fast=rnd,
                         points=points)
        diff = out - target[sl]
        part_loss = (diff * diff).sum() * scale
        part_loss.backward()
        loss += float(part_loss.detach())
    return loss, dens.grad, base.grad


class Adam:
    """Adam with bias correction, ``eps`` outside the square root, no
    weight decay; each leaf clamped to [0, 1] after its update."""

    def __init__(self, params: list[torch.Tensor], lr: float):
        self.params = [p.detach().clone() for p in params]
        self.lr = lr
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    def step(self, grads: list[torch.Tensor]) -> None:
        b1, b2 = ADAM_BETAS
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, m, v, g in zip(self.params, self.m, self.v, grads):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2) + ADAM_EPS))
            p.clamp_(0.0, 1.0)
