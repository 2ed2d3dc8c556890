"""The bit-level identities that the per-sample code of the port's march
kernels (``volrt_torch/csrc/march_common.cuh``, shared by every kernel)
rests on, checked in numpy over the inputs the kernels can give them.

Each replaces a rounded operation of the plain march (``floorf`` and a
clamped float-to-int conversion, truncation, the TF's clamped rows, an
IEEE division by 255, an int-to-float conversion of the sample count)
with another sequence that must give the same bits, so that the kernels'
unshaded images stay equal to the plain versions' to the bit. One more, a
byte widened through the exponent, is the alternative to ``I2F`` that the
ladder was measured against and does not take. numpy's float32
arithmetic rounds to nearest as the card's ``__fmul_rn`` / ``__fadd_rn``
do; the card's round-down add (``__fadd_rd``) and its fused multiply-adds
are emulated exactly here. The last tests emulate the whole shared
classification of a density in [0, 1] (rung 5, round 1, the replays) and
hold it to ``march_fwd_plain`` bit for bit. The division is also checked
on the card over every f32 in [0, 256) (``chip_smoke.py`` phase 9).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_core import one_torch_thread  # noqa: F401
from volrt_torch.renderers.cuda.march import (
    MAX_STEPS_LIMIT, OFFSET_LIMIT, check_volume_shape, march_fwd_plain,
    max_steps, wide_offsets)

# csrc/march_common.cuh: the round-down bias 1.5 * 2^23 and its bits.
BIAS = np.float32(12582912.0)
BIAS_BITS = 0x4B400000
BYTE_BITS = 0x4B000000  # 2^23: its low byte takes a voxel of 0..255
TF_SIZE = 128
TF_RATIO = 256 // TF_SIZE
# Volume edges the kernel takes (w, h, depth up to 4096), and the TF's.
EDGES = (1, 2, 3, 5, 32, 255, 256, 257, 1000, 4096)
# The kernel's positions lie in the cube up to rounding, the light tap
# 0.01 beyond: |p| <= 1.02. The identities are checked for |p| <= 2.
P_MAX = 2.0


def f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def fadd_rd(a: np.ndarray, b: np.float32) -> np.ndarray:
    """``__fadd_rd(a, b)`` in f32: the exact sum rounded toward minus
    infinity. The sum is carried as an unevaluated pair (hi + lo) in f64,
    hi = RN64(a + b), lo exact (Fast2Sum with |b| >= |a|), then rounded
    down to the largest f32 not above it."""
    a64, b64 = a.astype(np.float64), np.float64(b)
    assert (np.abs(a64) <= abs(b64)).all()
    hi = a64 + b64
    lo = a64 - (hi - b64)
    r = hi.astype(np.float32)  # nearest; step down where above the sum
    r64 = r.astype(np.float64)
    above = (r64 > hi) | ((r64 == hi) & (lo < 0))
    return np.where(above, np.nextafter(r, np.float32(-np.inf)), r)


def magic_floor(t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's floor of t: ``m = __fadd_rd(t, BIAS)``, the floor as
    an int (``bits(m) - BIAS_BITS``) and as a float (``m - BIAS``)."""
    m = fadd_rd(t, BIAS)
    return (m.view(np.int32).astype(np.int64) - BIAS_BITS,
            (m - BIAS).astype(np.float32))


def near_grid(n: int, extra: np.ndarray) -> np.ndarray:
    """t values around every integer and half-integer of [-2, n + 1] (the
    value and its two f32 neighbours), the range's ends, and ``extra``."""
    grid = f32(np.arange(-4, 2 * n + 3) * 0.5)
    near = np.concatenate([grid, np.nextafter(grid, f32(-np.inf)),
                           np.nextafter(grid, f32(np.inf))])
    return np.concatenate([near, f32(extra)])


def axis_t(p: np.ndarray, n: int) -> np.ndarray:
    """The plain march's voxel coordinate ``(p + 1) * 0.5 * n - 0.5``,
    rounded op by op."""
    return ((p + f32(1)) * f32(0.5) * f32(n) - f32(0.5)).astype(np.float32)


@pytest.mark.parametrize("n", EDGES)
def test_round_down_add_is_floor_and_the_clamped_taps(n):
    """``floorf`` and the clamped conversion of the trilinear taps against
    the round-down add: the same floor, the same weight ``t - floor(t)``,
    the same two clamped taps, and the kernel's step between them (0 or 1)
    in place of the second clamp."""
    rng = np.random.default_rng(n)
    p = np.concatenate([
        f32(rng.uniform(-P_MAX, P_MAX, 200_000)),
        f32(np.linspace(-1.02, 1.02, 20_001)),
        f32([-P_MAX, -1, -0.0, 0, 1, P_MAX])])
    t = near_grid(n, np.concatenate([axis_t(p, n),
                                     [-(2.0 ** 22) + 1, 2.0 ** 22 - 1]]))
    assert np.abs(t).max() < 2.0 ** 22
    assert np.abs(axis_t(f32([-P_MAX, P_MAX]), 4096)).max() < 2.0 ** 22
    fl = np.floor(t)
    fi, ff = magic_floor(t)
    assert np.array_equal(ff, fl)
    assert np.array_equal(fi, fl.astype(np.int64))
    assert np.array_equal((t - ff).view(np.int32), (t - fl).view(np.int32))
    # The plain version clamps the float to [-1, n] before the conversion,
    # then clamps both taps to the volume.
    i = np.clip(fl, -1, n).astype(np.int64)
    i0, i1 = np.clip(i, 0, n - 1), np.clip(i + 1, 0, n - 1)
    assert np.array_equal(np.clip(fi, 0, n - 1), i0)
    assert np.array_equal(np.clip(fi + 1, 0, n - 1), i1)
    step = (fi.astype(np.uint32) < np.uint32(n - 1)).astype(np.int64)
    assert np.array_equal(i0 + step, i1)


@pytest.mark.parametrize("n", EDGES)
def test_half_scale_in_one_product(n):
    """``(p + 1) * 0.5 * n`` rounded twice equals ``(p + 1) * (n / 2)``
    rounded once: the product by 0.5 is exact, and n / 2 is an f32."""
    rng = np.random.default_rng(1000 + n)
    p = np.concatenate([f32(rng.uniform(-P_MAX, P_MAX, 400_000)),
                        f32(2.0 * (np.arange(n + 1) / n) - 1.0),
                        f32([-1, -0.0, 0, 1])])
    x = (p + f32(1)).astype(np.float32)
    two = (x * f32(0.5) * f32(n)).astype(np.float32)
    one = (x * f32(0.5 * n)).astype(np.float32)
    assert np.array_equal(two.view(np.int32), one.view(np.int32))


def test_tf_rows_from_the_padded_lut():
    """The TF lerp's rows: ``clamp(j, 0, 127)`` and ``clamp(j + 1, 0,
    127)`` of ``j = floor(s * 128 - 0.5)`` equal rows ``j' + 1`` and
    ``j' + 2`` of the LUT padded with a copy of its first and last rows,
    ``j' = clamp(j, -1, 127)``, for every density the kernel can see
    (raw 0..255 lerped, over 255) and beyond."""
    s = np.concatenate([f32(np.linspace(-0.1, 1.1, 100_001)),
                        f32(np.arange(256) / 255.0),
                        f32([-1e30, -2, 0, 1, 2, 1e30])])
    tc = (s * f32(TF_SIZE) - f32(0.5)).astype(np.float32)
    tc = np.concatenate([tc, near_grid(TF_SIZE, [])])
    fl = np.floor(tc)
    i = np.clip(fl, -1, TF_SIZE).astype(np.int64)
    lo, hi = np.clip(i, 0, TF_SIZE - 1), np.clip(i + 1, 0, TF_SIZE - 1)
    padded = np.concatenate([[0], np.arange(TF_SIZE), [TF_SIZE - 1]])
    small = np.abs(tc) < 2.0 ** 22
    fi, ff = magic_floor(tc[small])
    j = np.clip(fi, -1, TF_SIZE - 1)
    assert np.array_equal(ff, fl[small])
    assert np.array_equal(padded[j + 1], lo[small])
    assert np.array_equal(padded[j + 2], hi[small])


@pytest.mark.parametrize("n", EDGES)
def test_truncation_and_floor_agree_after_the_clamp(n):
    """Nearest mode addresses ``clamp(trunc(t), 0, n - 1)``; the kernel
    takes the floor. They differ only for t in (-1, 0), and both clamp to
    0 there; over (-2, 0) and the whole range too."""
    t = np.concatenate([f32(np.linspace(-2, 0, 200_001)[1:-1]),
                        near_grid(n, [])])
    trunc = np.clip(np.trunc(t).astype(np.int64), 0, n - 1)
    fi, _ = magic_floor(t)
    assert np.array_equal(np.clip(fi, 0, n - 1), trunc)


def test_tf_bucket_from_the_floor():
    """Nearest mode's TF bucket ``clamp(int(s) / TF_RATIO, 0, 127)`` (C
    truncation, both divisions) equals ``clamp(floor(s) >> 1, 0, 127)``
    on raw voxel values of 0..255, between them, and on (-2, 0)."""
    s = np.concatenate([f32(np.arange(256)),
                        f32(np.linspace(-2, 256, 200_003)),
                        near_grid(256, [])])
    t = np.trunc(s).astype(np.int64)
    want = np.clip(np.sign(t) * (np.abs(t) // TF_RATIO), 0, TF_SIZE - 1)
    fi, _ = magic_floor(s)
    assert np.array_equal(np.clip(fi >> 1, 0, TF_SIZE - 1), want)


def test_byte_to_float_through_the_exponent():
    """``bits(0x4B000000 | b) - 2^23`` is ``float(b)`` for all 256 bytes:
    2^23 + b is an f32 whose low mantissa bits are b. Exact, but two
    instructions where ``I2F`` is one: the kernel widens its uint8 taps by
    ``I2F`` (``csrc/march_ladder.cu``'s header)."""
    b = np.arange(256, dtype=np.uint32)
    got = ((b | np.uint32(BYTE_BITS)).view(np.float32)
           - f32(2.0 ** 23)).astype(np.float32)
    assert np.array_equal(got, b.astype(np.float32))


def test_division_by_255_in_three_rounded_operations():
    """``q = x * r``, ``e = fma(-q, 255, x)``, ``fma(e, r, q)`` with
    ``r = RN(1 / 255)`` equals the IEEE quotient ``x / 255`` on a stride
    of every f32 in [0, 256) (subnormals included), on all of [255, 256)
    (a lerp of raw values of 255 may round above 255), and on the 256 raw
    values; the card checks every f32 in [0, 256)."""
    top = int(f32(256.0).view(np.uint32))
    bits = np.unique(np.concatenate([
        np.arange(0, top, 4099, dtype=np.uint32),
        np.arange(0, 4096, dtype=np.uint32),
        np.arange(int(f32(255.0).view(np.uint32)), top, dtype=np.uint32),
        f32(np.arange(256)).view(np.uint32)]))
    x = bits.view(np.float32)
    r = np.float32(1.0) / np.float32(255.0)
    q = (x.astype(np.float64) * np.float64(r)).astype(np.float32)
    # fma(-q, 255, x): the exact x - 255 q fits an f64, then one rounding.
    e = (x.astype(np.float64) - q.astype(np.float64) * 255.0).astype(
        np.float32)
    # fma(e, r, q): e r is exact in f64; q + e r as an unevaluated pair,
    # rounded once to nearest f32 (ties to even).
    s = e.astype(np.float64) * np.float64(r)
    q64 = q.astype(np.float64)
    hi = q64 + s
    lo = (q64 - hi) + s
    got = hi.astype(np.float32)
    g64 = got.astype(np.float64)
    for side in (np.float32(np.inf), np.float32(-np.inf)):
        nb = np.nextafter(got, side)
        mid = (hi == (g64 + nb.astype(np.float64)) / 2) & (lo != 0)
        toward = (lo > 0) == (side > 0)
        got = np.where(mid & toward, nb, got)
    want = x / np.float32(255.0)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# The shared classification's volume: three edges, so that a stride or an
# axis taken for another shows.
SHAPE = (12, 20, 32)  # D, H, W


def padded_rows(tf: np.ndarray) -> np.ndarray:
    """The TF as the kernels stage it: a copy of the first and last rows
    around it, padded row j + 1 being row j."""
    return np.concatenate([tf[:1], tf, tf[-1:]])


def cell_axis(p: np.ndarray, n: int, stride: int):
    """``march_common.cuh:cell_axis``: the first tap's offset, the step to
    the second and the second tap's weight along one axis."""
    t = ((p + f32(1)) * f32(0.5 * n) - f32(0.5)).astype(np.float32)
    fi, ff = magic_floor(t)
    f = (t - ff).astype(np.float32)
    off = np.clip(fi, 0, n - 1) * stride
    step = np.where(fi.astype(np.uint32) < np.uint32(n - 1), stride, 0)
    return off, step, f


def classify_density(vol: np.ndarray, tf: np.ndarray, p: np.ndarray):
    """``march_common.cuh:classify<float, Units::kDensity, false, false>``
    in numpy: the cell at ``p (N, 3)``, its eight taps lerped along x,
    then y, then z, and the TF lerped from the padded rows -> premultiplied
    RGBA ``(N, 4)``, every product and sum rounded on its own."""
    depth, h, w = vol.shape
    flat = vol.reshape(-1)
    ox, sx, fx = cell_axis(p[:, 0], w, 1)
    oy, sy, fy = cell_axis(p[:, 1], h, w)
    oz, sz, fz = cell_axis(p[:, 2], depth, w * h)
    b00 = ox + oy + oz
    b01, b10 = b00 + sy, b00 + sz
    b11 = b10 + sy
    gx, gy, gz = (f32(1) - fx, f32(1) - fy, f32(1) - fz)

    def lerp_x(b):
        return flat[b] * gx + flat[b + sx] * fx

    s = ((lerp_x(b00) * gy + lerp_x(b01) * fy) * gz
         + (lerp_x(b10) * gy + lerp_x(b11) * fy) * fz).astype(np.float32)
    tc = (s * f32(TF_SIZE) - f32(0.5)).astype(np.float32)
    fi, ff = magic_floor(tc)
    f = (tc - ff).astype(np.float32)[:, None]
    j = np.clip(fi, -1, TF_SIZE - 1)
    rows = padded_rows(tf)
    return (rows[j + 1] * (f32(1) - f) + rows[j + 2] * f).astype(np.float32)


def lattice_rays(axis: int | None, rng) -> tuple[np.ndarray, ...]:
    """``(o, d, k)`` of samples on rung 5's lattice ``k = k0 + i*step``
    (``i`` counted in f32). Along ``axis``: orthographic rays whose
    positions across it lie on the half-voxel lattice of each edge
    (``-1 + m / n``, where every floor of the taps sits on an integer or a
    half-integer), their f32 neighbours and the faces at +-1, marching
    from the face at -1 or half a step inside it with a step of ``2 / n``,
    every sample on the lattice along the ray too, the last on the face at
    +1. ``axis`` None: random rays through the cube at random k."""
    if axis is None:
        o = f32(rng.uniform(-1.5, 1.5, (20_000, 3)))
        d = f32(rng.normal(size=(20_000, 3)))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        k = f32(rng.uniform(0, 1.5, 20_000))
        p = o + d * k[:, None]
        keep = (np.abs(p) <= 1.02).all(axis=1)
        return o[keep], d[keep], k[keep]
    across = []
    for ax in range(3):
        n = SHAPE[2 - ax]
        c = f32(-1.0 + np.arange(2 * n + 1) / n)
        c = np.concatenate([c, np.nextafter(c, f32(-2)), np.nextafter(c, f32(2))])
        across.append(c[(c >= -1) & (c <= 1)])
    a, b = [across[ax] for ax in range(3) if ax != axis]
    u, v = (x.reshape(-1) for x in np.meshgrid(a, b, indexing="ij"))
    n = SHAPE[2 - axis]
    step = f32(2.0 / n)
    out_o, out_k = [], []
    for k0 in (f32(1.0), f32(1.0 + 1.0 / n)):
        i = np.arange(max_steps(float(step)), dtype=np.float32)
        k = (k0 + i * step).astype(np.float32)
        k = k[k <= f32(3.0)]
        out_k.append(np.repeat(k[None], u.size, 0).reshape(-1))
        o = np.zeros((u.size, 3), np.float32)
        o[:, [ax for ax in range(3) if ax != axis]] = np.stack([u, v], 1)
        o[:, axis] = -2.0
        out_o.append(np.repeat(o, k.size, 0))
    o, k = np.concatenate(out_o), np.concatenate(out_k)
    d = np.zeros_like(o)
    d[:, axis] = 1.0
    return o, d, k


@pytest.mark.parametrize("axis", [0, 1, 2, None])
def test_shared_classification_of_a_density_is_the_plain_march(axis):
    """The shared per-sample code over a density in [0, 1] (round-down
    floors, the taps as a base and three steps, the padded TF rows)
    against ``march_fwd_plain``'s colour of each sample, bit for bit, on
    the adversarial grid pose along each axis and on random rays. Each
    sample goes to the plain march as a ray of one sample (``k0 = kfar =
    k``), whose image is the sample's colour: ``0 + c * (1 - 0)``. The
    ray step only sets how many lockstep steps the plain march takes past
    that sample, all of them masked; 4.0 makes it 3 where 0.1 made it
    37."""
    rng = np.random.default_rng(21)
    vol = f32(rng.uniform(0, 1, SHAPE))
    vol.reshape(-1)[rng.choice(vol.size, 400, replace=False)] = 0.0
    vol.reshape(-1)[rng.choice(vol.size, 400, replace=False)] = 1.0
    tf = f32(rng.uniform(0, 1, (TF_SIZE, 4)))
    o, d, k = lattice_rays(axis, rng)
    p = (o + d * k[:, None]).astype(np.float32)
    want = classify_density(vol, tf, p)
    t = torch.from_numpy
    n = o.shape[0]
    scal = torch.tensor([2.0, 0.0, 0.0, 0.0, 2.0, 0.0, 0.0, 0.0])
    got = march_fwd_plain(t(o), t(d), t(k), t(k), torch.ones(n, dtype=torch.bool),
                          t(vol), t(tf), scal, ray_step=4.0, shade=False,
                          no_ert=True, width=n).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_the_float_sample_count_is_exact():
    """Rung 5's kernels count a ray's samples in f32, ``i = i + 1`` from 0
    (``march_common.cuh:march_forward``, ``march_replay``), where the plain
    march takes ``float(i)``: equal for every count the wrappers allow,
    all of [0, 2^24), and the step that would need 2^24 samples is
    refused. The smallest default step of a volume of 4096 voxels an edge
    needs some 7,100."""
    limit = MAX_STEPS_LIMIT
    assert limit == 2 ** 24
    count = np.cumsum(np.ones(limit, np.float32), dtype=np.float32) - f32(1)
    assert np.array_equal(count, np.arange(limit, dtype=np.float64))
    step = 2.0 / 4096 - 2.0 / 4096 ** 2
    assert max_steps(step) < 7_200
    assert max_steps(2.0 * np.sqrt(3.0) / (limit - 4)) < limit
    with pytest.raises(ValueError, match="samples a ray"):
        max_steps(2.0 * np.sqrt(3.0) / (limit - 2))


@pytest.mark.parametrize("where", ["below", "rows", "above"])
def test_replay_tf_row_and_slope_from_the_padded_rows(where):
    """The replays read the TF through the forward's ``j = clamp(floor(tc),
    -1, 127)``: their scatter's row ``max(j, 0)``, the one-row lerp ``j
    in {-1, 127}``, and the slope from padded rows ``j + 2`` and ``j + 1``.
    Against the clamped lerp's ``lo``, ``hi`` and ``f`` over all 128 rows
    (every row's interval, its ends and their neighbours) and past both
    clamped ends."""
    rng = np.random.default_rng(7)
    if where == "rows":
        edges = f32(np.arange(TF_SIZE + 1) - 0.5)
        tc = np.concatenate([f32(rng.uniform(-0.5, TF_SIZE - 0.5, 100_000)),
                             edges, np.nextafter(edges, f32(-1e9)),
                             np.nextafter(edges, f32(1e9)), f32(np.arange(TF_SIZE))])
        s = ((tc + f32(0.5)) / f32(TF_SIZE)).astype(np.float32)
    else:
        s = f32(rng.uniform(-2, 0, 10_000) if where == "below"
                else rng.uniform(1, 3, 10_000))
    tc = (s * f32(TF_SIZE) - f32(0.5)).astype(np.float32)
    fl = np.floor(tc)
    i = np.clip(fl, -1, TF_SIZE).astype(np.int64)
    lo, hi = np.clip(i, 0, TF_SIZE - 1), np.clip(i + 1, 0, TF_SIZE - 1)
    f = (tc - fl).astype(np.float32)
    fi, ff = magic_floor(tc)
    j = np.clip(fi, -1, TF_SIZE - 1)
    assert np.array_equal((tc - ff).astype(np.float32).view(np.int32),
                          f.view(np.int32))
    assert np.array_equal(np.maximum(j, 0), lo)
    assert np.array_equal((j < 0) | (j == TF_SIZE - 1), lo == hi)
    tf = f32(rng.uniform(0, 1, (TF_SIZE, 4)))
    rows = padded_rows(tf)
    assert np.array_equal(rows[j + 2] - rows[j + 1], tf[hi] - tf[lo])
    if where != "rows":
        assert (lo == hi).all() and (lo == (0 if where == "below" else 127)).all()


# Voxel offsets (csrc/march_common.cuh: Unsigned, cell_axis, cell_at,
# cell_key): 32-bit for a volume under 2^31 voxels, 64-bit from there on,
# chosen by the wrapper from the shape alone.
@pytest.mark.parametrize("voxels,wide", [(OFFSET_LIMIT - 1, False),
                                         (OFFSET_LIMIT, True)])
def test_the_offset_width_is_a_function_of_the_shape(voxels, wide):
    """2^31 - 1 is prime: that many voxels make a line. 2^31 make the
    [2048, 1024, 1024] volume. Neither is allocated."""
    assert OFFSET_LIMIT == 2 ** 31
    assert wide_offsets((voxels, 1, 1)) is wide
    shape = (voxels // 2 ** 20, 1024, 1024) if wide else (voxels, 1, 1)
    assert np.prod(shape, dtype=np.int64) == voxels
    assert wide_offsets(shape) is wide
    if wide:
        # The 32-bit kernels refuse it; the any-size ones take it.
        with pytest.raises(ValueError, match="2\\^31"):
            check_volume_shape(shape, any_size=False)
        check_volume_shape(shape, any_size=True)
    else:
        check_volume_shape((2047, 1024, 1024), any_size=False)
    for bad in ((8, 2 ** 16, 2 ** 15), (2 ** 22, 2, 2)):
        with pytest.raises(ValueError, match="2\\^22|slice"):
            check_volume_shape(bad, any_size=True)


def _first_tap(iz, iy, ix, shape, dtype):
    """cell_at's base in ``dtype`` arithmetic: each axis's clamped index
    times its stride (a product at that width), summed, then read as
    the unsigned type of the same width, as the fetch adds it."""
    _, h, w = shape
    with np.errstate(over="ignore"):
        i = [np.asarray(v, dtype) for v in (iz, iy, ix)]
        off = (i[0] * dtype(w * h) + i[1] * dtype(w) + i[2])
    return off.view(np.uint32 if dtype is np.int32 else np.uint64)


def test_32_bit_offsets_wrap_and_64_bit_ones_do_not():
    """On the phase-17 volume of ``chip_smoke.py`` (uint8 [4160, 1024,
    1024]): past 2^31 the 32-bit product wraps negative, and past 2^32 the
    unsigned sum wraps too, onto a voxel 4096 slices nearer; the 64-bit
    offset is the voxel's. Below 2^32 the wrapped sum, read unsigned,
    still lands on the voxel, which is why the card's check places its
    blob past 2^32. The dVol scatter's 64-bit cell key (first tap
    and the three steps' flags) tells cells apart that share a first
    tap."""
    shape = (4160, 1024, 1024)
    iz = np.array([0, 2047, 2048, 4095, 4096, 4159])
    iy, ix = np.full(6, 1023), np.full(6, 5)
    exact = (iz.astype(np.int64) * 2 ** 20 + 1023 * 1024 + 5)
    narrow = _first_tap(iz, iy, ix, shape, np.int32)
    wide = _first_tap(iz, iy, ix, shape, np.int64)
    np.testing.assert_array_equal(wide, exact)
    with np.errstate(over="ignore"):
        z_off = iz.astype(np.int32) * np.int32(2 ** 20)
    np.testing.assert_array_equal(z_off != iz * 2 ** 20, iz >= 2048)
    np.testing.assert_array_equal(z_off < 0, (iz >= 2048) & (iz < 4096))
    np.testing.assert_array_equal(narrow, exact % 2 ** 32)
    np.testing.assert_array_equal(narrow != exact, iz >= 4096)
    # cell_key of a 64-bit cell: a clamped cell (steps 0) and the cell
    # beside it share a first tap but not a key.
    base = np.uint64(exact[-1])

    def key(sx, sy, sz):
        return (base << np.uint64(3)) | np.uint64(
            (sx != 0) << 2 | (sy != 0) << 1 | (sz != 0))
    keys = {int(key(sx, sy, sz)) for sx in (0, 1) for sy in (0, 1024)
            for sz in (0, 2 ** 20)}
    assert len(keys) == 8 and max(keys) < 2 ** 63 - 32
