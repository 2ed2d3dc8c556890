"""The bit-level identities that ``volrt_torch/csrc/march_ladder.cu``'s
per-sample code rests on, checked in numpy over the inputs the kernel can
give them.

Each replaces a rounded operation of the plain march (``floorf`` and a
clamped float-to-int conversion, truncation, the TF's clamped rows, an
IEEE division by 255) with another sequence that must give the same
bits, so that the kernel's unshaded images stay equal to the plain
versions' to the bit. One more, a byte widened through the exponent, is
the alternative to ``I2F`` that the kernel was measured against and does
not take. numpy's float32 arithmetic rounds to nearest as the
card's ``__fmul_rn`` / ``__fadd_rn`` do; the card's round-down add
(``__fadd_rd``) and its fused multiply-adds are emulated exactly here.
The division is also checked on the card over every f32 in [0, 256)
(``chip_smoke.py`` phase 9).
"""
from __future__ import annotations

import numpy as np
import pytest

# csrc/march_ladder.cu: the round-down bias 1.5 * 2^23 and its bits.
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
