"""The port's empty-space leaping (``volrt_torch.core.esl`` and the leap
loops of rungs 0-1) against ``volrt``'s, on volumes made from a numpy seed.

Grids are integers and booleans and must agree exactly. Leap distances and
starts are a few f32 operations on the same inputs: 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_core import one_torch_thread  # noqa: F401
from volrt.core import esl as jesl
from volrt.core import tf as jtf
from volrt.core.types import Volume as JVolume
from volrt.core.types import default_esl_block_dims as j_block_dims
from volrt.core.types import make_raycaster as j_make_raycaster
from volrt.core import rays as jrays
from volrt.renderers import batched as j_batched
from volrt_torch.core import esl as tesl
from volrt_torch.core import tf as ttf
from volrt_torch.core import types as ttypes
from volrt_torch.core import rays as trays
from volrt_torch.renderers import batched, golden
from volrt_torch.renderers.cuda.march import max_steps

CPU = "cpu"
# (D, H, W): a cube, a size that is no multiple of the block (8), a flat one.
SHAPES = [(32, 32, 32), (20, 13, 27), (9, 40, 33)]


def _volume(shape, seed=0):
    """Mostly empty: a few dense boxes in the low half of a field of low
    values, so that the grid has empty and non-empty blocks."""
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, 12, size=shape, dtype=np.uint8)
    for _ in range(3):
        lo = [rng.integers(0, max(1, n // 2 - 1)) for n in shape]
        hi = [min(n, l + rng.integers(2, 9)) for n, l in zip(shape, lo)]
        vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = rng.integers(
            60, 255, size=[h - l for h, l in zip(hi, lo)], dtype=np.uint8)
    return vol


def _tf(seed=0):
    """A premultiplied TF whose alpha is zero in two ranges."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (128, 4)).astype(np.float32)
    base[:20, 3] = 0.0
    base[90:100, 3] = 0.0
    return np.asarray(jtf.premultiply(jnp.asarray(base)))


@pytest.mark.parametrize("shape", SHAPES)
def test_grids_match_volrt(shape):
    vol, tf = _volume(shape), _tf()
    jvol = JVolume.from_numpy(vol)
    block = j_block_dims(jvol.dims)
    assert ttypes.default_esl_block_dims(jvol.dims) == block
    assert ttypes.default_esl_block_dims((300, 20, 20)) == j_block_dims(
        (300, 20, 20)) == 10
    want_mm = np.asarray(jesl.build_min_max_grid(jvol, block))
    got_mm = tesl.build_min_max_grid(torch.tensor(vol), block)
    assert got_mm.dtype == torch.uint8
    np.testing.assert_array_equal(got_mm.numpy(), want_mm)
    # Blocks outside the volume keep (255, 0) and read as empty.
    assert tuple(got_mm[-1, -1, -1].tolist()) == (255, 0)

    np.testing.assert_array_equal(
        ttf.first_opaque_index(torch.tensor(tf)).numpy(),
        np.asarray(jtf.first_opaque_index(jnp.asarray(tf))))
    want_e = np.asarray(jesl.derive_empty_grid(jnp.asarray(want_mm),
                                               jnp.asarray(tf)))
    got_e = tesl.derive_empty_grid(got_mm, torch.tensor(tf))
    assert got_e.dtype == torch.bool and got_e.shape == (32, 32, 32)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    d, h, w = (-(-n // block) for n in shape)
    inside = got_e[:d, :h, :w]
    assert inside.any() and not inside.all() and got_e[d:].all()

    words = tesl.pack_bitmask(got_e)
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(jesl.pack_bitmask(jnp.asarray(want_e))))
    assert torch.equal(tesl.unpack_bitmask(words), got_e)

    np.testing.assert_array_equal(
        tesl.empty_distance_grid(got_e).numpy(),
        np.asarray(jesl.empty_distance_grid(jnp.asarray(want_e))))


def test_a_fully_transparent_tf_empties_every_block():
    vol = _volume((16, 16, 16))
    tf = np.zeros((128, 4), np.float32)
    assert ttf.first_opaque_index(torch.tensor(tf)).tolist() == [128] * 128
    empty = tesl.derive_empty_grid(
        tesl.build_min_max_grid(torch.tensor(vol), 8), torch.tensor(tf))
    assert empty.all()
    assert (tesl.empty_distance_grid(empty) == 32).all()
    with pytest.raises(ValueError, match="ESL grid"):
        tesl.build_min_max_grid(torch.zeros((4, 4, 40), dtype=torch.uint8), 1)


@pytest.mark.parametrize("shape", SHAPES)
def test_sample_empty_and_leap_distance_match_volrt(shape):
    vol, tf = _volume(shape, seed=1), _tf(1)
    jrc = j_make_raycaster(JVolume.from_numpy(vol),
                           base_transfer_fn=jnp.asarray(_base(tf)))
    rng = np.random.default_rng(2)
    pos = rng.uniform(-1.05, 1.05, (4000, 3)).astype(np.float32)
    dirs = rng.normal(size=(4000, 3)).astype(np.float32)
    dirs[::7, 0] = 0.0          # the reference's zero-direction guard
    dirs[::11, 2] = 0.0
    dims, block = jrc.volume.dims, jrc.esl_block_dims
    empty = np.asarray(jrc.esl_empty)
    np.testing.assert_array_equal(
        tesl.sample_empty(torch.tensor(empty), torch.tensor(pos), dims,
                          block).numpy(),
        np.asarray(jesl.sample_empty(jrc.esl_empty, jnp.asarray(pos), dims,
                                     block)))
    want = np.asarray(jesl.leap_distance(
        jnp.asarray(pos), jnp.asarray(dirs), dims, block, jrc.esl_block_size,
        jrc.ray_step))
    got = tesl.leap_distance(torch.tensor(pos), torch.tensor(dirs), dims,
                             block, jrc.esl_block_size, jrc.ray_step)
    # A leap is a whole number of steps; a quotient on an integer's edge
    # may floor either way, one step apart, in a handful of the 4000.
    diff = np.abs(got.numpy() - want)
    assert (diff <= 1e-6).mean() > 0.995
    assert (diff <= jrc.ray_step * 1.0001).all()


def _base(premult):
    """A base TF whose premultiplied form has ``premult``'s alpha."""
    base = np.ones((128, 4), np.float32)
    base[:, 3] = premult[:, 3]
    return base


@pytest.mark.parametrize("persp", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_esl_start_matches_volrt(shape, persp):
    from tests.test_torch_ladder import _view

    vol, tf = _volume(shape, seed=3), _tf(3)
    jrc = j_make_raycaster(JVolume.from_numpy(vol), view=_view(24, persp),
                           base_transfer_fn=jnp.asarray(_base(tf)))
    v = jrc.view
    trc = ttypes.raycaster_from_arrays(
        vol, np.asarray(jrc.transfer_fn), np.asarray(v.origin),
        np.asarray(v.direction), np.asarray(v.right_plane),
        np.asarray(v.up_plane), np.asarray(v.light_pos), v.dims,
        v.perspective, jrc.ray_step, 0.95, 0.6, interpolation="nearest",
        esl=True, device=CPU)
    # Derived here, not carried: the same grid and block size.
    np.testing.assert_array_equal(trc.esl_empty.numpy(),
                                  np.asarray(jrc.esl_empty))
    assert trc.esl_block_dims == jrc.esl_block_dims
    assert trc.esl_block_size == jrc.esl_block_size

    o, d = (a.reshape(-1, 3) for a in jrays.get_rays(jrc.view))
    knear, kfar, hit = jrays.intersect_aabb(o, d)
    want = np.asarray(j_batched.esl_start(jrc, o, d, knear, kfar, hit))
    to, td, tknear, tkfar, thit = batched.ray_bundle(trc)
    np.testing.assert_array_equal(thit.numpy(), np.asarray(hit))
    got = batched.esl_start(trc, to, td, tknear, tkfar, thit)
    live = np.asarray(hit)
    assert live.any() and (want[live] > np.asarray(knear)[live]).any()
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=1e-6,
                               rtol=0)

    # Rung 0 leaps one block per pass: never further than the distance
    # field allows past the first non-empty block, and on the same lattice.
    g0 = golden.esl_start(trc, to, td, tknear, tkfar, thit).numpy()
    steps = (g0 - tknear.numpy())[live] / trc.ray_step
    assert np.abs(steps - np.round(steps)).max() < 1e-2
    assert (g0[live] >= tknear.numpy()[live]).all()
    # Both stop in a non-empty block or beyond the exit.
    for k in (got, torch.tensor(g0)):
        pt = to + td * k[:, None]
        inside = (k <= tkfar) & thit
        assert not tesl.sample_empty(trc.esl_empty, pt, trc.volume.dims,
                                     trc.esl_block_dims)[inside].any()


def _leap_emulated(o, d, knear, kfar, hit, dist, dims, block, block_size,
                   step):
    """``csrc/march_common.cuh:leap_start`` written out in numpy f32, one
    rounded operation for each of the kernel's, all rays at once: where
    each ray starts after the leading leap."""
    f = np.float32
    k = knear.copy()
    on = hit.copy()
    dnorm = np.sqrt(((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                     + d[:, 2] * d[:, 2]) + f(1e-20))
    bw = [f(b) for b in block_size]
    min_bw, fstep = f(min(block_size)), f(step)
    for _ in range(max_steps(step)):
        p = o + d * k[:, None]
        b = [np.clip(np.trunc((p[:, a] + f(1)) * f(0.5) * f(dims[a]))
                     .astype(np.int64), 0, dims[a] - 1) // block
             for a in range(3)]
        m = dist[b[2], b[1], b[0]]
        on &= (k <= kfar) & (m >= 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            faces = [np.where(d[:, a] == 0, f(100),
                              (f(-1) + bw[a] * (b[a] + (d[:, a] > 0))
                               .astype(f) - p[:, a]) / d[:, a])
                     for a in range(3)]
        dk = np.maximum(np.minimum(np.minimum(faces[0], faces[1]), faces[2]),
                        f(0))
        face = np.floor(dk / fstep) * fstep
        ball = np.floor((m - 1).astype(f) * min_bw / dnorm / fstep) * fstep
        k = np.where(on, (k + np.maximum(face, ball)) + fstep, k)
        if not on.any():
            break
    return k


@pytest.mark.parametrize("persp", [False, True])
def test_leap_kernel_loop_equals_the_plain_leap(persp):
    """The leap kernel's loop (``esl_leap.cu``), emulated in numpy f32,
    gives each ray's start to the bit of the plain leap
    (``batched.esl_start_raw``, which divides by tensors and sums the norm
    in a fixed order so that it rounds alike on either device), on the
    render state's distance grid; the CPU wrapper is the plain leap."""
    from tests.test_torch_ladder import _view
    from volrt_torch.renderers.cuda import leap

    vol, tf = _volume((20, 13, 27), seed=5), _tf(5)
    jrc = j_make_raycaster(JVolume.from_numpy(vol), view=_view(24, persp),
                           base_transfer_fn=jnp.asarray(_base(tf)))
    v = jrc.view
    trc = ttypes.raycaster_from_arrays(
        vol, np.asarray(jrc.transfer_fn), np.asarray(v.origin),
        np.asarray(v.direction), np.asarray(v.right_plane),
        np.asarray(v.up_plane), np.asarray(v.light_pos), v.dims,
        v.perspective, jrc.ray_step, 0.95, 0.6, esl=True, device=CPU)
    assert trc.esl_dist.dtype == torch.int32
    np.testing.assert_array_equal(
        trc.esl_dist.numpy(), tesl.empty_distance_grid(trc.esl_empty).numpy())
    rays = [t.contiguous() for t in batched.ray_bundle(trc)]
    grid = (trc.esl_dist, trc.volume.dims, trc.esl_block_dims,
            trc.esl_block_size, trc.ray_step)
    want = batched.esl_start(trc, *rays)
    got = leap.esl_start(*rays, *grid)
    assert torch.equal(got, want)
    emulated = _leap_emulated(*(t.numpy() for t in rays),
                              trc.esl_dist.numpy(), *grid[1:])
    np.testing.assert_array_equal(emulated.view(np.int32),
                                  want.numpy().view(np.int32))
    assert (want > rays[2])[rays[4]].any()
    with pytest.raises(TypeError):
        leap.esl_start(*rays, trc.esl_dist.to(torch.int64), *grid[1:])


def _skip_emulated(words, block, shape, pos):
    """``csrc/march_common.cuh:esl_empty_cell`` in numpy: each axis's
    floor of t = (p + 1) * (n / 2) - 0.5 in f32, its two clamped taps'
    blocks as the high word of tap * ceil(2^32 / block), and the four
    words' bits of the two x blocks."""
    f = np.float32
    d, h, w = shape
    magic = np.uint64(-(-(1 << 32) // block))
    blocks = []
    for a, n in enumerate((w, h, d)):
        t = (pos[:, a] + f(1)) * f(0.5 * n) - f(0.5)
        i = np.floor(t).astype(np.int64)
        blocks.append([(np.clip(j, 0, n - 1).astype(np.uint64) * magic)
                       >> np.uint64(32) for j in (i, i + 1)])
    (x0, x1), (y0, y1), (z0, z1) = blocks
    w32 = words.astype(np.int64) & 0xFFFFFFFF
    bits = (np.int64(1) << x0.astype(np.int64)) | (
        np.int64(1) << x1.astype(np.int64))
    cell = np.full(pos.shape[0], 0xFFFFFFFF, np.int64)
    for z in (z0, z1):
        for y in (y0, y1):
            cell &= w32[(z * np.uint64(32) + y).astype(np.int64)]
    return (cell & bits) == bits


@pytest.mark.parametrize("shape", [(32, 32, 32), (20, 13, 27),
                                   (40, 30, 300)])
def test_v3_esl_predicate_matches_its_kernel_form(shape):
    """The v3 kernels' ESL test (``march.EslSkip``, a sample skipped when
    every block of its clamp-addressed trilinear cell is empty) against
    the kernel's form in numpy: blocks by a magic number's high word, a
    block edge of 8 and of 10 (a volume 300 wide), and positions on the
    voxel lattice and off it, inside the cube and beyond its faces."""
    from volrt_torch.renderers.cuda.march import EslSkip

    d, h, w = shape
    block = ttypes.default_esl_block_dims((w, h, d))
    assert block == (10 if w == 300 else 8)
    rng = np.random.default_rng(6)
    empty = torch.from_numpy(rng.uniform(size=(32, 32, 32)) < 0.8)
    words = tesl.pack_words(empty)
    assert words.dtype == torch.int32 and (words < 0).any()
    assert torch.equal(tesl.unpack_bitmask(words), empty)
    pos = rng.uniform(-1.05, 1.05, (6000, 3)).astype(np.float32)
    # Positions whose voxel coordinate t is an integer or a half.
    n = np.array([w, h, d], np.float32)
    lattice = rng.integers(-1, 2 * n.max() + 2, (2000, 3)) / 2.0
    pos[:2000] = ((lattice + 0.5) / (0.5 * n) - 1.0).astype(np.float32)
    got = EslSkip((words, block), shape)(torch.from_numpy(pos))
    want = _skip_emulated(words.numpy(), block, shape, pos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.1 < want.mean() < 0.9


def test_the_lerp_bucket_gap():
    """The grid calls a block empty by its TF buckets, ``first_opaque[min
    // 2] > max // 2`` (``volrt/core/esl.py``, the port's copy), but rungs
    3-5 lerp the TF at ``v * 128 - 0.5``: a raw value of 25 lies in bucket
    12 (alpha 0) and lerps 4.9 % of the way into entry 13. So a volume of
    25s under a TF that opens at 13 is empty to both packages' grids,
    while its ESL-off samples carry opacity and its ESL samples none.
    (``chip_smoke.py`` phase 16 counts such blocks on the benchmark scene:
    345 of its 16,040 empty blocks reach 25 or more.) Not fixed: the grid
    is ``volrt``'s."""
    from volrt_torch.core.view import Camera
    from volrt_torch.renderers import fwd_v3

    vol = np.full((16, 16, 16), 25, np.uint8)
    base = np.ones((128, 4), np.float32)
    base[:13, 3] = 0.0
    base[13:, 3] = 0.5
    premult = np.asarray(jtf.premultiply(jnp.asarray(base)))
    want = np.asarray(jesl.derive_empty_grid(
        jesl.build_min_max_grid(JVolume.from_numpy(vol), 8),
        jnp.asarray(premult)))
    rc = ttypes.make_raycaster(ttypes.Volume.from_numpy(vol, CPU),
                               Camera(dims=(16, 16)).view(CPU),
                               base_transfer_fn=base, light_kd=0.0,
                               interpolation="trilinear", esl=True)
    np.testing.assert_array_equal(rc.esl_empty.numpy(), want)
    assert rc.esl_empty.all()
    on, _ = fwd_v3.render_float(rc)
    off, _ = fwd_v3.render_float(rc.replace(esl=False))
    assert on.abs().max() == 0.0
    assert off[..., 3].max() > 0.1


def test_replacing_the_grid_rederives_the_kernels_tables():
    """``rc.replace(esl_empty=g)`` renders on rungs 3 (the leap) and 5 (the
    kernel's skipping) as a state built with ``g`` does, and rung 3 as
    ``volrt``'s same ``replace`` does (Pallas in interpret mode, 1e-5: the
    ladder's trilinear class); a ``replace`` of the view keeps the tables,
    and the tables cannot be replaced alone. 16^3 / 16^2."""
    from tests.test_torch_ladder import _image, _rcs
    from volrt.renderers import get_renderer as j_get_renderer
    from volrt_torch.renderers import get_renderer

    jrc, trc = _rcs("trilinear", 0.0, 0.95, True, False, wh=16)
    grid = trc.esl_empty.clone()
    grid[:, :, 1:] = True  # the blocks of x >= 8 empty too
    assert not torch.equal(grid, trc.esl_empty)
    swapped = trc.replace(esl_empty=grid)
    fresh = dataclasses.replace(trc, esl_empty=grid, esl_dist=None,
                                esl_words=None)
    for t in ("esl_dist", "esl_words"):
        want = tesl.esl_tables(grid)[t == "esl_words"]
        assert torch.equal(getattr(swapped, t), want), t
        assert torch.equal(getattr(fresh, t), want), t
        assert not torch.equal(getattr(trc, t), want), t
    for rung in (3, 5):
        render = get_renderer(rung).render_float
        got = _image(render(swapped))
        assert torch.equal(got, _image(render(fresh))), rung
        assert not torch.equal(got, _image(render(trc))), rung
    want = np.asarray(_image(j_get_renderer(3).render_float(
        jrc.replace(esl_empty=jnp.asarray(grid.numpy())))))
    np.testing.assert_allclose(
        _image(get_renderer(3).render_float(swapped)).numpy(), want,
        atol=1e-5, rtol=0)
    moved = swapped.replace(ray_threshold=0.9)
    assert moved.esl_dist is swapped.esl_dist
    assert moved.esl_words is swapped.esl_words
    with pytest.raises(ValueError, match="esl_empty"):
        trc.replace(esl_dist=swapped.esl_dist)
