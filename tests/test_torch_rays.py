"""The ray setup of the marches (``renderers/cuda/rays.py``,
``csrc/ray_setup.cu``) against its plain version, ``core/rays.py``'s
``get_rays`` and ``intersect_aabb``.

On the CPU: the kernel's per-ray arithmetic, emulated in numpy f32 in its
order, gives the plain version's rays, ``knear``, ``kfar`` and ``hit`` to
the bit (``hit`` being the old chain's ``alive`` too), and
``fwd_v3.ray_args`` takes the plain version. The tests marked ``card``
hold the kernel to the plain version on the card, to the bit; they skip
without a card. This file imports no JAX, so on the card:

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_rays.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from volrt_torch.bench.harness import bench_views, synthetic_volume
from volrt_torch.core import rays as rays_mod
from volrt_torch.core.types import View, Volume, make_raycaster
from volrt_torch.core.view import Camera
from volrt_torch.renderers import fwd_v3, trilinear
from volrt_torch.renderers.cuda import leap, rays

CPU = torch.device("cpu")


def _ray_setup_emulated(view: View, ties: str = "card") -> dict:
    """``csrc/ray_setup.cu:make_ray`` in numpy f32, each operation rounded
    on its own in the kernel's order.

    ``ties`` says which of two equal elements torch's reductions over the
    axes keep, which shows only in the sign of a zero ``knear`` or
    ``kfar``: ``"card"``, the kernel's, as torch on the card (the first
    axis against the third, then the second; the right one of two equal;
    ``clamp`` as ``fmaxf``, so -0 gives +0), or ``"cpu"``, torch's on the
    CPU (the first of equal elements; ``clamp`` keeps -0)."""
    f = np.float32
    org, dirn, right, up = (getattr(view, k).numpy() for k in (
        "origin", "direction", "right_plane", "up_plane"))
    w, h = view.dims
    idx = np.arange(w * h)
    px = (idx % w - w // 2).astype(f)
    py = (idx // w - h // 2).astype(f)
    o, d, lo_k, hi_k = [], [], [], []
    for c in range(3):
        plane = right[c] * px + up[c] * py
        if view.perspective:
            oc, dc = np.full_like(plane, org[c]), dirn[c] + plane
        else:
            oc, dc = org[c] + plane, np.full_like(plane, dirn[c])
        dd = np.where(dc == f(0), f(1e-5), dc)
        k1 = (f(rays.LO) - oc) / dd
        k2 = (f(rays.HI) - oc) / dd
        # k1 and k2 differ by 2 / dd: never a pair of zeros.
        lo_k.append(np.where(k1 < k2, k1, k2))
        hi_k.append(np.where(k1 > k2, k1, k2))
        o.append(oc)
        d.append(dc)
    if ties == "card":
        m = np.where(lo_k[0] > lo_k[2], lo_k[0], lo_k[2])
        m = np.where(m > lo_k[1], m, lo_k[1])
        knear = np.where(m > f(0), m, f(0))
        kfar = np.where(hi_k[0] < hi_k[2], hi_k[0], hi_k[2])
        kfar = np.where(kfar < hi_k[1], kfar, hi_k[1])
    else:
        m = np.where(lo_k[1] > lo_k[0], lo_k[1], lo_k[0])
        m = np.where(lo_k[2] > m, lo_k[2], m)
        knear = np.where(m < f(0), f(0), m)
        kfar = np.where(hi_k[1] < hi_k[0], hi_k[1], hi_k[0])
        kfar = np.where(hi_k[2] < kfar, hi_k[2], kfar)
    hit = (knear < kfar) & (kfar > f(0))
    return {"o": np.stack(o, -1), "d": np.stack(d, -1), "knear": knear,
            "kfar": kfar, "hit": hit}


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else x
    return x.view(np.int32) if x.dtype == np.float32 else x


# Odd and even widths and heights; distance 3 is the CLI's camera (an
# orthographic plane 3 wide: the corners miss the cube), 2 the benchmark's
# zoomed one.
@pytest.mark.parametrize("dims", [(16, 12), (17, 11), (9, 14)])
@pytest.mark.parametrize("distance", [3.0, 2.0])
def test_ray_setup_emulated_equals_the_torch_ops(dims, distance):
    """The kernel's arithmetic, emulated, gives ``get_rays`` +
    ``intersect_aabb`` to the bit on the benchmark's 8 poses, whose
    axis-aligned angles give direction components of exactly 0 (the 1e-5
    branch), its ``hit`` the chain's ``alive`` too; and the CPU wrapper is
    that chain."""
    zeros = misses = 0
    for view in bench_views(dims, distance, CPU):
        origins, directions = rays_mod.get_rays(view)
        o = origins.reshape(-1, 3).contiguous()
        d = directions.reshape(-1, 3).contiguous()
        knear, kfar, hit = rays_mod.intersect_aabb(o, d)
        want = {"o": o, "d": d, "knear": knear, "kfar": kfar, "hit": hit}
        got = _ray_setup_emulated(view, ties="cpu")
        assert torch.equal(hit & (knear <= kfar), hit)
        for k, v in want.items():
            np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
        # The kernel's ties differ from the CPU's in the sign of a zero
        # alone, on rays that start or end on an edge of the cube.
        card = _ray_setup_emulated(view, ties="card")
        for k, v in got.items():
            np.testing.assert_array_equal(card[k], v, err_msg=k)
            assert (card[k][_bits(card[k]) != _bits(v)] == 0).all(), k
        wrapped = rays.ray_setup(view, 0.95, 0.6)
        for k, v in zip(want, wrapped):
            assert torch.equal(v, want[k]), k
        zeros += int((d == 0).any())
        misses += int((~hit).sum())
    assert zeros and misses


def _old_ray_args_chain(view, ray_threshold, light_kd, loss_scale,
                        esl_start):
    """What ``fwd_v3.ray_args`` computed as torch ops before the kernel."""
    origins, directions = rays_mod.get_rays(view)
    o = origins.reshape(-1, 3).contiguous()
    d = directions.reshape(-1, 3).contiguous()
    knear, kfar, hit = rays_mod.intersect_aabb(o, d)
    if esl_start is not None:
        knear = esl_start(o, d, knear, kfar, hit)
    alive = hit & (knear <= kfar)
    f32 = dict(dtype=torch.float32, device=o.device)
    scal = torch.cat([torch.full((1,), ray_threshold, **f32),
                      torch.full((1,), light_kd, **f32),
                      view.light_pos.to(torch.float32),
                      torch.zeros(1, **f32),
                      torch.full((1,), loss_scale, **f32),
                      torch.zeros(1, **f32)])
    return o, d, knear, kfar, alive, scal


@pytest.mark.parametrize("leap_on", [False, True])
def test_ray_args_on_the_cpu_is_the_torch_chain(leap_on):
    """On the CPU, ``ray_args`` returns what the torch chain returned,
    ``scal`` included, with the leap's start in place of ``knear``."""
    rc = make_raycaster(Volume.from_numpy(synthetic_volume(32), CPU),
                        Camera(dims=(13, 10)).view(CPU),
                        interpolation="trilinear")
    esl_start = None
    if leap_on:
        def esl_start(o, d, knear, kfar, hit):
            return leap.esl_start(o, d, knear, kfar, hit, rc.esl_dist,
                                  rc.volume.dims, rc.esl_block_dims,
                                  rc.esl_block_size, rc.ray_step)
    density = rc.volume.data.to(torch.float32)
    for thr, kd, scale in ((0.95, 0.6, 0.0), (2.0, 0.0, 1.5e-7)):
        args, _ = fwd_v3.ray_args(rc.view, density, rc.transfer_fn,
                                  rc.ray_step, thr, kd, loss_scale=scale,
                                  esl_start=esl_start)
        want = _old_ray_args_chain(rc.view, thr, kd, scale, esl_start)
        got = args[:5] + args[7:]
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and torch.equal(g, w), k
        assert args[7][6].item() == np.float32(scale)
    if leap_on:
        assert (args[2] > rays.ray_setup(rc.view, 0.95, 0.6)[2]).any()


def test_ray_setup_checks_the_view():
    view = Camera(dims=(4, 3)).view(CPU)
    before = rays.ray_setup.launches
    with pytest.raises(TypeError):
        rays.ray_setup(dataclasses.replace(
            view, origin=view.origin.double()), 0.95, 0.6)
    with pytest.raises(ValueError):
        rays.ray_setup(dataclasses.replace(
            view, up_plane=view.up_plane[:2]), 0.95, 0.6)
    o, d, knear, kfar, hit, scal = rays.ray_setup(
        dataclasses.replace(view, dims=(0, 3)), 0.5, 0.25, 2.0)
    assert o.shape == (0, 3) and hit.shape == (0,) and hit.dtype == (
        torch.bool)
    assert scal.tolist() == [0.5, 0.25, *view.light_pos.tolist(), 0.0, 2.0,
                             0.0]
    assert rays.ray_setup.launches == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _assert_bits_equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        bad = int((g != w).sum())
        assert bad == 0, (what, k, bad)


@pytest.mark.card
@pytest.mark.parametrize("dims", [(3840, 2160), (1024, 1024), (799, 715)])
def test_ray_setup_kernel_equals_the_torch_ops_on_the_card(card, dims):
    """The kernel's six outputs equal the plain version's on the card to
    the bit: the benchmark's 8 poses at the CLI's distance and at the
    zoomed one, and an orthographic camera on the cube's face (distance 1:
    rays that start on it)."""
    face = Camera(dims=dims)
    face.set_camera_position((0.0, 0.0, 0.0), 1.0)
    views = bench_views(dims, 3.0, card) + bench_views(dims, 2.0, card) + [
        face.view(card)]
    before = rays.ray_setup.launches
    for i, view in enumerate(views):
        got = rays.ray_setup(view, 0.95, 0.6, 1.25e-7)
        want = rays.ray_setup_plain(view, 0.95, 0.6, 1.25e-7)
        _assert_bits_equal(got, want, (dims, i))
    assert rays.ray_setup.launches == before + len(views)


@pytest.mark.card
def test_ray_setup_kernel_on_a_0_ray_view(card):
    view = dataclasses.replace(Camera(dims=(8, 8)).view(card), dims=(0, 5))
    got = rays.ray_setup(view, 2.0, 0.0, 0.5)
    _assert_bits_equal(got, rays.ray_setup_plain(view, 2.0, 0.0, 0.5),
                       "0 rays")
    assert got[0].shape == (0, 3)


@pytest.mark.card
def test_ray_args_launches_the_ray_kernel_once(card):
    """A ``ray_args`` call launches the ray kernel once, on rung 5's path
    and on the leap's (rung 3); its rays and ``alive`` are the plain
    chain's, ``hit & (knear <= kfar)``, ``hit & (k0 <= kfar)`` on the
    leap's path."""
    rc = make_raycaster(Volume.from_numpy(synthetic_volume(64), card),
                        Camera(dims=(512, 384)).view(card),
                        interpolation="trilinear")
    density = rc.volume.data.to(torch.float32)
    before = rays.ray_setup.launches
    args, _ = fwd_v3.ray_args(rc.view, density, rc.transfer_fn, rc.ray_step,
                              0.95, 0.6)
    assert rays.ray_setup.launches == before + 1
    o, d, knear, kfar, hit, _ = rays.ray_setup_plain(rc.view, 0.95, 0.6)
    _assert_bits_equal(args[:5], (o, d, knear, kfar, hit & (knear <= kfar)),
                       "rung 5")
    args, _ = trilinear.ladder_args(rc, density)
    assert rays.ray_setup.launches == before + 2
    k0 = leap.esl_start(o, d, knear, kfar, hit, rc.esl_dist, rc.volume.dims,
                        rc.esl_block_dims, rc.esl_block_size, rc.ray_step)
    _assert_bits_equal(args[:5], (o, d, k0, kfar, hit & (k0 <= kfar)),
                       "leap")
    assert (k0 > knear).any()
