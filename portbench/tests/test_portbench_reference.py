"""The reference against the program's plain paths (its kernels' CPU
versions) at 32^3 / 64^2: the same inputs give the same frames, tables,
leaps, losses and gradients. The reference imports nothing of the
program; this test compares the two."""
from __future__ import annotations

import pytest
import torch

from portbench import reference as ref
from volrt_torch.core.types import View, Volume, make_raycaster
from volrt_torch.diff.render import DiffScene
from volrt_torch.renderers import get_renderer
from volrt_torch.renderers.batched import esl_start_raw
from volrt_torch.renderers.diff_v3 import l2_loss_grads_v3_onepass

N, SIZE = 32, (64, 64)
SEED = 2**32 + 7
POSES = [((0, 0, 0), False), ((45, 45, 0), True), ((-90, 0, 0), True)]


@pytest.fixture(scope="module")
def vol():
    return ref.synthetic_volume(N, SEED, "cpu")


def port_view(v):
    return View.from_arrays(v["origin"], v["direction"], v["right"],
                            v["up"], v["light"], v["dims"],
                            v["perspective"], "cpu")


def raycaster(vol, view, **kw):
    return make_raycaster(Volume(data=vol, dims=(N, N, N)), port_view(view),
                          ref.default_tf_base("cpu"),
                          ray_step=ref.default_ray_step((N,) * 3), **kw)


def test_esl_tables(vol):
    tf = ref.premultiply(ref.default_tf_base("cpu"))
    empty, block = ref.esl_empty(vol, tf)
    rc = raycaster(vol, ref.pose((0, 0, 0), False, 3.0, SIZE))
    assert block == rc.esl_block_dims
    assert torch.equal(empty, rc.esl_empty)
    assert 0 < int(empty[:N // 8, :N // 8, :N // 8].sum()) < (N // 8) ** 3
    assert torch.equal(ref.esl_distance(empty), rc.esl_dist)


@pytest.mark.parametrize("angles,persp", POSES)
def test_leap(vol, angles, persp):
    view = ref.pose(angles, persp, 3.0, SIZE)
    rc = raycaster(vol, view)
    r = ref.rays(view, "cpu")
    tf = ref.premultiply(ref.default_tf_base("cpu"))
    empty, block = ref.esl_empty(vol, tf)
    got = ref.leap_start(r, ref.esl_distance(empty), (N, N, N), block,
                         rc.ray_step)
    want = esl_start_raw(None, rc.volume.dims, rc.esl_block_dims,
                         rc.esl_block_size, rc.ray_step, r["o"], r["d"],
                         r["knear"], r["kfar"], r["hit"], rc.esl_dist)
    assert torch.equal(got, want)
    assert bool((got > r["knear"]).any())


@pytest.mark.parametrize("angles,persp", POSES)
def test_rung5_phong_esl_frame(vol, angles, persp):
    view = ref.pose(angles, persp, 2.0, SIZE)
    rc = raycaster(vol, view, ray_threshold=2.0, esl=True, light_kd=0.6,
                   interpolation="trilinear", shading="phong")
    want = get_renderer(5).render_float(rc)[0]
    tf = ref.premultiply(ref.default_tf_base("cpu"))
    got = ref.march_v3(ref.v3_rays(view, "cpu"), vol.float() / 255.0, tf,
                       ray_step=rc.ray_step, thr=2.0, kd=0.6, phong_on=True,
                       esl=ref.esl_empty(vol, tf)).reshape(want.shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("angles,persp", POSES)
def test_rung3_cli_frame(vol, angles, persp):
    view = ref.pose(angles, persp, 3.0, SIZE)
    rc = raycaster(vol, view, interpolation="trilinear")
    want = get_renderer(3).render(rc)
    tf = ref.premultiply(ref.default_tf_base("cpu"))
    r = ref.ladder_start(ref.rays(view, "cpu"), vol, tf, rc.ray_step, True)
    got = ref.write_color(ref.march_ladder(
        r, vol.float(), tf, ray_step=rc.ray_step, thr=0.95, kd=0.6))
    assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("phong", [False, True])
def test_fast_l2_step(vol, phong):
    view = ref.pose((45, 45, 0), True, 2.0, SIZE)
    step = ref.default_ray_step((N,) * 3)
    dens = vol.float() / 255.0
    base = ref.default_tf_base("cpu")
    target = torch.rand((SIZE[1], SIZE[0], 4),
                        generator=torch.Generator().manual_seed(3))
    loss, grads = l2_loss_grads_v3_onepass(
        DiffScene(dens, base, step), port_view(view), target, fast=True,
        phong=phong, light_kd=0.6)
    got = ref.l2_loss_grads(dens, base, ref.v3_rays(view, "cpu"),
                            target.reshape(-1, 4), ray_step=step, thr=0.95,
                            kd=0.6 if phong else 0.0, phong_on=phong,
                            rnd=ref.round_bf16, points=1 << 16)
    assert got[0] == pytest.approx(float(loss), rel=1e-6)
    for g, w in zip(got[1:], (grads["density"], grads["tf_base"])):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_adam_is_torch_adam():
    p = torch.rand(50, generator=torch.Generator().manual_seed(1))
    leaf = torch.nn.Parameter(p.clone())
    opt = torch.optim.Adam([leaf], lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    mine = ref.Adam([p], 1e-2)
    for k in range(3):
        g = torch.randn(50, generator=torch.Generator().manual_seed(10 + k))
        leaf.grad = g.clone()
        opt.step()
        with torch.no_grad():
            leaf.clamp_(0.0, 1.0)
        mine.step([g])
    assert torch.allclose(mine.params[0], leaf.detach(), atol=1e-7)


@pytest.mark.parametrize("phong", [False, True])
def test_the_scan_is_the_march(vol, phong):
    """The training step's differentiable march (a product scan) is the
    lockstep march's function, to f32 rounding."""
    view = ref.pose((0, -90, 0), False, 2.0, SIZE)
    step = ref.default_ray_step((N,) * 3)
    dens = ref.round_bf16(vol.float() / 255.0)
    tf = ref.premultiply(ref.default_tf_base("cpu"))
    kw = dict(ray_step=step, thr=0.95, kd=0.6, phong_on=phong,
              fast=ref.round_bf16)
    r = ref.v3_rays(view, "cpu")
    want = ref.march_v3(r, dens, tf, **kw)
    got = ref.march_scan(r, dens, tf, points=1 << 14, **kw)
    assert float((got - want).abs().max()) <= 1e-5
