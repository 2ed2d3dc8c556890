"""The port's round-1 differentiable routes, ``render_image_fused(blocked=
False | True)``, against the same routes of ``volrt``.

Scenes, views and targets are made with numpy from a seed and handed to
both packages; the port runs on the CPU, where the four kernels' wrappers
take their plain torch versions. The JAX kernels (``diff_tri``,
``diff_blocked``) run in Pallas interpret mode. No JAX test pins these two
routes' numbers, so this file is the first to.

Tolerances, with what was measured at 16^3 / 32^2:

- images 5e-5. Measured: 3.5e-6 on all but two of 1024 pixels, 1.9e-5 on
  those two. Both packages take the same samples (``k0``, ``kfar`` and the
  sample counts are equal); what differs is rounding. The TPU kernels sum a
  sample's eight taps as one weighted sum where the port lerps x, y, z in
  turn, and XLA's ``jit`` contracts ``o + d*k``: moving every sample's
  position by one ulp in the port moves a pixel of this scene by up to
  2.0e-5 (the same pixel), the density's slope times the TF's.
- gradients of a seeded target's mean-square loss 5e-6 absolute on both
  leaves (measured 1.7e-7 in density, largest entry 4.7e-3, and 6e-8 in
  the TF, largest entry 0.15).
- against the port's own autograd oracle, which marches ``k0 + i*step``
  where these routes accumulate ``k += step``: the image at the repo's
  lattice tolerance 2e-4 (``volrt``'s own routes differ by 7.9e-5 there),
  gradients at 2e-3 of the largest entry.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_core import one_torch_thread  # noqa: F401
from tests.test_torch_diff import (
    CPU, STEP, _close, _jax_loss_grads, _pair, _torch_loss_grads)
from volrt.core.tf import default_transfer_fn as j_default_tf
from volrt.diff import fused as jfused
from volrt.renderers.pallas import diff_v3 as jdiff_v3
from volrt_torch.bench import trace_step
from volrt_torch.core.types import View
from volrt_torch.diff import fused as tfused
from volrt_torch.diff import render as trender
from volrt_torch.renderers import diff_blocked, diff_tri, fwd_v3
from volrt_torch.renderers import diff_v3 as tdiff_v3
from volrt_torch.renderers.cuda import march, round1

ATOL_IMG = 5e-5
ATOL_GRAD = 5e-6
ATOL_LATTICE = 2e-4
RTOL_GRAD_LATTICE = 2e-3
WRAPPERS = (round1.diff_tri_fwd, round1.diff_tri_bwd,
            round1.diff_blocked_fwd, round1.diff_blocked_bwd)


def _match_volrt(jside, tside, **kw):
    """Image, loss and both gradients of one route in both packages."""
    want_img = np.asarray(jfused.render_image_fused(*jside[:2], **kw))
    want_loss, want_gd, want_gt = _jax_loss_grads(
        jfused.render_image_fused, *jside, **kw)
    img, loss, gd, gt = _torch_loss_grads(tfused.render_image_fused, *tside,
                                          **kw)
    assert img.shape == want_img.shape and np.isfinite(img).all()
    _close(img, want_img, ATOL_IMG, "image")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _close(gd, want_gd, ATOL_GRAD, "d_density")
    _close(gt, want_gt, ATOL_GRAD, "d_tf_base")
    return img, gd, gt


# (blocked, persp, thr, noise): every view of the synthetic scene, and the
# card's scatter adversary, a uniform-noise density, on both routes.
ROUTE_CASES = [(b, p, t, False) for b in (False, True) for p in (False, True)
               for t in (0.95, 2.0)] + [(False, False, 0.95, True),
                                        (True, False, 0.95, True)]


@pytest.mark.parametrize(
    "blocked, persp, thr, noise", ROUTE_CASES,
    ids=["-".join(["blocked" if b else "tri", "persp" if p else "ortho",
                   "ert" if t < 1 else "no_ert"] + ["noise"] * n)
         for b, p, t, n in ROUTE_CASES])
def test_round1_route_matches_volrt(blocked, persp, thr, noise):
    jside, tside = _pair(persp=persp, noise=noise)
    kw = dict(ray_threshold=thr, blocked=blocked)
    img, gd, gt = _match_volrt(jside, tside, **kw)
    assert img[..., 3].max() > 0.5
    assert np.linalg.norm(gd) > 1e-4 and np.linalg.norm(gt) > 1e-4
    # Against autograd through the port's plain torch march.
    o_img, _, o_gd, o_gt = _torch_loss_grads(
        trender.render_diff_image, *tside, ray_threshold=thr)
    _close(img, o_img, ATOL_LATTICE, "image vs oracle")
    _close(gd, o_gd, RTOL_GRAD_LATTICE * np.abs(o_gd).max(),
           "d_density vs oracle")
    _close(gt, o_gt, RTOL_GRAD_LATTICE * np.abs(o_gt).max(),
           "d_tf_base vs oracle")


def _off_axis(jside, tside):
    """Both views moved 1.3 to the right: most rays miss the cube."""
    jscene, jview, jtarget = jside
    right = np.asarray(jview.right_plane)
    origin = np.asarray(jview.origin) + 1.3 * right / np.linalg.norm(right)
    jview = dataclasses.replace(jview, origin=jnp.asarray(origin))
    tview = View.from_arrays(
        origin, np.asarray(jview.direction), right,
        np.asarray(jview.up_plane), np.asarray(jview.light_pos), jview.dims,
        jview.perspective, CPU)
    return (jscene, jview, jtarget), (tside[0], tview, tside[2])


@pytest.mark.parametrize("case", ["nonsquare-tri", "off-axis-blocked"])
def test_dead_rays_and_ragged_views(case):
    """A view whose size is no multiple of the kernels' 16x16 blocks (the
    TPU route pads it with dead rays), and a camera far off-axis: dead rays
    composite nothing and seed no cotangent."""
    blocked = case.endswith("blocked")
    jside, tside = _pair(dims=(40, 24))
    if case.startswith("off-axis"):
        jside, tside = _off_axis(jside, tside)
    img, gd, _ = _match_volrt(jside, tside, blocked=blocked)
    scene, view, target = tside
    args, _ = fwd_v3.ray_args(view, scene.density.detach(),
                              scene.premult_tf().detach(), STEP, 0.95, 0.0)
    dead = ~args[4].reshape(24, 40).numpy()
    assert dead.mean() > (0.5 if case.startswith("off-axis") else 0.1)
    assert not img[dead].any() and img[~dead][:, 3].max() > 0.5
    # The loss's cotangent on a dead ray is -2 target / N, not zero, and
    # must go nowhere: the gradients of the live rays alone are the same.
    masked = target * torch.from_numpy(~dead)[..., None]
    _, _, gd_live, _ = _torch_loss_grads(
        tfused.render_image_fused, scene, view, masked, blocked=blocked)
    np.testing.assert_array_equal(gd, gd_live)


def test_the_two_routes_share_a_plain_version():
    """On the CPU both routes run the same plain march, so they agree to
    the bit; no kernel is launched."""
    _, tside = _pair(dims=(40, 24), persp=True)
    a = _torch_loss_grads(tfused.render_image_fused, *tside, blocked=False)
    b = _torch_loss_grads(tfused.render_image_fused, *tside, blocked=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert round1.diff_tri_fwd_plain is round1.diff_blocked_fwd_plain
    assert round1.diff_tri_bwd_plain is round1.diff_blocked_bwd_plain
    assert [fn.launches for fn in WRAPPERS] == [0, 0, 0, 0]
    # The scene-level modules are the same routes.
    scene, view, _ = tside
    for mod_render, blocked in ((diff_tri.render_view_diff, False),
                                (diff_blocked.render_view_diff_blocked, True)):
        img = mod_render(scene.density, scene.premult_tf(), STEP, view)
        np.testing.assert_array_equal(img.detach().numpy(), a[0])
    # And they are not the v3 route: another lattice.
    v3 = tfused.render_image_fused(scene, view).detach().numpy()
    assert 0 < np.abs(v3 - a[0]).max() <= ATOL_LATTICE


def test_plain_backward_replays_the_plain_forward():
    """The plain backward against central differences of the plain
    forward, on one voxel and one TF entry: ``L = sum(cot * image)``,
    summed in f64. ERT is off, so the image is a polynomial in an alpha
    entry of the TF and piecewise so in a voxel (the step stays inside one
    TF row for most samples): 2 % of the entry."""
    _, (scene, view, _) = _pair(dims=(24, 24))
    cot = torch.from_numpy(np.random.default_rng(5).normal(
        size=(24 * 24, 4)).astype(np.float32))
    with torch.no_grad():
        args, kw = fwd_v3.ray_args(view, scene.density, scene.premult_tf(),
                                   STEP, 2.0, 0.0)
        del kw["shade"]
        out = round1.diff_tri_fwd(*args, **kw)
        d_vol, d_tf = round1.diff_tri_bwd(*args, out, cot, **kw)

        def loss(density, tf):
            a = list(args)
            a[5], a[6] = density, tf
            return (round1.diff_tri_fwd(*a, **kw).double()
                    * cot.double()).sum().item()

        voxel = np.unravel_index(d_vol.abs().argmax().item(), d_vol.shape)
        entry = (d_tf[:, 3].abs().argmax().item(), 3)
        for which, idx, grad, eps in (("voxel", voxel, d_vol, 2e-3),
                                      ("TF entry", entry, d_tf, 1e-2)):
            pair = []
            for sign in (1.0, -1.0):
                density, tf = args[5].clone(), args[6].clone()
                (density if which == "voxel" else tf)[idx] += sign * eps
                pair.append(loss(density, tf))
            fd = (pair[0] - pair[1]) / (2 * eps)
            got = grad[idx].item()
            assert abs(got) > 1e-2
            assert got == pytest.approx(fd, rel=2e-2), which


def _grads(scene, view, target, **kw):
    img = tfused.render_image_fused(scene, view, **kw)
    loss = torch.mean((img - target) ** 2)
    return torch.autograd.grad(loss, [scene.density, scene.tf_base],
                               allow_unused=True)


@pytest.mark.parametrize("blocked", [None, False, True],
                         ids=["v3", "tri", "blocked"])
def test_need_flags_detach_a_leaf(blocked):
    """``need_tf_grad`` / ``need_density_grad`` off: that leaf gets no
    gradient and the other's is unchanged, on every route, as
    ``tests/test_diff_v3.py:754-792`` holds ``volrt``'s flags."""
    _, (scene, view, target) = _pair()
    gd, gt = _grads(scene, view, target, blocked=blocked)
    gd_only, none_t = _grads(scene, view, target, blocked=blocked,
                             need_tf_grad=False)
    none_d, gt_only = _grads(scene, view, target, blocked=blocked,
                             need_density_grad=False)
    assert none_t is None and none_d is None
    assert gd.abs().max() > 0 and gt.abs().max() > 0
    torch.testing.assert_close(gd_only, gd, atol=0, rtol=0)
    torch.testing.assert_close(gt_only, gt, atol=0, rtol=0)
    # The wrappers skip the scatter and return zeros.
    if blocked is not None:
        fwd, bwd = ((round1.diff_blocked_fwd, round1.diff_blocked_bwd)
                    if blocked else
                    (round1.diff_tri_fwd, round1.diff_tri_bwd))
        with torch.no_grad():
            args, kw = fwd_v3.ray_args(view, scene.density,
                                       scene.premult_tf(), STEP, 0.95, 0.0)
            del kw["shade"]
            out = fwd(*args, **kw)
            g = (out - target.reshape(-1, 4)) * 1e-3
            full = bwd(*args, out, g, **kw)
            no_tf = bwd(*args, out, g, need_dtf=False, **kw)
            no_vol = bwd(*args, out, g, need_dvol=False, **kw)
        assert not no_tf[1].any() and not no_vol[0].any()
        torch.testing.assert_close(no_tf[0], full[0], atol=0, rtol=0)
        torch.testing.assert_close(no_vol[1], full[1], atol=0, rtol=0)


def test_need_flags_match_volrts_on_the_v3_route():
    jside, tside = _pair()
    for flag, keep in (("need_tf_grad", 1), ("need_density_grad", 2)):
        want = _jax_loss_grads(jfused.render_image_fused, *jside,
                               **{flag: False})
        got = _grads(*tside, **{flag: False})
        assert got[2 - keep] is None and not want[3 - keep].any()
        _close(got[keep - 1].numpy(), want[keep], ATOL_GRAD, flag)


def test_slope_on_a_tf_knot_follows_round_1():
    """Round 1 takes the density slope from the two clamped TF rows with no
    in-range flag; v3 also drops a sample whose TF coordinate is exactly 0.
    A constant density of 1/256 puts every sample on that knot (to the last
    bit, which decides sample by sample which side it falls on, so the
    packages are compared by size, not entry by entry): the round-1 routes
    send a density gradient there, the v3 route none, in both packages."""
    tf_base = np.random.default_rng(3).uniform(
        0.05, 0.6, (128, 4)).astype(np.float32)
    jside, tside = _pair(tf_base=tf_base)
    density = np.full((16, 16, 16), 1.0 / 256.0, np.float32)
    jscene = jside[0].replace(density=jnp.asarray(density))
    with torch.no_grad():
        tside[0].density.copy_(torch.from_numpy(density))
    _, j_r1, _ = _jax_loss_grads(jfused.render_image_fused, jscene,
                                 *jside[1:], blocked=True)
    _, j_v3, _ = _jax_loss_grads(jdiff_v3.render_image_v3, jscene,
                                 *jside[1:])
    _, _, t_r1, _ = _torch_loss_grads(tfused.render_image_fused, *tside,
                                      blocked=True)
    _, _, t_v3, _ = _torch_loss_grads(tdiff_v3.render_image_v3, *tside)
    assert not j_v3.any() and not t_v3.any()
    assert np.abs(j_r1).max() > 1e-3
    assert np.abs(t_r1).max() == pytest.approx(np.abs(j_r1).max(), rel=0.1)
    assert np.abs(t_r1).sum() == pytest.approx(np.abs(j_r1).sum(), rel=0.1)


def test_guards_and_unsupported_modes():
    _, (scene, view, target) = _pair(dims=(8, 8))
    wide = trender.scene_from_arrays(
        np.full((8, 8, 200), 0.5, np.float32),
        np.asarray(j_default_tf()), STEP, device=CPU)
    with pytest.raises(ValueError, match="W <= 128"):
        tfused.render_image_fused(wide, view, blocked=False)
    img = tfused.render_image_fused(wide, view, blocked=True)
    assert img.shape == (8, 8, 4) and img[..., 3].max() > 0.5
    # The kernel's wrapper itself takes any width.
    img2 = diff_tri.render_view_diff(wide.density, wide.premult_tf(), STEP,
                                     view)
    torch.testing.assert_close(img2, img, atol=0, rtol=0)
    for blocked in (False, True):
        for kw in (dict(shaded=True), dict(phong=True), dict(esl=True)):
            with pytest.raises(NotImplementedError,
                               match="requires the v3 path"):
                tfused.render_image_fused(scene, view, blocked=blocked, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tfused.render_image_fused(scene, view, blocked=blocked,
                                      fast=True)
    # l2_loss_fused keeps volrt's signature: no blocked, and volrt's other
    # parameters but the TPU kernels' plan, window and flush.
    want = [p for p in inspect.signature(jfused.l2_loss_fused).parameters
            if p not in ("plan", "window", "flush")]
    assert list(inspect.signature(tfused.l2_loss_fused).parameters) == want
    want = [p for p in inspect.signature(
        jfused.render_image_fused).parameters
        if p not in ("plan", "window", "flush")]
    assert list(inspect.signature(
        tfused.render_image_fused).parameters) == want
    loss = tfused.l2_loss_fused(scene, view, target)
    assert loss.item() == pytest.approx(torch.mean(
        (tdiff_v3.render_image_v3(scene, view) - target) ** 2).item())


def test_wrappers_on_cpu_take_the_plain_path_and_check_inputs():
    _, (scene, view, target) = _pair(dims=(16, 16))
    with torch.no_grad():
        args, kw = fwd_v3.ray_args(view, scene.density, scene.premult_tf(),
                                   STEP, 0.95, 0.0)
        del kw["shade"]
        out = round1.diff_blocked_fwd(*args, **kw)
        g = (out - target.reshape(-1, 4)) * 1e-3
        gd, gt = round1.diff_blocked_bwd(*args, out, g, **kw)
        torch.testing.assert_close(
            out, round1.round1_fwd_plain(*args, **kw), atol=0, rtol=0)
        p_gd, p_gt = round1.round1_bwd_plain(*args, out, g, **kw)
    torch.testing.assert_close(gd, p_gd, atol=0, rtol=0)
    torch.testing.assert_close(gt, p_gt, atol=0, rtol=0)
    # The forward is rung 3's march over a density (no division by 255).
    tri = march.march_tri_plain(
        *args[:5], args[5] * 255.0, *args[6:], nearest=False, shade=False,
        **kw)
    torch.testing.assert_close(out, tri, atol=ATOL_IMG, rtol=0)
    assert [fn.launches for fn in WRAPPERS] == [0, 0, 0, 0]
    for fwd, bwd in (WRAPPERS[:2], WRAPPERS[2:]):
        with pytest.raises(TypeError):
            fwd(*args[:5], args[5].double(), *args[6:], **kw)
        with pytest.raises(ValueError):
            fwd(*args[:5], args[5].transpose(0, 2), *args[6:], **kw)
        with pytest.raises(ValueError):
            fwd(*args, **{**kw, "width": 15})
        with pytest.raises(ValueError):
            bwd(*args, out[:-1], g, **kw)
        with pytest.raises(TypeError):
            bwd(*args, out, g.double(), **kw)
        with pytest.raises(TypeError):
            fwd(*args, shade=True, **kw)


@pytest.mark.parametrize("blocked", [0, 1])
def test_trace_step_builds_the_round1_step(blocked):
    step = trace_step.make_step("round1", 8, 16, torch.device(CPU),
                                blocked=bool(blocked))
    loss, (gd, gt) = step()
    assert np.isfinite(loss.item()) and loss.item() > 0
    assert gd.shape == (8, 8, 8) and gd.abs().max() > 0
    assert gt.shape == (128, 4) and gt.abs().max() > 0
