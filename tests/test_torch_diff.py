"""The port's differentiable render against ``volrt``: the autograd oracle,
the analytic backward and the one-launch L2 step.

Scenes, views and targets are made with numpy from a seed and handed to
both packages (``scene_from_arrays``, ``View.from_arrays``); the port runs
on the CPU, where the kernels' wrappers take their plain torch versions.
The JAX kernels run in Pallas interpret mode, as ``tests/test_diff_v3.py``
runs them. Tolerances are that file's: images 2e-4, gradients of the
mean-square loss 5e-6 on both leaves (``test_diff_v3.py:62-82``), the
one-pass loss rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_core import one_torch_thread  # noqa: F401
from tests.conftest import synthetic_volume
from volrt.core.tf import default_transfer_fn as j_default_tf
from volrt.core.view import Camera as JCamera
from volrt.diff import render as jrender
from volrt.renderers.pallas import diff_v3 as jdiff_v3
from volrt_torch.core.types import View
from volrt_torch.diff import fused as tfused
from volrt_torch.diff import render as trender
from volrt_torch.renderers import diff_v3 as tdiff_v3
from volrt_torch.renderers import fwd_v3
from volrt_torch.renderers.cuda import march

CPU = "cpu"
ATOL_IMG = 2e-4
ATOL_GRAD = 5e-6
STEP = 0.12


def _pair(dims=(32, 32), persp=False, angles=(30.0, 20.0, 0.0), n=16,
          tf_base=None, seed=0, noise=False):
    """One scene, view and seeded target for both packages:
    ``(jscene, jview, jtarget), (tscene, tview, ttarget)``. ``noise`` puts
    a seeded uniform-noise density in place of the synthetic volume."""
    cam = JCamera(dims=dims, perspective=persp)
    cam.toggle_perspective(update_mode=True)
    cam.set_camera_position(angles)
    jview = cam.view()
    if noise:
        density = np.random.default_rng(seed + 1).uniform(
            0, 1, (n, n, n)).astype(np.float32)
    else:
        density = synthetic_volume(n).astype(np.float32) / 255.0
    tf_base = (np.asarray(j_default_tf()) if tf_base is None
               else tf_base).astype(np.float32)
    target = np.random.default_rng(seed).uniform(
        0, 1, (dims[1], dims[0], 4)).astype(np.float32)
    jscene = jrender.DiffScene(density=jnp.asarray(density),
                               tf_base=jnp.asarray(tf_base), ray_step=STEP)
    tscene = trender.scene_from_arrays(density, tf_base, STEP, device=CPU)
    tview = View.from_arrays(
        np.asarray(jview.origin), np.asarray(jview.direction),
        np.asarray(jview.right_plane), np.asarray(jview.up_plane),
        np.asarray(jview.light_pos), jview.dims, jview.perspective, CPU)
    return ((jscene, jview, jnp.asarray(target)),
            (tscene, tview, torch.from_numpy(target)))


def _jax_image_loss_grads(render, jscene, jview, jtarget, **kw):
    """``(image, loss, d_density, d_tf_base)`` of the mean-square loss, from
    one forward and backward."""
    def loss(s):
        img = render(s, jview, **kw)
        return jnp.mean((img - jtarget) ** 2), img

    (val, img), g = jax.value_and_grad(loss, has_aux=True)(jscene)
    return (np.asarray(img), float(val), np.asarray(g.density),
            np.asarray(g.tf_base))


def _jax_loss_grads(render, jscene, jview, jtarget, **kw):
    return _jax_image_loss_grads(render, jscene, jview, jtarget, **kw)[1:]


def _torch_loss_grads(render, tscene, tview, ttarget, **kw):
    img = render(tscene, tview, **kw)
    loss = torch.mean((img - ttarget) ** 2)
    gd, gt = torch.autograd.grad(loss, [tscene.density, tscene.tf_base])
    return img.detach().numpy(), loss.item(), gd.numpy(), gt.numpy()


def _close(got, want, atol, what):
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


ORACLE_CASES = {
    "unshaded-ert": dict(kd=0.0, thr=0.95),
    "unshaded-no_ert": dict(kd=0.0, thr=2.0),
    "diffuse-ert": dict(kd=0.6, thr=0.95),
    "diffuse-no_ert": dict(kd=0.6, thr=2.0),
    "diffuse-ert-persp": dict(kd=0.6, thr=0.95, persp=True),
    "unshaded-ert-nonsquare": dict(kd=0.0, thr=0.95, dims=(40, 24)),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_render_diff_image_matches_jax(case):
    """(a) The autograd oracle against ``volrt``'s XLA autodiff march:
    image, loss and both gradients."""
    c = ORACLE_CASES[case]
    jside, tside = _pair(dims=c.get("dims", (32, 32)),
                         persp=c.get("persp", False))
    kw = dict(ray_threshold=c["thr"], light_kd=c["kd"], shaded=c["kd"] > 0)
    want_img, want_loss, want_gd, want_gt = _jax_image_loss_grads(
        jrender.render_diff_image, *jside, **kw)
    img, loss, gd, gt = _torch_loss_grads(trender.render_diff_image, *tside,
                                          **kw)
    assert img.shape == want_img.shape and img[..., 3].max() > 0.5
    _close(img, want_img, ATOL_IMG, "image")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _close(gd, want_gd, ATOL_GRAD, "d_density")
    _close(gt, want_gt, ATOL_GRAD, "d_tf_base")
    assert np.linalg.norm(gd) > 1e-4 and np.linalg.norm(gt) > 1e-4


@pytest.mark.parametrize("persp", [False, True])
@pytest.mark.parametrize("thr", [0.95, 2.0])
@pytest.mark.parametrize("kd", [0.0, 0.6])
def test_march_function_matches_the_ports_oracle(kd, thr, persp):
    """(b) The analytic backward (``march_bwd_plain`` through
    ``MarchFunction``) against autograd through the plain torch march. The
    images are the same ops; the gradients differ by the suffix sums'
    rounding, 1e-4 of the largest entry at most."""
    _, tside = _pair(dims=(40, 24), persp=persp)
    kw = dict(ray_threshold=thr, light_kd=kd, shaded=kd > 0)
    img, loss, gd, gt = _torch_loss_grads(tdiff_v3.render_image_v3, *tside,
                                          **kw)
    w_img, w_loss, w_gd, w_gt = _torch_loss_grads(
        trender.render_diff_image, *tside, **kw)
    _close(img, w_img, 1e-6, "image")
    assert loss == pytest.approx(w_loss, rel=1e-6)
    _close(gd, w_gd, 1e-4 * np.abs(w_gd).max(), "d_density")
    _close(gt, w_gt, 1e-4 * np.abs(w_gt).max(), "d_tf_base")
    # The same route by its other names.
    img2 = tfused.render_image_fused(*tside[:2], ray_threshold=thr,
                                     shaded=kd > 0, light_kd=kd)
    np.testing.assert_array_equal(img2.detach().numpy(), img)
    img3, ovf = tdiff_v3.render_image_v3_with_ovf(*tside[:2], **kw)
    np.testing.assert_array_equal(img3.detach().numpy(), img)
    assert ovf == 0.0


# Scenes the step kernels' warp-level scatter finds hardest, pinned here to
# ``volrt`` through the plain versions the kernels are held to on the card:
# a noise density, whose lanes spread over many TF rows, and a viewport
# whose width and height are not multiples of the kernels' 16-pixel blocks.
SCENES = {
    "synthetic": dict(),
    "noise": dict(noise=True),
    "ragged": dict(dims=(29, 21)),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_march_function_matches_jax_v3_kernels(scene):
    """(b) The analytic backward against ``volrt``'s own, the v3 Pallas
    kernels behind ``render_image_v3``, with the diffuse tap and ERT."""
    jside, tside = _pair(**SCENES[scene])
    kw = dict(ray_threshold=0.95, light_kd=0.6, shaded=True)
    want_img, want_loss, want_gd, want_gt = _jax_image_loss_grads(
        jdiff_v3.render_image_v3, *jside, **kw)
    img, loss, gd, gt = _torch_loss_grads(tdiff_v3.render_image_v3, *tside,
                                          **kw)
    # 2e-3: the shade-tap class (the TPU kernel normalises the light
    # direction with rsqrt).
    _close(img, want_img, 2e-3, "image")
    assert loss == pytest.approx(want_loss, rel=1e-4)
    _close(gd, want_gd, ATOL_GRAD, "d_density")
    _close(gt, want_gt, ATOL_GRAD, "d_tf_base")


def _onepass(tside, **kw):
    loss, g = tdiff_v3.l2_loss_grads_v3_onepass(*tside, **kw)
    return loss.item(), g["density"].numpy(), g["tf_base"].numpy()


@pytest.mark.parametrize("shaded,scene", [
    (False, "synthetic"), (True, "synthetic"), (False, "noise"),
    (True, "ragged")])
def test_onepass_matches_jax_onepass(shaded, scene):
    """(c) ``l2_loss_grads_v3_onepass`` against ``volrt``'s one-kernel L2
    step and against the port's own two-kernel route."""
    jside, tside = _pair(**SCENES[scene])
    kw = dict(ray_threshold=0.95, shaded=shaded, light_kd=0.6)
    want_loss, want_g = jdiff_v3.l2_loss_grads_v3_onepass(*jside, **kw)
    loss, gd, gt = _onepass(tside, **kw)
    # Unshaded the two marches are the same f32 ops: rtol 1e-6. The
    # diffuse tap's light direction is the shade-tap class.
    assert loss == pytest.approx(float(want_loss),
                                 rel=1e-4 if shaded else 1e-6)
    _close(gd, np.asarray(want_g.density), ATOL_GRAD, "d_density")
    _close(gt, np.asarray(want_g.tf_base), ATOL_GRAD, "d_tf_base")

    _, two_loss, two_gd, two_gt = _torch_loss_grads(
        tdiff_v3.render_image_v3, *tside, ray_threshold=0.95,
        light_kd=0.6 if shaded else 0.0, shaded=shaded)
    assert loss == pytest.approx(two_loss, rel=1e-6)
    _close(gd, two_gd, 1e-9, "d_density vs two-kernel")
    _close(gt, two_gt, 1e-7, "d_tf_base vs two-kernel")
    assert not tside[0].density.grad and not tside[0].tf_base.grad


def test_onepass_skips_a_leaf_that_needs_no_gradient():
    _, tside = _pair()
    _, gd, gt = _onepass(tside)
    _, gd_only, zero_gt = _onepass(tside, need_dtf=False)
    _, zero_gd, gt_only = _onepass(tside, need_dvol=False)
    assert not zero_gt.any() and not zero_gd.any()
    np.testing.assert_array_equal(gd_only, gd)
    np.testing.assert_array_equal(gt_only, gt)
    # Under autograd a leaf that does not require grad is skipped too.
    scene, view, target = tside
    scene.tf_base.requires_grad_(False)
    loss = torch.mean((tdiff_v3.render_image_v3(scene, view) - target) ** 2)
    (g,) = torch.autograd.grad(loss, [scene.density])
    _close(g.numpy(), gd, 1e-9, "d_density with a frozen TF")


def test_opaque_sample_takes_the_references_guard():
    """(d) A TF whose upper half is fully opaque puts samples with
    ``1 - c.a`` within 1e-6 of 0 on most rays. With ERT off the march
    goes on behind them, and the suffix-sum backward would divide by
    ``1 - c.a``; the reference guards the division
    (``diff_v3.py:1913-1915``) and the port must give its numbers, finite,
    not autograd's."""
    tf_base = np.asarray(j_default_tf()).copy()
    tf_base[48:, 3] = 1.0
    jside, tside = _pair(tf_base=tf_base)
    want_loss, want_g = jdiff_v3.l2_loss_grads_v3_onepass(
        *jside, ray_threshold=2.0)
    loss, gd, gt = _onepass(tside, ray_threshold=2.0)
    assert np.isfinite(gd).all() and np.isfinite(gt).all()
    assert loss == pytest.approx(float(want_loss), rel=1e-6)
    _close(gd, np.asarray(want_g.density), ATOL_GRAD, "d_density")
    _close(gt, np.asarray(want_g.tf_base), ATOL_GRAD, "d_tf_base")
    # The guard did fire: some sample's colour is opaque to within 1e-6.
    scene, view, _ = tside
    args, kw = fwd_v3.ray_args(view, scene.density.detach(),
                               scene.premult_tf().detach(), STEP, 2.0, 0.0)
    assert (scene.premult_tf()[:, 3] > 1 - 1e-6).any()
    out = march.march_fwd(*args, **kw)
    assert (out[:, 3] > 1 - 1e-6).any()


def test_grad_wrappers_on_cpu_take_plain_path_and_check_inputs():
    _, (scene, view, target) = _pair(dims=(16, 16))
    with torch.no_grad():
        args, kw = fwd_v3.ray_args(view, scene.density, scene.premult_tf(),
                                   STEP, 0.95, 0.6, loss_scale=1e-3)
        tgt = target.reshape(-1, 4)
        out, gd, gt = march.l2_step(*args, tgt, **kw)
        p_out, p_gd, p_gt = march.l2_step_plain(*args, tgt, **kw)
        g = (out - tgt) * 1e-3
        b_gd, b_gt = march.march_bwd(*args, out, g, **kw)
    for a, b in ((out, p_out), (gd, p_gd), (gt, p_gt)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # The one-launch step is the forward, the cotangent and the backward.
    torch.testing.assert_close(b_gd, gd, atol=1e-9, rtol=0)
    torch.testing.assert_close(b_gt, gt, atol=1e-7, rtol=0)
    assert (march.march_fwd.launches, march.march_bwd.launches,
            march.l2_step.launches) == (0, 0, 0)
    with pytest.raises(ValueError):
        march.l2_step(*args, tgt[:-1], **kw)
    with pytest.raises(TypeError):
        march.march_bwd(*args, out, g.double(), **kw)
    with pytest.raises(ValueError):
        march.march_bwd(*args, out.t().contiguous().t(), g, **kw)
    zeros = march.march_bwd(*args, out, g, need_dtf=False, need_dvol=False,
                            **kw)
    assert not zeros[0].any() and not zeros[1].any()


def test_unported_arguments_raise():
    """(f) What the differentiable path has not ported yet says so; what it
    has ported since (phong in the oracle and in the v3 kernels, ESL in
    both, the round-1 routes) runs."""
    _, (scene, view, target) = _pair(dims=(8, 8))
    o = torch.zeros((1, 3))
    # ESL in the oracle: the leading leap, which on this scene (no empty
    # block) changes nothing.
    unlit = trender.render_diff_image(scene, view)
    leapt = trender.render_diff_image(scene, view, esl=True)
    torch.testing.assert_close(leapt, unlit, atol=1e-6, rtol=0)
    one = trender.render_diff(scene, o, o + 1.0, esl=True)
    assert one.shape == (1, 4) and torch.isfinite(one).all()
    lit = trender.render_diff_image(scene, view, light_kd=0.6, phong=True)
    assert torch.isfinite(lit).all()
    assert (lit[..., :3] - unlit[..., :3]).abs().max() > 1e-3
    torch.testing.assert_close(lit[..., 3], unlit[..., 3], atol=1e-6, rtol=0)
    one = trender.render_diff(scene, o, o + 1.0, light_kd=0.6, phong=True,
                              light_pos=view.light_pos)
    assert one.shape == (1, 4) and torch.isfinite(one).all()
    for kw in (dict(esl=True), dict(phong=True), dict(fast=True)):
        if kw.get("esl"):
            # ESL is a mode of the v3 kernels: each route runs it.
            img = tdiff_v3.render_image_v3(scene, view, **kw)
            torch.testing.assert_close(img.detach(), unlit.detach(),
                                       atol=ATOL_IMG, rtol=0)
            loss, g = tdiff_v3.l2_loss_grads_v3_onepass(scene, view, target,
                                                        **kw)
            assert torch.isfinite(loss) and torch.isfinite(g["density"]).all()
            assert torch.isfinite(tfused.l2_loss_fused(scene, view, target,
                                                       **kw))
            continue
        if kw.get("phong"):
            # Phong is a mode of the v3 kernels: each route runs it.
            img = tdiff_v3.render_image_v3(scene, view, light_kd=0.6, **kw)
            torch.testing.assert_close(img.detach(), lit.detach(),
                                       atol=ATOL_IMG, rtol=0)
            loss, g = tdiff_v3.l2_loss_grads_v3_onepass(scene, view, target,
                                                        **kw)
            assert torch.isfinite(loss) and torch.isfinite(g["density"]).all()
            assert torch.isfinite(tfused.l2_loss_fused(scene, view, target,
                                                       **kw))
            continue
        # fast (bf16 storage) is a mode of the v3 kernels: each route runs
        # it, and they agree. The stored density moves the image from the
        # f32 oracle's (measured 0.020 here, the default TF being steep);
        # test_torch_fast.py holds the mode to volrt's.
        img = tdiff_v3.render_image_v3(scene, view, **kw)
        want = torch.mean((img - target) ** 2).item()
        loss, g = tdiff_v3.l2_loss_grads_v3_onepass(scene, view, target,
                                                    **kw)
        assert loss.item() == pytest.approx(want, rel=1e-6)
        assert g["density"].dtype == torch.float32
        assert torch.isfinite(g["density"]).all()
        assert tfused.l2_loss_fused(scene, view, target, **kw).item() == (
            pytest.approx(want, rel=1e-6))
        assert 1e-4 < (img - unlit).abs().max().item() <= 0.05
    for blocked in (False, True):
        img = tfused.render_image_fused(scene, view, blocked=blocked)
        assert img.shape == (8, 8, 4) and img.requires_grad
        _close(img.detach().numpy(), unlit.detach().numpy(), ATOL_IMG,
               "round-1 route vs oracle")


def _esl_scene(kind: str) -> np.ndarray:
    """Densities for the ESL grid: ``blob`` (``test_diff_v3.py``'s sparse
    blob, in [0, 1] as u8/255), ``fraction`` (the synthetic volume over
    255 with values half a step from a rounding edge) and ``noise`` (a low
    uniform field under a dense corner)."""
    rng = np.random.default_rng(8)
    if kind == "blob":
        vol = np.zeros((16, 16, 16), np.float32)
        vol[10:14, 10:14, 10:14] = 220.0
        return vol / 255.0
    if kind == "fraction":
        raw = synthetic_volume(16).astype(np.float32)
        raw += rng.choice(np.float32([-0.5, 0.5, 0.49, -0.51]), raw.shape)
        return np.clip(raw, 0, 255) / 255.0
    vol = rng.uniform(0.0, 0.12, (20, 13, 27)).astype(np.float32)
    vol[:8, :8, :8] = rng.uniform(0.5, 1.0, (8, 8, 8))
    return vol


@pytest.mark.parametrize("kind", ["blob", "fraction", "noise"])
def test_scene_empty_grid_matches_volrt(kind):
    """``scene_empty_grid`` (the density rounded to uint8, the min/max
    grid, the premultiplied live TF) equals ``volrt``'s: the grid, the
    block edge and the block size."""
    density = _esl_scene(kind)
    tf_base = np.asarray(j_default_tf(), np.float32)
    jscene = jrender.DiffScene(density=jnp.asarray(density),
                               tf_base=jnp.asarray(tf_base), ray_step=STEP)
    tscene = trender.scene_from_arrays(density, tf_base, STEP, device=CPU)
    w_empty, w_block, w_bs = jrender.scene_empty_grid(jscene)
    empty, block, bs = trender.scene_empty_grid(tscene)
    np.testing.assert_array_equal(empty.numpy(), np.asarray(w_empty))
    assert block == w_block and bs == tuple(w_bs)
    inside = empty[:2, :2, :2] if kind == "blob" else empty[:1, :1, :1]
    assert empty.any() and (kind == "fraction" or not inside.all())


@pytest.mark.parametrize("persp", [False, True])
def test_oracle_esl_matches_volrt(persp):
    """The oracle with ``esl=True`` (the leading leap of
    ``batched.esl_start_raw`` on ``scene_empty_grid``, then the march from
    there) against ``volrt``'s ``render_diff_image(esl=True)``: image,
    loss and both gradients, the oracle's tolerances; on the sparse blob
    the image is the ESL-off one."""
    jside, tside = _pair(persp=persp)
    density = _esl_scene("blob")
    jscene = jside[0].replace(density=jnp.asarray(density))
    tscene = trender.scene_from_arrays(
        density, tside[0].tf_base.detach().numpy(), STEP, device=CPU)
    jside, tside = (jscene, *jside[1:]), (tscene, *tside[1:])
    want_img, want_loss, want_gd, want_gt = _jax_image_loss_grads(
        jrender.render_diff_image, *jside, esl=True)
    img, loss, gd, gt = _torch_loss_grads(trender.render_diff_image, *tside,
                                          esl=True)
    _close(img, want_img, ATOL_IMG, "image")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for got, want, what in ((gd, want_gd, "d_density"),
                            (gt, want_gt, "d_tf_base")):
        assert np.abs(want).max() > 1e-4
        _close(got, want, ATOL_GRAD, what)
    # The leap moves each ray's k0, and k0 + i*step rounds otherwise than
    # knear + i*step: the f32 class of a march, 1e-5.
    off = trender.render_diff_image(tscene, tside[1]).detach().numpy()
    _close(img, off, 1e-5, "ESL against no ESL")
