"""Gradient Blinn-Phong as a mode of the v3 kernels (``march_fwd``,
``march_bwd``, ``l2_step``) against ``volrt``'s v3 phong: rung 5,
``render_image_v3(phong=True)``, the one-launch L2 step, the fused routes,
``fit(shading="phong", fused=True)`` and the CLI.

The same volume, TF, view and target go to both packages through numpy; the
port runs on the CPU, where the kernels' wrappers take their plain torch
versions (``march.phong_v3`` and ``march.phong_chain``, the kernels' math
op for op). The JAX kernels run in Pallas interpret mode, as
``tests/test_diff_v3.py:395-455`` runs them; each JAX call takes some 10 s
here, so every reference is computed once per module (``jax_refs``).

Tolerances are ``tests/test_torch_diff.py``'s (``test_diff_v3.py``'s):
images 2e-4, gradients of the mean-square loss 5e-6 on both leaves, the
one-pass loss rtol 1e-6 (the two-kernel loss 1e-5, the oracle's class in
``test_torch_diff.py``); the phong image's alpha equals the unshaded
image's to the bit. Measured at 16^3 / 32^2: images within 1.4e-5 of
``volrt``'s (1.8e-6 on the face-grazing pose), gradients within 1.1e-7
(d_density, whose largest entry is 2.9e-3) and 4.8e-8 (d_tf_base, of
0.15), the losses 4.7e-7 (two-kernel) and 9.4e-8 (one-pass) apart.
The kernel path against the autograd oracle (``render_diff_image(phong=
True)``, whose normal taps move the world point by 2/n where v3's move the
clipped voxel coordinate by 1): 2e-4 in the image and 2e-3 of the largest
gradient entry, the oracle's phong class (``tests/test_torch_phong.py``);
measured 9e-8 and 3.4e-7 of it on the default pose. On the face-grazing
pose the two forms part by more than that, which is what that pose checks.
"""
import numpy as np
import pytest
import torch

from tests.conftest import synthetic_volume
from tests.test_torch_diff import (
    CPU, STEP, _jax_image_loss_grads, _pair, _torch_loss_grads)
from volrt.core.tf import default_transfer_fn as j_default_tf
from volrt.core.types import Volume as JVolume
from volrt.core.types import make_raycaster as j_make_raycaster
from volrt.core.view import Camera as JCamera
from volrt.renderers.pallas import diff_v3 as jdiff_v3
from volrt_torch import cli
from volrt_torch.bench.step_ab import variant_name
from volrt_torch.core.types import raycaster_from_arrays
from volrt_torch.diff import fused as tfused
from volrt_torch.diff import render as trender
from volrt_torch.renderers import diff_v3 as tdiff_v3
from volrt_torch.renderers import fwd_v3, get_renderer
from volrt_torch.renderers.cuda import march
from volrt_torch.train import fit as tfit_mod

ATOL_IMG = 2e-4
ATOL_GRAD = 5e-6
KD = 0.6
# Rung 5's cases. "faces": the camera zoomed until the cube fills the
# viewport, looking along z, over a uniform-noise volume: the rays' x and y
# voxel coordinates lie at i/2 - 0.25, so the first and last columns and
# rows sit in [-0.5, 0) and (n - 1, n - 0.5], where v3's clipped taps and
# the oracle's moved world point give other normals, and the noise keeps
# the gate open there.
RUNG5 = {
    "ortho-ert": dict(thr=0.95),
    "ortho-no_ert": dict(thr=2.0),
    "persp-ert": dict(thr=0.95, persp=True),
    "persp-no_ert": dict(thr=2.0, persp=True),
    "faces": dict(thr=0.95, faces=True),
}


@pytest.fixture(scope="module")
def jax_refs() -> dict:
    """The JAX references, computed once per key for the module."""
    return {}


def _ref(cache: dict, key, fn):
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def _camera(dims, persp=False, faces=False) -> JCamera:
    cam = JCamera(dims=dims, perspective=persp)
    cam.toggle_perspective(update_mode=True)
    if faces:
        cam.zoom(-1.0)
    else:
        cam.set_camera_position((30.0, 20.0, 0.0))
    return cam


def _rung5_rcs(case: str, n: int = 16, wh: int = 32):
    """One JAX render state with phong shading and the port's copy."""
    c = RUNG5[case]
    faces = c.get("faces", False)
    vol = (np.random.default_rng(3).integers(0, 256, (n, n, n), np.uint8)
           if faces else synthetic_volume(n))
    cam = _camera((wh, wh), c.get("persp", False), faces)
    jrc = j_make_raycaster(JVolume.from_numpy(vol), view=cam.view(),
                           light_kd=KD, ray_threshold=c["thr"],
                           interpolation="trilinear", esl=False,
                           shading="phong")
    v = jrc.view
    trc = raycaster_from_arrays(
        np.asarray(jrc.volume.data), np.asarray(jrc.transfer_fn),
        np.asarray(v.origin), np.asarray(v.direction),
        np.asarray(v.right_plane), np.asarray(v.up_plane),
        np.asarray(v.light_pos), v.dims, v.perspective, jrc.ray_step,
        float(jrc.ray_threshold), float(jrc.light_kd), jrc.shading,
        device=CPU)
    return jrc, trc


@pytest.mark.parametrize("case", list(RUNG5))
def test_rung5_phong_matches_volrt(case, jax_refs):
    """``fwd_v3.render_float`` with ``shading="phong"`` (the plain march
    in phong mode) against ``volrt``'s rung 5 phong, image within 2e-4;
    its alpha is the unshaded render's to the bit, its colour is not."""
    from volrt.renderers.pallas import fwd_v3 as jfwd_v3

    jrc, trc = _rung5_rcs(case)
    want = _ref(jax_refs, ("rung5", case),
                lambda: np.asarray(jfwd_v3.render_float(jrc)[0]))
    got, ovf = fwd_v3.render_float(trc)
    assert got.shape == (32, 32, 4) and ovf == 0.0
    assert got[..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_IMG, rtol=0)
    unshaded, _ = fwd_v3.render_float(trc.replace(light_kd=0.0))
    assert torch.equal(got[..., 3], unshaded[..., 3])
    diffuse, _ = fwd_v3.render_float(trc.replace(shading="diffuse"))
    assert (got[..., :3] - diffuse[..., :3]).abs().max() > 1e-2
    if RUNG5[case].get("faces"):
        # The oracle's normals (world point moved by 2/n) part from v3's
        # (voxel coordinate clipped, moved by 1) at the faces, by more than
        # the tolerance: this pose tells the two forms apart.
        scene = trender.scene_from_volume(
            trc.volume.data, np.array(j_default_tf()), trc.ray_step,
            device=CPU)
        oracle = trender.render_diff_image(scene, trc.view, ray_threshold=0.95,
                                           light_kd=KD, phong=True).detach()
        edge = (got - oracle).abs()[[0, -1]].max()
        assert edge > 10 * ATOL_IMG, edge


def test_render_image_v3_phong_matches_volrt(jax_refs):
    """``render_image_v3(phong=True)`` under autograd (``MarchFunction``:
    the plain forward and the plain phong replay) against ``volrt``'s
    ``value_and_grad`` through its ``render_image_v3(phong=True)``: image,
    loss and both leaves' gradients."""
    jside, tside = _pair()
    kw = dict(ray_threshold=0.95, light_kd=KD, phong=True)
    want_img, want_loss, want_gd, want_gt = _ref(
        jax_refs, "v3", lambda: _jax_image_loss_grads(
            jdiff_v3.render_image_v3, *jside, **kw))
    img, loss, gd, gt = _torch_loss_grads(tdiff_v3.render_image_v3, *tside,
                                          **kw)
    assert img[..., 3].max() > 0.5
    np.testing.assert_allclose(img, want_img, atol=ATOL_IMG, rtol=0)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for got, want, what in ((gd, want_gd, "d_density"),
                            (gt, want_gt, "d_tf_base")):
        assert np.abs(want).max() > 1e-4
        np.testing.assert_allclose(got, want, atol=ATOL_GRAD, rtol=0,
                                   err_msg=what)
    # Phong's gradients, not the diffuse tap's.
    _, _, gd_diffuse, _ = _torch_loss_grads(
        tdiff_v3.render_image_v3, *tside, ray_threshold=0.95, light_kd=KD,
        shaded=True)
    assert np.abs(gd - gd_diffuse).max() > 1e-2 * np.abs(gd).max()


NEEDS = {"both": {}, "need_dtf=False": dict(need_dtf=False),
         "need_dvol=False": dict(need_dvol=False)}


@pytest.mark.parametrize("need", list(NEEDS))
def test_onepass_phong_matches_volrt(need, jax_refs):
    """``l2_loss_grads_v3_onepass(phong=True)`` (the plain ``l2_step`` in
    phong mode) against ``volrt``'s one-pass phong: the loss at rtol 1e-6,
    the gradients at 5e-6; a skipped leaf's gradient is zero and the
    other's is the whole step's."""
    jside, tside = _pair()

    def jax_onepass():
        loss, g = jdiff_v3.l2_loss_grads_v3_onepass(
            *jside, phong=True, light_kd=KD)
        return float(loss), np.asarray(g.density), np.asarray(g.tf_base)

    want_loss, want_gd, want_gt = _ref(jax_refs, "onepass", jax_onepass)
    loss, g = tdiff_v3.l2_loss_grads_v3_onepass(
        *tside, phong=True, light_kd=KD, **NEEDS[need])
    assert loss.item() == pytest.approx(want_loss, rel=1e-6)
    for leaf, want, skip in (("density", want_gd, "need_dvol"),
                             ("tf_base", want_gt, "need_dtf")):
        got = g[leaf].numpy()
        if skip in NEEDS[need]:
            assert not got.any(), leaf
            continue
        assert np.abs(want).max() > 1e-4
        np.testing.assert_allclose(got, want, atol=ATOL_GRAD, rtol=0,
                                   err_msg=leaf)


def _march_inputs(thr: float, persp: bool = False, noise: bool = False,
                  flat: bool = False):
    """The plain march's arguments for one scene of ``_pair`` (phong, kd
    0.6), with a seeded cotangent; ``flat`` makes the density constant."""
    _, (scene, view, _) = _pair(persp=persp, noise=noise)
    density = scene.density.detach().clone()
    if flat:
        density.fill_(0.5)
    args, kw = fwd_v3.ray_args(view, density, scene.premult_tf().detach(),
                               STEP, thr, KD, phong=True)
    assert kw["phong"] and not kw["shade"]
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(args[0].shape[0], 4)).astype(np.float32))
    return args, kw, g


@pytest.mark.parametrize("case", ["ert", "no_ert", "persp-ert", "noise"])
def test_plain_phong_replay_matches_autograd(case):
    """The analytic phong replay (``march_bwd_plain``: ``phong_chain``
    and the gradient's six cells) against autograd through
    ``march_fwd_plain`` in phong mode, whose clamps at 0 pass gradient only
    where positive, as the chain's masks do: 1e-4 of the largest entry, the
    suffix sums' class (``test_torch_diff.py``, test (b)). Each leaf that
    is not needed gets zeros, the other the same gradient."""
    args, kw, g = _march_inputs(0.95 if "ert" in case else 2.0,
                                persp="persp" in case, noise=case == "noise")
    density = args[5].clone().requires_grad_(True)
    tf = args[6].clone().requires_grad_(True)
    a = (*args[:5], density, tf, args[7])
    out = march.march_fwd_plain(*a, **kw)
    want = torch.autograd.grad((out * g).sum(), [density, tf])
    got = march.march_bwd_plain(*args, out.detach(), g, **kw)
    for x, w, what in zip(got, want, ("d_density", "d_premult_tf")):
        top = w.abs().max().item()
        assert top > 1e-3, what
        torch.testing.assert_close(x, w, atol=1e-4 * top, rtol=0, msg=what)
    no_tf = march.march_bwd_plain(*args, out.detach(), g, need_dtf=False,
                                  **kw)
    no_vol = march.march_bwd_plain(*args, out.detach(), g, need_dvol=False,
                                   **kw)
    assert not no_tf[1].any() and not no_vol[0].any()
    torch.testing.assert_close(no_tf[0], got[0], atol=0, rtol=0)
    torch.testing.assert_close(no_vol[1], got[1], atol=0, rtol=0)


def test_phong_gradient_is_finite_on_flat_density():
    """On a constant density the raw gradient is 0, the normal 0 (through
    the 1e-16 floor) and the strict masks let no cotangent through it: the
    kernel path's gradients are finite and equal autograd's through the
    plain march, the image is the TF's colour scaled by KA."""
    args, kw, g = _march_inputs(0.95, flat=True)
    out, d_vol, d_tf = march.l2_step_plain(*args, torch.zeros_like(g), **kw)
    assert torch.isfinite(d_vol).all() and torch.isfinite(d_tf).all()
    density = args[5].clone().requires_grad_(True)
    tf = args[6].clone().requires_grad_(True)
    img = march.march_fwd_plain(*args[:5], density, tf, args[7], **kw)
    want = torch.autograd.grad((img * g).sum(), [density, tf])
    got = march.march_bwd_plain(*args, img.detach(), g, **kw)
    for x, w in zip(got, want):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, w, atol=1e-4 * w.abs().max().item(),
                                   rtol=0)
    unshaded = march.march_fwd_plain(
        *args, **{**kw, "phong": False})
    assert torch.equal(out[:, 3], unshaded[:, 3])
    assert (out[:, :3] - unshaded[:, :3]).abs().max() > 1e-3


@pytest.mark.parametrize("thr", [0.95, 2.0])
def test_kernel_path_matches_the_oracle(thr):
    """``render_image_v3(phong=True)`` against autograd through the
    oracle ``render_diff_image(phong=True)`` on the default pose, where
    the two forms of the normal's taps read the same voxels: image 2e-4,
    gradients 2e-3 of the largest entry (the oracle's phong class)."""
    _, tside = _pair()
    kw = dict(ray_threshold=thr, light_kd=KD, phong=True)
    img, loss, gd, gt = _torch_loss_grads(tdiff_v3.render_image_v3, *tside,
                                          **kw)
    w_img, w_loss, w_gd, w_gt = _torch_loss_grads(
        trender.render_diff_image, *tside, **kw)
    np.testing.assert_allclose(img, w_img, atol=ATOL_IMG, rtol=0)
    assert loss == pytest.approx(w_loss, rel=1e-4)
    for got, want in ((gd, w_gd), (gt, w_gt)):
        np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max(),
                                   rtol=0)


def test_fused_routes_and_guards():
    """``render_image_fused`` / ``l2_loss_fused(phong=True)`` on
    ``blocked=None`` take the v3 kernels' phong mode; the round-1 routes
    and rungs 2-4 still refuse phong; ``shaded`` with ``phong``, and
    ``shade`` with ``phong`` at the wrappers, raise ``ValueError``."""
    _, (scene, view, target) = _pair(dims=(16, 16))
    want = tdiff_v3.render_image_v3(scene, view, light_kd=KD, phong=True)
    got = tfused.render_image_fused(scene, view, light_kd=KD, phong=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert got.requires_grad
    loss = tfused.l2_loss_fused(scene, view, target, light_kd=KD, phong=True)
    assert loss.item() == pytest.approx(
        torch.mean((want - target) ** 2).item(), rel=1e-6)
    for blocked in (False, True):
        with pytest.raises(NotImplementedError, match="v3 path"):
            tfused.render_image_fused(scene, view, phong=True,
                                      blocked=blocked)
    for fn in (tdiff_v3.render_image_v3, tfused.render_image_fused):
        with pytest.raises(ValueError, match="exclusive"):
            fn(scene, view, shaded=True, phong=True)
    with pytest.raises(ValueError, match="exclusive"):
        tdiff_v3.l2_loss_grads_v3_onepass(scene, view, target, shaded=True,
                                          phong=True)
    args, kw, g = _march_inputs(0.95)
    with pytest.raises(ValueError, match="phong"):
        march.march_fwd(*args, **{**kw, "shade": True})
    with pytest.raises(ValueError, match="phong"):
        march.l2_step(*args, g, **{**kw, "shade": True})
    _, trc = _rung5_rcs("ortho-ert", wh=8)
    for rung in (2, 3, 4):
        rc = trc.replace(interpolation="nearest") if rung == 2 else trc
        with pytest.raises(NotImplementedError, match="rung 5"):
            get_renderer(rung).render_float(rc)


def test_the_phong_variants_are_named_by_mode():
    """``step_ab.variant_name`` reads the kernels' ``Shade`` argument as
    0, 1 or 2 (none, diffuse, phong), so that the unshaded and diffuse
    variants keep the names they had as bools."""
    fwd = "_ZN12_GLOBAL__N_116march_fwd_kernelILN5volrt5ShadeE{}ELb1EEEvNS1_9MarchArgsEPf"
    assert [variant_name(fwd.format(m)) for m in range(3)] == [
        "march_fwd_kernel<0,1>", "march_fwd_kernel<1,1>",
        "march_fwd_kernel<2,1>"]
    bwd = ("_ZN12_GLOBAL__N_116march_bwd_kernelILN5volrt5ShadeE2ELb0ELb1ELb1E"
           "EEvNS1_9MarchArgsEPKfS5_NS1_8GradArgsE")
    assert variant_name(bwd) == "march_bwd_kernel<2,0,1,1>"


def test_fit_phong_fused_lowers_the_loss():
    """``fit(shading="phong", fused=True)`` takes the one-launch step in
    phong mode (its first loss is the v3 phong loss of the start, in the
    fast mode that the fused fit trains in) and the loss falls."""
    _, (gt_scene, view, _) = _pair(dims=(16, 16))
    with torch.no_grad():
        target = tdiff_v3.render_image_v3(gt_scene, view, light_kd=KD,
                                          phong=True)

    def start():
        return trender.scene_from_arrays(
            np.full((16, 16, 16), 0.3, np.float32),
            gt_scene.tf_base.detach().numpy(), STEP, device=CPU)

    with torch.no_grad():
        first = tdiff_v3.l2_loss_grads_v3_onepass(
            start(), view, target, light_kd=KD, phong=True,
            fast=True)[0].item()
    scene = start()
    out, losses = tfit_mod.fit(scene, [(view, target)], steps=4, lr=0.02,
                               shading="phong", fused=True)
    assert out is scene and len(losses) == 4
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert losses[0] == pytest.approx(first, rel=1e-6)


def test_cli_render_phong_on_rung_5(tmp_path):
    from volrt.viz import read_png

    base = ["render", "--synthetic", "16", "-s", "24", "20", "--angles",
            "30", "20", "0", "--device", "cpu"]
    frames = {}
    for shading in ("phong", "diffuse"):
        out = str(tmp_path / f"{shading}.png")
        assert cli.main(base + ["-r", "5", "--shading", shading,
                                "-o", out]) == 0
        frames[shading] = read_png(out)
    assert frames["phong"].shape == (20, 24, 4)
    assert len(np.unique(frames["phong"])) > 10
    assert not np.array_equal(frames["phong"], frames["diffuse"])
    np.testing.assert_array_equal(frames["phong"][..., 3],
                                  frames["diffuse"][..., 3])
    for rung in ("2", "3", "4"):
        with pytest.raises(NotImplementedError, match="phong"):
            cli.main(base + ["-r", rung, "--shading", "phong", "-o",
                             str(tmp_path / "r.png")])


def test_cli_fit_fused_phong(capsys):
    """``cli fit --fused --shading phong`` trains through the one-launch
    step. The fit cycles through four views whose losses differ, so "the
    loss falls" is read over two passes, as ``chip_smoke.py`` reads it."""
    assert cli.main(["fit", "--fused", "--shading", "phong", "--synthetic",
                     "8", "-s", "16", "16", "--steps", "8", "--device",
                     CPU]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("fit step")]
    losses = [float(ln.split("loss")[1]) for ln in lines]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert np.mean(losses[4:]) < np.mean(losses[:4]), losses
