"""Empty-space skipping (ESL) as a mode of the v3 kernels (``march_fwd``,
``march_bwd``, ``l2_step``) against ``volrt``'s plan-time group
compaction: rung 5, ``render_image_v3(esl=True)``, the one-launch L2 step
and the fused route.

The same volume, TF, view and target go to both packages through numpy;
the port runs on the CPU, where the kernels' wrappers take their plain
torch versions (``march.EslSkip``: a sample is skipped when every ESL
block of its trilinear cell is empty). The JAX kernels run in Pallas
interpret mode, as ``tests/test_diff_v3.py:215-270, 845-868`` runs them;
each reference is computed once per module (``jax_refs``).

The scene is ``test_diff_v3.py``'s sparse blob (a 4^3 cube of 220 in a
16^3 field of zeros), whose empty blocks hold only 0, so ESL changes no
image. ``volrt`` drops whole groups of samples whose footprint lies in
empty blocks; the port drops single samples by the same test, a superset.
Images 2e-4 against ``volrt`` and 1e-6 against the port's ESL-off image;
density gradients 5e-6; TF gradients 5e-6 on the rows that shape the
image (``live_rows``, as ``volrt``'s own test takes them): a skipped
sample's colour is 0 but its cotangent still reaches the TF rows it
would have read, and the two packages skip different sets of such
samples.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_core import one_torch_thread  # noqa: F401
from volrt.core.tf import default_transfer_fn as j_default_tf
from volrt.core.types import Volume as JVolume
from volrt.core.types import make_raycaster as j_make_raycaster
from volrt.core.view import Camera as JCamera
from volrt.diff import render as jrender
from volrt.renderers.pallas import diff_v3 as jdiff_v3
from volrt.renderers.pallas import fwd_v3 as jfwd_v3
from volrt_torch.core.types import View, raycaster_from_arrays
from volrt_torch.diff import fused as tfused
from volrt_torch.diff import render as trender
from volrt_torch.renderers import diff_v3 as tdiff_v3
from volrt_torch.renderers import fwd_v3
from volrt_torch.renderers.cuda import march

CPU = "cpu"
STEP = 0.12
ATOL_IMG = 2e-4
ATOL_SAME = 1e-6
ATOL_GRAD = 5e-6


@pytest.fixture(scope="module")
def jax_refs() -> dict:
    """The JAX references, computed once per key for the module."""
    return {}


def _ref(cache: dict, key, fn):
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def _blob() -> np.ndarray:
    vol = np.zeros((16, 16, 16), np.uint8)
    vol[10:14, 10:14, 10:14] = 220
    return vol


def _jview():
    cam = JCamera(dims=(32, 32))
    cam.set_camera_position((30.0, 20.0, 0.0))
    return cam.view()


def _tview(jview) -> View:
    return View.from_arrays(
        np.asarray(jview.origin), np.asarray(jview.direction),
        np.asarray(jview.right_plane), np.asarray(jview.up_plane),
        np.asarray(jview.light_pos), jview.dims, jview.perspective, CPU)


def _pair():
    """The blob as a float scene, its view and a seeded target, for both
    packages: ``(jscene, jview, jtarget), (tscene, tview, ttarget)``."""
    density = _blob().astype(np.float32) / 255.0
    tf_base = np.asarray(j_default_tf(), np.float32)
    target = np.random.default_rng(0).uniform(
        0, 1, (32, 32, 4)).astype(np.float32)
    jview = _jview()
    jscene = jrender.DiffScene(density=jnp.asarray(density),
                               tf_base=jnp.asarray(tf_base), ray_step=STEP)
    tscene = trender.scene_from_arrays(density, tf_base, STEP, device=CPU)
    return ((jscene, jview, jnp.asarray(target)),
            (tscene, _tview(jview), torch.from_numpy(target)))


def _live_rows(tf_base) -> np.ndarray:
    alpha = np.asarray(tf_base)[:, 3]
    return (alpha > 0) & (np.roll(alpha, 1) > 0)


def _skipped(scene, view) -> tuple[int, int]:
    """``(skipped, marched)`` samples of the view's rays under the
    scene's grid, ERT off."""
    with torch.no_grad():
        esl = tdiff_v3.scene_esl(scene)
        args, kw = fwd_v3.ray_args(view, scene.density, scene.premult_tf(),
                                   scene.ray_step, 2.0, 0.0, esl=esl)
    o, d, k0, kfar, alive, density = args[:6]
    skip = march.EslSkip(esl, density.shape)
    n = s = 0
    for i in range(march.max_steps(scene.ray_step)):
        k = k0 + i * scene.ray_step
        on = alive & (k <= kfar)
        n += int(on.sum())
        s += int((skip(o + d * k[:, None]) & on).sum())
    return s, n


def test_rung5_esl_matches_volrt(jax_refs):
    """Rung 5 with ``rc.esl`` (the plain march in its ESL mode, on the
    render state's packed grid) against ``volrt``'s rung 5 with its
    compaction, 2e-4, and against the port's ESL-off frame, 1e-6: the
    blob's empty blocks hold only 0. Most samples are skipped."""
    vol = _blob()
    jview = _jview()
    jrc = j_make_raycaster(JVolume.from_numpy(vol), interpolation="trilinear",
                           esl=True).replace(view=jview)
    want = _ref(jax_refs, "rung5",
                lambda: np.asarray(jfwd_v3.render_float(jrc)[0]))
    v = jrc.view
    trc = raycaster_from_arrays(
        vol, np.asarray(jrc.transfer_fn), np.asarray(v.origin),
        np.asarray(v.direction), np.asarray(v.right_plane),
        np.asarray(v.up_plane), np.asarray(v.light_pos), v.dims,
        v.perspective, jrc.ray_step, float(jrc.ray_threshold),
        float(jrc.light_kd), esl=True, device=CPU)
    np.testing.assert_array_equal(trc.esl_empty.numpy(),
                                  np.asarray(jrc.esl_empty))
    got, ovf = fwd_v3.render_float(trc)
    assert ovf == 0.0 and got[..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_IMG, rtol=0)
    off, _ = fwd_v3.render_float(trc.replace(esl=False))
    torch.testing.assert_close(got, off, atol=ATOL_SAME, rtol=0)
    args, kw = fwd_v3.march_args(trc)
    assert kw["esl"][1] == trc.esl_block_dims == 8
    skip = march.EslSkip(kw["esl"], args[5].shape)
    o, d, k0 = args[:3]
    assert skip(o + d * k0[:, None])[args[4]].float().mean() > 0.5


def test_render_image_v3_esl_matches_volrt(jax_refs):
    """``render_image_v3(esl=True)`` under autograd (``MarchFunction``
    with the grid of the live TF: the plain forward and replay skipping
    the same samples) against ``volrt``'s ``value_and_grad`` through its
    ``render_image_v3(esl=True)``: the image, the loss, the density
    gradient everywhere and the TF gradient on ``live_rows``."""
    jside, tside = _pair()

    def jax_side():
        jscene, jview, jtarget = jside

        def loss(s):
            img = jdiff_v3.render_image_v3(s, jview, esl=True)
            return jnp.mean((img - jtarget) ** 2), img

        (val, img), g = jax.value_and_grad(loss, has_aux=True)(jscene)
        return (np.asarray(img), float(val), np.asarray(g.density),
                np.asarray(g.tf_base))

    w_img, w_loss, w_gd, w_gt = _ref(jax_refs, "v3", jax_side)
    scene, view, target = tside
    img = tdiff_v3.render_image_v3(scene, view, esl=True)
    loss = torch.mean((img - target) ** 2)
    gd, gt = torch.autograd.grad(loss, [scene.density, scene.tf_base])
    np.testing.assert_allclose(img.detach().numpy(), w_img, atol=ATOL_IMG,
                               rtol=0)
    assert loss.item() == pytest.approx(w_loss, rel=1e-5)
    assert np.abs(w_gd).max() > 1e-4
    np.testing.assert_allclose(gd.numpy(), w_gd, atol=ATOL_GRAD, rtol=0)
    rows = _live_rows(scene.tf_base.detach())
    assert rows.sum() > 50
    np.testing.assert_allclose(gt.numpy()[rows], w_gt[rows], atol=ATOL_GRAD,
                               rtol=0)
    # The port skips samples: the ESL-off route marches them, and its TF
    # rows outside live_rows see the difference.
    img_off = tdiff_v3.render_image_v3(scene, view)
    torch.testing.assert_close(img.detach(), img_off.detach(), atol=ATOL_SAME,
                               rtol=0)
    skipped, marched = _skipped(scene, view)
    assert skipped > marched // 2


NEEDS = {"both": {}, "need_dtf=False": dict(need_dtf=False),
         "need_dvol=False": dict(need_dvol=False)}


@pytest.mark.parametrize("need", list(NEEDS))
def test_onepass_esl_matches_two_kernel_and_volrt(need, jax_refs):
    """``l2_loss_grads_v3_onepass(esl=True)`` (the plain ``l2_step`` in
    ESL mode) against the port's two-kernel ESL route (autograd through
    ``render_image_v3(esl=True)``; loss rtol 1e-6, gradients 5e-6) and
    against ``volrt``'s one-pass ESL step (the loss at rtol 1e-6, density
    5e-6, TF 5e-6 on ``live_rows``); a skipped leaf's gradient is zero."""
    jside, tside = _pair()

    def jax_onepass():
        loss, g = jdiff_v3.l2_loss_grads_v3_onepass(*jside, esl=True)
        return float(loss), np.asarray(g.density), np.asarray(g.tf_base)

    w_loss, w_gd, w_gt = _ref(jax_refs, "onepass", jax_onepass)
    scene, view, target = tside
    loss, g = tdiff_v3.l2_loss_grads_v3_onepass(scene, view, target,
                                                esl=True, **NEEDS[need])
    img = tdiff_v3.render_image_v3(scene, view, esl=True)
    two = torch.mean((img - target) ** 2)
    t_gd, t_gt = torch.autograd.grad(two, [scene.density, scene.tf_base])
    assert loss.item() == pytest.approx(two.item(), rel=1e-6)
    assert loss.item() == pytest.approx(w_loss, rel=1e-6)
    rows = _live_rows(scene.tf_base.detach())
    for leaf, got, two_kernel, want, sel, skip in (
            ("density", g["density"], t_gd, w_gd, Ellipsis, "need_dvol"),
            ("tf_base", g["tf_base"], t_gt, w_gt, rows, "need_dtf")):
        if skip in NEEDS[need]:
            assert not got.any(), leaf
            continue
        assert np.abs(want).max() > 1e-4
        torch.testing.assert_close(got, two_kernel, atol=ATOL_GRAD, rtol=0,
                                   msg=leaf)
        np.testing.assert_allclose(got.numpy()[sel], want[sel],
                                   atol=ATOL_GRAD, rtol=0, err_msg=leaf)


def test_esl_modes_of_the_plain_kernels_agree():
    """The three plain versions skip one set of samples: ``l2_step``'s
    image is ``march_fwd``'s to the bit and its gradients are
    ``march_bwd``'s on the image's L2 cotangent, in every shade. The scene
    is the blob in a field of raw values 0..25, whose blocks the grid
    calls empty by their TF buckets (12 at most, alpha 0) though the
    lerped TF gives their samples some opacity: there the ESL image moves
    off the ESL-off image, by little."""
    rng = np.random.default_rng(4)
    vol = np.maximum(_blob(), rng.integers(0, 26, (16, 16, 16), np.uint8))
    scene = trender.scene_from_arrays(
        vol.astype(np.float32) / 255.0, np.asarray(j_default_tf()), STEP,
        device=CPU)
    view = _tview(_jview())
    esl = tdiff_v3.scene_esl(scene)
    tgt = torch.from_numpy(rng.uniform(0, 1, (32 * 32, 4)).astype(np.float32))
    skipped, marched = _skipped(scene, view)
    assert 0 < skipped < marched
    for kd, phong in ((0.0, False), (0.6, False), (0.6, True)):
        with torch.no_grad():
            args, kw = fwd_v3.ray_args(
                view, scene.density, scene.premult_tf(), STEP, 0.95, kd,
                loss_scale=2.0 / tgt.numel(), phong=phong, esl=esl)
        out = march.march_fwd(*args, **kw)
        l2_out, d_vol, d_tf = march.l2_step(*args, tgt, **kw)
        assert torch.equal(out, l2_out)
        g = (out - tgt) * (args[7][6] * args[4][:, None])
        b_vol, b_tf = march.march_bwd(*args, out, g, **kw)
        torch.testing.assert_close(b_vol, d_vol, atol=0, rtol=0)
        torch.testing.assert_close(b_tf, d_tf, atol=0, rtol=0)
        off = march.march_fwd(*args, **{**kw, "esl": None})
        assert out[:, 3].max() > 0.5
        gap = (out - off).abs().max().item()
        assert 0 < gap < 0.05, gap


def test_fused_route_takes_esl_and_round1_refuses_it():
    """``render_image_fused(esl=True)`` on ``blocked=None`` is
    ``render_image_v3(esl=True)``; the round-1 routes refuse ``esl`` as
    ``volrt``'s do; the wrappers refuse a malformed grid."""
    _, (scene, view, target) = _pair()
    want = tdiff_v3.render_image_v3(scene, view, esl=True)
    got = tfused.render_image_fused(scene, view, esl=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert got.requires_grad
    loss = tfused.l2_loss_fused(scene, view, target, esl=True)
    assert loss.item() == pytest.approx(
        torch.mean((want - target) ** 2).item(), rel=1e-6)
    for blocked in (False, True):
        with pytest.raises(NotImplementedError, match="ESL"):
            tfused.render_image_fused(scene, view, esl=True, blocked=blocked)
    words, block = tdiff_v3.scene_esl(scene)
    with torch.no_grad():
        args, kw = fwd_v3.ray_args(view, scene.density, scene.premult_tf(),
                                   STEP, 0.95, 0.0)
    for bad in ((words.to(torch.int64), block), (words[:10], block),
                (words, 0)):
        with pytest.raises((TypeError, ValueError)):
            march.march_fwd(*args, **kw, esl=bad)
