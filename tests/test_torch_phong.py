"""Gradient Blinn-Phong in the port's torch-op layers against ``volrt``:
rungs 0-1 with ``shading="phong"``, the autograd oracle's ``phong=True``,
``fit(shading="phong")`` and the CLI.

The same volume, TF and view go to both packages through numpy
(``raycaster_from_arrays`` carries ``shading`` across); the port runs on the
CPU. Tolerances, with what was measured at 16^3:

- rungs 0-1: 1e-6 in nearest mode, where the six normal taps are whole
  voxel values (measured 1.5e-7); 3e-5 in trilinear mode, the tolerance
  ``tests/test_golden.py`` holds ``volrt``'s two rungs to each other at
  (XLA's ``jit`` contracts the lerps; measured 6.8e-6).
- the oracle's image against rung 1's with ERT off on both: 2e-3, as
  ``tests/test_diff.py:53-72`` holds ``volrt``'s (the oracle normalises
  with rsqrt of a floored square, rung 1 divides by a floored norm;
  measured 2.5e-6).
- the oracle against ``volrt``'s ``render_diff_image(phong=True)``: image
  2e-4 (measured 1.4e-5), gradients 2e-3 of the largest entry, the rsqrt
  class (measured 1.0e-7 of 2.9e-3 in density, 7.5e-8 of 0.15 in the TF).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_core import one_torch_thread  # noqa: F401
from tests.conftest import synthetic_volume
from tests.test_torch_diff import (
    CPU, STEP, _jax_loss_grads, _pair, _torch_loss_grads)
from tests.test_torch_ladder import _view
from volrt.core.tf import default_transfer_fn as j_default_tf
from volrt.core.types import Volume as JVolume
from volrt.core.types import make_raycaster as j_make_raycaster
from volrt.diff import render as jrender
from volrt.renderers import get_renderer as j_get_renderer
from volrt_torch import cli
from volrt_torch import constants as tconst
from volrt_torch.core.types import raycaster_from_arrays
from volrt_torch.diff import fused as tfused
from volrt_torch.diff import render as trender
from volrt_torch.renderers import common as tcommon
from volrt_torch.renderers import get_renderer
from volrt_torch.train import fit as tfit_mod


def _rcs(interp, persp=False, thr=0.95, kd=0.6, esl=False, n=16, wh=24):
    """One JAX render state with phong shading and the port's copy."""
    jrc = j_make_raycaster(
        JVolume.from_numpy(synthetic_volume(n)), view=_view(wh, persp),
        light_kd=kd, ray_threshold=thr, interpolation=interp, esl=esl,
        shading="phong")
    v = jrc.view
    trc = raycaster_from_arrays(
        np.asarray(jrc.volume.data), np.asarray(jrc.transfer_fn),
        np.asarray(v.origin), np.asarray(v.direction),
        np.asarray(v.right_plane), np.asarray(v.up_plane),
        np.asarray(v.light_pos), v.dims, v.perspective, jrc.ray_step,
        float(jrc.ray_threshold), float(jrc.light_kd), jrc.shading,
        interpolation=jrc.interpolation, esl=jrc.esl,
        esl_empty=np.asarray(jrc.esl_empty),
        esl_block_dims=jrc.esl_block_dims, device=CPU)
    assert trc.shading == "phong"
    return jrc, trc


@pytest.mark.parametrize("persp", [False, True], ids=["ortho", "persp"])
@pytest.mark.parametrize("rung", [0, 1])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_phong_rung_matches_volrt(interp, rung, persp):
    jrc, trc = _rcs(interp, persp, esl=(rung == 1))
    want = np.asarray(j_get_renderer(rung).render_float(jrc))
    got = get_renderer(rung).render_float(trc).numpy()
    assert got.shape == (24, 24, 4) and got[..., 3].max() > 0.5
    np.testing.assert_allclose(
        got, want, atol=1e-6 if interp == "nearest" else 3e-5, rtol=0)
    # It does shade differently from the diffuse tap, in the colours only.
    diffuse = get_renderer(rung).render_float(
        trc.replace(shading="diffuse")).numpy()
    assert np.abs(got[..., :3] - diffuse[..., :3]).max() > 1e-3
    np.testing.assert_allclose(got[..., 3], diffuse[..., 3], atol=1e-6)


def test_phong_gates_and_guards():
    _, trc = _rcs("trilinear", wh=8)
    # Below the kd gate phong leaves the colour alone, as the tap does.
    off = get_renderer(1).render_float(trc.replace(light_kd=0.005))
    plain = get_renderer(1).render_float(
        trc.replace(light_kd=0.0, shading="diffuse"))
    torch.testing.assert_close(off, plain, atol=0, rtol=0)
    for rung in (2, 3, 4, 5):
        rc = trc.replace(interpolation="nearest") if rung == 2 else trc
        if rung == 5:
            # Rung 5's kernel has phong; rungs 2-4 refuse it.
            img, _ = get_renderer(rung).render_float(rc)
            assert torch.isfinite(img).all() and img[..., 3].max() > 0.5
            continue
        with pytest.raises(NotImplementedError, match="phong"):
            get_renderer(rung).render_float(rc)
    with pytest.raises(ValueError, match="shading"):
        get_renderer(1).render_float(trc.replace(shading="toon"))
    pt = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="ray direction"):
        tcommon.classify_and_shade(
            trc.volume.data, trc.transfer_fn, pt,
            light_pos=trc.view.light_pos, light_kd=0.6,
            interpolation="trilinear", shading="phong")
    _, (scene, view, _) = _pair(dims=(8, 8))
    with pytest.raises(ValueError, match="light_pos"):
        trender.render_diff(scene, pt, pt, phong=True)
    for blocked in (None, False, True):
        if blocked is None:
            # The v3 kernels' phong mode.
            img = tfused.render_image_fused(scene, view, phong=True,
                                            blocked=blocked)
            assert torch.isfinite(img).all() and img.requires_grad
            continue
        with pytest.raises(NotImplementedError):
            tfused.render_image_fused(scene, view, phong=True,
                                      blocked=blocked)
    from volrt import constants as jconst

    for name in ("PHONG_KA", "PHONG_KS", "PHONG_SHININESS"):
        assert getattr(tconst, name) == getattr(jconst, name)


def test_oracle_phong_matches_rung_1():
    """``render_diff_image(phong=True)`` equals rung 1's phong frame with
    ERT off on both, as ``tests/test_diff.py:53-72`` holds ``volrt``'s."""
    from volrt_torch.core.types import View

    _, trc = _rcs("trilinear", thr=2.0)
    want = get_renderer(1).render_float(trc)
    scene = trender.scene_from_volume(
        trc.volume.data, np.array(j_default_tf()), trc.ray_step,
        device=CPU)
    got = trender.render_diff_image(scene, trc.view, ray_threshold=2.0,
                                    light_kd=0.6, phong=True)
    assert isinstance(trc.view, View) and want[..., 3].max() > 0.5
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               atol=2e-3, rtol=0)


PHONG_CASES = {
    "ortho-ert": dict(thr=0.95),
    "ortho-no_ert": dict(thr=2.0),
    "persp-ert": dict(thr=0.95, persp=True),
}


@pytest.mark.parametrize("case", list(PHONG_CASES))
def test_oracle_phong_matches_jax(case):
    c = PHONG_CASES[case]
    jside, tside = _pair(persp=c.get("persp", False))
    kw = dict(ray_threshold=c["thr"], light_kd=0.6, phong=True)
    want_img = np.asarray(jrender.render_diff_image(*jside[:2], **kw))
    want_loss, want_gd, want_gt = _jax_loss_grads(
        jrender.render_diff_image, *jside, **kw)
    img, loss, gd, gt = _torch_loss_grads(trender.render_diff_image, *tside,
                                          **kw)
    assert img[..., 3].max() > 0.5
    np.testing.assert_allclose(img, want_img, atol=2e-4, rtol=0)
    assert loss == pytest.approx(want_loss, rel=1e-4)
    for got, want, what in ((gd, want_gd, "d_density"),
                            (gt, want_gt, "d_tf_base")):
        top = np.abs(want).max()
        assert top > 1e-4
        np.testing.assert_allclose(got, want, atol=2e-3 * top, rtol=0,
                                   err_msg=what)
    # Not the diffuse tap's gradients.
    _, _, gd_diffuse, _ = _torch_loss_grads(
        trender.render_diff_image, *tside, ray_threshold=c["thr"],
        light_kd=0.6, shaded=True)
    assert np.abs(gd - gd_diffuse).max() > 1e-2 * np.abs(gd).max()


def test_phong_gradient_is_finite_on_flat_density():
    """A constant density has a zero gradient normal everywhere: the
    floored rsqrt keeps the backward finite, in both packages."""
    jside, tside = _pair(dims=(16, 16))
    flat = np.full((16, 16, 16), 0.5, np.float32)
    jscene = jside[0].replace(density=jnp.asarray(flat))
    with torch.no_grad():
        tside[0].density.copy_(torch.from_numpy(flat))
    kw = dict(light_kd=0.6, phong=True)
    _, want_gd, want_gt = _jax_loss_grads(
        jrender.render_diff_image, jscene, *jside[1:], **kw)
    _, _, gd, gt = _torch_loss_grads(trender.render_diff_image, *tside, **kw)
    assert np.isfinite(gd).all() and np.isfinite(gt).all()
    assert np.isfinite(want_gd).all()
    np.testing.assert_allclose(gt, want_gt, atol=2e-3 * np.abs(want_gt).max(),
                               rtol=0)


def test_fit_phong_lowers_the_loss():
    _, (gt_scene, view, _) = _pair(dims=(16, 16))
    with torch.no_grad():
        target = trender.render_diff_image(gt_scene, view, light_kd=0.6,
                                           phong=True)
    scene = trender.scene_from_arrays(
        np.full((16, 16, 16), 0.3, np.float32),
        gt_scene.tf_base.detach().numpy(), STEP, device=CPU)
    out, losses = tfit_mod.fit(scene, [(view, target)], steps=4, lr=0.02,
                               shading="phong")
    assert out is scene and len(losses) == 4
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # The loss is phong's, not the diffuse tap's.
    with torch.no_grad():
        first = torch.mean((trender.render_diff_image(
            trender.scene_from_arrays(
                np.full((16, 16, 16), 0.3, np.float32),
                gt_scene.tf_base.detach().numpy(), STEP, device=CPU),
            view, light_kd=0.6, phong=True) - target) ** 2).item()
    assert losses[0] == pytest.approx(first, rel=1e-6)
    # With fused=True the one-launch step's phong mode trains.
    _, fused = tfit_mod.fit(scene, [(view, target)], steps=1,
                            shading="phong", fused=True)
    assert len(fused) == 1 and np.isfinite(fused[0])


@pytest.mark.parametrize("rung", [0, 1])
def test_cli_render_phong(rung, tmp_path):
    from volrt.viz import read_png

    base = ["render", "--synthetic", "16", "-s", "24", "20", "--angles",
            "30", "20", "0", "--device", "cpu", "-r", str(rung)]
    frames = {}
    for shading in ("phong", "diffuse"):
        out = str(tmp_path / f"{shading}.png")
        assert cli.main(base + ["--shading", shading, "-o", out]) == 0
        frames[shading] = read_png(out)
    assert frames["phong"].shape == (20, 24, 4)
    assert len(np.unique(frames["phong"])) > 10
    assert not np.array_equal(frames["phong"], frames["diffuse"])
    np.testing.assert_array_equal(frames["phong"][..., 3],
                                  frames["diffuse"][..., 3])
    with pytest.raises(NotImplementedError, match="phong"):
        cli.main(base[:-2] + ["-r", "3", "--shading", "phong", "-o",
                              str(tmp_path / "r3.png")])


def test_cli_fit_phong(capsys):
    assert cli.main(["fit", "--shading", "phong", "--synthetic", "8", "-s",
                     "16", "16", "--steps", "2", "--device", CPU]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("fit step")]
    losses = [float(ln.split("loss")[1]) for ln in lines]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[1] < losses[0]
    # --fused trains through the one-launch step's phong mode.
    assert cli.main(["fit", "--shading", "phong", "--fused", "--synthetic",
                     "8", "-s", "16", "16", "--steps", "1", "--device",
                     CPU]) == 0
