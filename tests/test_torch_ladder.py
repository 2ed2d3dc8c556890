"""The port's renderer ladder, rungs 0-4, against the same rungs of ``volrt``.

The same uint8 volume, TF, view and emptiness grid go to the JAX rung and,
through ``raycaster_from_arrays``, to the port's, which runs on the CPU (its
kernels' plain versions). The JAX Pallas rungs run in interpret mode, as
``tests/test_pallas.py`` runs them; the scenes are that file's (16^3 / 32^2,
its oblique view and light).

Tolerances: 1e-6 for rungs 0-2 in nearest mode, where both packages do the
same f32 operations on whole voxel values; 1e-5 in trilinear mode, for rungs
0-1 (eager JAX samples equal the port's to the bit, but under ``jit`` XLA
contracts the lerps' multiplies and adds, which moves a sample by an ulp
and a frame by 6.3e-6 here) and for rungs 3-4 unshaded (the TPU kernels
also fold the z/y lerp into one weighted sum, where the port lerps x, y, z
in turn); 2e-3 with the diffuse tap on rungs 2-4 (the TPU kernels normalise
the light direction with rsqrt, the port divides by the norm).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_core import one_torch_thread  # noqa: F401
from tests.conftest import synthetic_volume
from volrt.core.types import View as JView
from volrt.core.types import Volume as JVolume
from volrt.core.types import make_raycaster as j_make_raycaster
from volrt.renderers import get_renderer as j_get_renderer
from volrt_torch.core.types import raycaster_from_arrays
from volrt_torch.renderers import get_renderer, renderer_name
from volrt_torch.renderers import trilinear
from volrt_torch.renderers.cuda import march

CPU = "cpu"
# (label, light_kd, ray_threshold, esl, perspective)
SCENES = [
    ("plain", 0.0, 0.95, True, False),
    ("diffuse", 0.6, 0.95, True, False),
    ("no-ert-no-esl", 0.0, 2.0, False, False),
    ("diffuse-persp-no-esl", 0.6, 0.95, False, True),
    ("persp", 0.0, 0.95, True, True),
]
RUNGS = {"nearest": (0, 1, 2), "trilinear": (0, 1, 3, 4)}
CASES = [pytest.param(interp, rung, *scene[1:], id=f"{interp}-r{rung}-{scene[0]}")
         for interp, rungs in RUNGS.items() for rung in rungs
         for scene in SCENES]


def _view(wh: int, persp: bool) -> JView:
    """The oblique view of ``tests/test_pallas.py:21-38``."""
    step_px = 3.0 / wh
    d = jnp.array([-0.1, -0.05, -1.0], jnp.float32)
    return JView(
        origin=jnp.array([0.3, 0.2, 3.0], jnp.float32),
        direction=d / jnp.linalg.norm(d),
        right_plane=jnp.array([step_px, 0.0, 0.0], jnp.float32),
        up_plane=jnp.array([0.0, step_px, 0.0], jnp.float32),
        light_pos=jnp.array([2.0, 1.0, 3.0], jnp.float32),
        dims=(wh, wh), perspective=persp)


def _rcs(interp, kd, thr, esl, persp, n=16, wh=32, volume=None):
    """One JAX render state and the port's copy of it."""
    vol = synthetic_volume(n) if volume is None else volume
    jrc = j_make_raycaster(
        JVolume.from_numpy(vol), view=_view(wh, persp), light_kd=kd,
        ray_threshold=thr, interpolation=interp, esl=esl)
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
    return jrc, trc


def _image(out):
    return out[0] if isinstance(out, tuple) else out


def _atol(interp: str, rung: int, kd: float) -> float:
    if rung >= 2 and kd > 0:
        return 2e-3
    return 1e-6 if interp == "nearest" else 1e-5


@pytest.mark.parametrize("interp,rung,kd,thr,esl,persp", CASES)
def test_rung_matches_the_same_rung_of_volrt(interp, rung, kd, thr, esl,
                                             persp):
    jrc, trc = _rcs(interp, kd, thr, esl, persp)
    want = np.asarray(_image(j_get_renderer(rung).render_float(jrc)))
    mod = get_renderer(rung)
    assert mod.NAME == j_get_renderer(rung).NAME == renderer_name(rung)
    out = mod.render_float(trc)
    if rung >= 3:
        assert out[1] == 0.0
    got = _image(out)
    assert got.shape == (32, 32, 4) and got.dtype == torch.float32
    assert got[..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=_atol(interp, rung, kd),
                               rtol=0)


@pytest.mark.parametrize("interp", list(RUNGS))
@pytest.mark.parametrize("kd", [0.0, 0.6])
def test_rungs_agree_with_each_other_and_esl_changes_no_image(interp, kd):
    """Within the port: every rung of one interpolation renders rung 0's
    image, with the leap and without it (on this scene the leap changes
    neither interpolation's image). Rung 5 marches another lattice
    (``k0 + i*step``), the repo's v3 tolerance 2e-4."""
    images = {}
    for esl in (False, True):
        _, trc = _rcs(interp, kd, 0.95, esl, False)
        rungs = RUNGS[interp] + ((5,) if interp == "trilinear" else ())
        for rung in rungs:
            images[rung, esl] = _image(get_renderer(rung).render_float(trc))
    base = images[0, False]
    for (rung, esl), img in images.items():
        if kd > 0 and rung >= 2:
            atol = 2e-3
        elif rung == 5:
            atol = 2e-4
        else:
            atol = 1e-6 if interp == "nearest" else 1e-5
        torch.testing.assert_close(img, base, atol=atol, rtol=0,
                                   msg=lambda m: f"rung {rung} esl {esl}: {m}")
    if interp == "trilinear":
        # Rungs 3 and 4 do the same arithmetic on the same samples.
        assert torch.equal(images[3, True], images[4, True])


def test_the_leap_is_exact_in_nearest_mode_only():
    """A block is empty by its own voxels' minimum and maximum. A nearest
    sample in it is transparent; a trilinear one near its border lerps with
    the next block's voxels and need not be, so in trilinear mode the leap
    can change the image. That is ``volrt``'s behaviour (and the
    reference's), and the port repeats it: on this scene the frames differ
    by 0.045, in both packages alike."""
    import jax

    from volrt.core.view import Camera as JCamera
    from volrt.renderers import batched as j_batched
    from volrt_torch.renderers import batched

    cam = JCamera(dims=(64, 64))
    cam.set_camera_position((30.0, 20.0, 0.0))
    vol = synthetic_volume(32)
    for interp in ("nearest", "trilinear"):
        frames = {}
        for esl in (False, True):
            jrc = j_make_raycaster(JVolume.from_numpy(vol), view=cam.view(),
                                   light_kd=0.0, interpolation=interp,
                                   esl=esl)
            v = jrc.view
            trc = raycaster_from_arrays(
                vol, np.asarray(jrc.transfer_fn), np.asarray(v.origin),
                np.asarray(v.direction), np.asarray(v.right_plane),
                np.asarray(v.up_plane), np.asarray(v.light_pos), v.dims,
                v.perspective, jrc.ray_step, 0.95, 0.0,
                interpolation=interp, esl=esl, device=CPU)
            frames[esl] = batched.render_float(trc)
            if esl:
                # Without jit the JAX rung does the port's operations one
                # by one: equal to the bit.
                with jax.disable_jit():
                    want = np.asarray(j_batched.render_float(jrc))
                np.testing.assert_array_equal(frames[esl].numpy(), want)
        moved = (frames[True] - frames[False]).abs().max().item()
        if interp == "nearest":
            assert moved == 0.0
        else:
            assert 0.04 < moved < 0.05


def test_uint8_frames_match_volrt():
    for interp, rung in (("nearest", 2), ("trilinear", 3), ("trilinear", 4)):
        jrc, trc = _rcs(interp, 0.0, 0.95, True, False)
        want = np.asarray(j_get_renderer(rung).render(jrc)).astype(int)
        got = get_renderer(rung).render(trc)
        assert got.dtype == torch.uint8
        # A value on a quantisation edge may round either way.
        np.testing.assert_allclose(got.numpy().astype(int), want, atol=1,
                                   rtol=0)


def test_wide_volume_takes_rungs_2_and_3():
    """W > 128: the TPU rungs 2-3 refuse it (a VMEM bound); the port's take
    any size. Without ``jit`` the JAX rung 1 does the port's operations one
    by one, and the port's rungs 1, 3 and 4 equal it to the bit; compiled,
    XLA's contraction moves the JAX frames by 4.2e-5 over this scene's 145
    steps a ray, so the JAX rung 4 is held at 1e-4."""
    import jax

    from volrt.renderers import batched as j_batched

    wide = np.concatenate([synthetic_volume(16)] * 9, axis=2)  # W = 144
    jrc, trc = _rcs("trilinear", 0.0, 0.95, True, False, volume=wide)
    with pytest.raises(ValueError, match="128"):
        j_get_renderer(3).render_float(jrc)
    with jax.disable_jit():
        eager = np.asarray(j_batched.render_float(jrc))
    want = np.asarray(j_get_renderer(4).render_float(jrc)[0])
    for rung in (1, 3, 4):
        got = _image(get_renderer(rung).render_float(trc)).numpy()
        np.testing.assert_array_equal(got, eager)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    _, nrc = _rcs("nearest", 0.0, 0.95, True, False, volume=wide)
    torch.testing.assert_close(get_renderer(2).render_float(nrc),
                               get_renderer(1).render_float(nrc),
                               atol=1e-6, rtol=0)


def _ladder_call(trc, rung):
    """``(wrapper, plain, args, kwargs)`` of a kernel rung's march."""
    if rung == 4:
        args, kw = trilinear.ladder_args(trc, trc.volume.data)
        return march.march_blocked, march.march_blocked_plain, args, kw
    args, kw = trilinear.ladder_args(trc, trc.volume.data.float())
    kw["nearest"] = rung == 2
    return march.march_tri, march.march_tri_plain, args, kw


@pytest.mark.parametrize("rung", [2, 3, 4])
def test_march_on_cpu_takes_plain_path(rung, monkeypatch):
    _, trc = _rcs("nearest" if rung == 2 else "trilinear", 0.6, 0.95, True,
                  False)
    fn, plain, args, kw = _ladder_call(trc, rung)
    assert kw["shade"] and not kw["no_ert"]
    got = fn(*args, **kw)
    want = plain(*args, **kw)
    assert fn.launches == 0
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # The rung's image is that march, to the bit.
    img = _image(get_renderer(rung).render_float(trc))
    torch.testing.assert_close(img.reshape(-1, 4), want, atol=0, rtol=0)
    # The plain march's ray chunks are independent of one another.
    monkeypatch.setattr(march, "PLAIN_CHUNK", 100)
    torch.testing.assert_close(plain(*args, **kw), want, atol=0, rtol=0)


def test_shade_false_skips_the_tap():
    _, trc = _rcs("trilinear", 0.6, 0.95, True, False)
    _, unlit = _rcs("trilinear", 0.0, 0.95, True, False)
    for rung in (3, 4):
        mod = get_renderer(rung)
        torch.testing.assert_close(mod.render_float(trc, shade=False)[0],
                                   mod.render_float(unlit)[0], atol=0, rtol=0)
        assert not torch.equal(mod.render_float(trc)[0],
                               mod.render_float(unlit)[0])


def test_division_check_takes_its_plain_version_on_the_cpu():
    """The ladder's division by 255 (``csrc/march_common.cuh:div255``) gives
    the IEEE quotient on a stride of every f32 in [0, 256), in the check's
    plain version; the card runs the check over all of them."""
    top = int(np.float32(256.0).view(np.int32))
    x = torch.arange(0, top, 999_983, dtype=torch.int32).view(torch.float32)
    assert march.div255_mismatches(x) == 0
    with pytest.raises(ValueError):
        march.div255_mismatches(x.double())


@pytest.mark.parametrize("rung", [2, 3, 4])
def test_march_rejects_what_the_kernel_does_not_take(rung):
    _, trc = _rcs("nearest" if rung == 2 else "trilinear", 0.0, 2.0, False,
                  False)
    fn, _, args, kw = _ladder_call(trc, rung)
    assert not kw["shade"] and kw["no_ert"]
    other = args[5].float() if rung == 4 else args[5].to(torch.uint8)
    bad = [
        (0, args[0].double(), TypeError),                    # dtype
        (0, args[0][:-1], ValueError),                       # shape
        (4, args[4].float(), TypeError),                     # alive dtype
        (5, other, TypeError),                               # volume dtype
        (5, args[5].transpose(0, 2), ValueError),            # contiguity
        (5, args[5][0], ValueError),                         # volume rank
        (6, args[6][:64], ValueError),                       # TF shape
        (7, args[7][:5], ValueError),                        # scal shape
        (1, args[1].to("meta"), ValueError),                 # device mix
    ]
    for i, t, exc in bad:
        a = list(args)
        a[i] = t
        with pytest.raises(exc):
            fn(*a, **kw)
    with pytest.raises(ValueError):
        fn(*args, **{**kw, "width": 30})


def test_modes_and_guards():
    _, nrc = _rcs("nearest", 0.0, 0.95, True, False, wh=8)
    _, trc = _rcs("trilinear", 0.0, 0.95, True, False, wh=8)
    for rung in (3, 4, 5):
        with pytest.raises(ValueError, match="trilinear"):
            get_renderer(rung).render_float(nrc)
    for rung in (2, 3, 4):
        rc = nrc if rung == 2 else trc
        with pytest.raises(NotImplementedError, match="phong"):
            get_renderer(rung).render_float(rc.replace(shading="phong"))
    # Rungs 0-1 render phong, in both interpolations, the same frame.
    for rc in (nrc, trc):
        lit = [get_renderer(rung).render_float(rc.replace(shading="phong"))
               for rung in (0, 1)]
        assert torch.isfinite(lit[0]).all()
        torch.testing.assert_close(
            lit[0][..., 3], get_renderer(0).render_float(rc)[..., 3],
            atol=1e-6, rtol=0)
        np.testing.assert_allclose(lit[1].numpy(), lit[0].numpy(), atol=1e-5,
                                   rtol=0)
    with pytest.raises(ValueError):
        get_renderer(-1)
    with pytest.raises(ValueError, match="interpolation"):
        raycaster_from_arrays(
            np.zeros((4, 4, 4), np.uint8), np.zeros((128, 4), np.float32),
            *[[0.0, 0.0, 1.0]] * 5, (4, 4), False, 0.1, 0.95, 0.6,
            interpolation="cubic", device=CPU)


def test_cli_renders_every_rung(tmp_path):
    """``render`` with no ``-r`` is rung 3 with the leap; ``--no-esl`` and
    ``--interpolation`` reach the render state; every rung writes the same
    scene's frame."""
    from volrt.viz import read_png
    from volrt_torch import cli

    seen = {}
    real = cli._make_rc

    def spy(args):
        rc = real(args)
        seen["rc"] = rc
        return rc

    base = ["render", "--synthetic", "16", "-s", "24", "20", "--angles",
            "30", "20", "0", "--device", "cpu"]
    frames = {}
    try:
        cli._make_rc = spy
        for name, extra in {
                "default": [], "r0": ["-r", "0"], "r1": ["-r", "1"],
                "r2": ["-r", "2"], "r3": ["-r", "3"], "r4": ["-r", "4"],
                "r1-tri": ["-r", "1", "--interpolation", "trilinear"],
                "r3-no-esl": ["-r", "3", "--no-esl"]}.items():
            out = str(tmp_path / f"{name}.png")
            assert cli.main(base + extra + ["-o", out]) == 0
            frames[name] = read_png(out)
            rc = seen["rc"]
            assert rc.esl == (name != "r3-no-esl")
            want = ("nearest" if name in ("r0", "r1", "r2") else "trilinear")
            assert rc.interpolation == want, name
    finally:
        cli._make_rc = real
    for name, img in frames.items():
        assert img.shape == (20, 24, 4)
        assert img.max() > 0 and len(np.unique(img)) > 10, name
    np.testing.assert_array_equal(frames["default"], frames["r3"])
    np.testing.assert_array_equal(frames["r3"], frames["r4"])
    np.testing.assert_array_equal(frames["r3"], frames["r3-no-esl"])
    for name in ("r1", "r2"):
        np.testing.assert_allclose(frames[name].astype(int),
                                   frames["r0"].astype(int), atol=1)
    np.testing.assert_allclose(frames["r1-tri"].astype(int),
                               frames["r3"].astype(int), atol=1)
    assert not np.array_equal(frames["r0"], frames["r3"])
