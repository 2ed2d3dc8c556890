"""The port's ``utils/`` (logger, errors, profiler), TF editor helpers and
``viz.read_png`` against ``volrt``'s, on the CPU, from seeded numpy
inputs.

Tolerances: the logger is a copy and is held to the same code; band rays
to 1e-6 (both packages take the same f32 operations; ``volrt``'s test
holds its bands to the full bundle at 1e-6); the stitched OOM image to
1e-6 of the unsplit one (``volrt``'s class); TF edits, PNG bytes and the
profiler's tables exactly; ``editor_alpha_curve`` to 1e-6 (a power in
either package's own order).
"""
import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_core import one_torch_thread  # noqa: F401
from tests.conftest import synthetic_volume
from volrt.core import rays as jrays
from volrt.core import tf as jtf
from volrt.core.view import Camera as JCamera
from volrt.utils import errors as jerrors
from volrt.utils import logger as jlogger
from volrt.utils import profiler as jprof
from volrt import viz as jviz
from volrt_torch import viz as tviz
from volrt_torch.core import rays as trays
from volrt_torch.core import tf as ttf
from volrt_torch.core.types import Volume, make_raycaster
from volrt_torch.core.view import Camera
from volrt_torch.renderers import trilinear
from volrt_torch.utils import errors as terrors
from volrt_torch.utils import logger as tlogger
from volrt_torch.utils import profiler as tprof

CPU = "cpu"


def _code(module) -> str:
    """The module's code without its docstring."""
    tree = ast.parse(inspect.getsource(module))
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))]
    return ast.dump(tree)


def test_logger_is_volrts(tmp_path, capsys):
    assert _code(tlogger) == _code(jlogger)
    path = tmp_path / "s.log"
    log = tlogger.Logger(str(path), mode="w")
    log.log("x %d", 3)
    log.close()
    assert capsys.readouterr().out.splitlines()[1] == "x 3"
    lines = path.read_text().splitlines()
    assert lines[1] == "x 3" and "total runtime" in lines[-1]
    assert tlogger.get_logger() is tlogger.get_logger()


@pytest.mark.parametrize("persp", [False, True])
def test_band_view_rays_match_volrt(persp):
    """Row bands of a 32^2 view: the port's sub-view rays equal
    ``volrt``'s and the full bundle's rows (``tests/test_core.py``'s
    ``test_band_view_rays_exact``, on both packages)."""
    views = []
    for cam_cls, kw in ((JCamera, {}), (Camera, {"device": CPU})):
        cam = cam_cls(dims=(32, 32), perspective=persp)
        cam.toggle_perspective(update_mode=True)
        cam.set_camera_position((30.0, 20.0, 0.0))
        views.append(cam.view(**kw))
    jview, tview = views
    o_full, d_full = trays.get_rays(tview)
    for r0, hb in ((0, 16), (16, 16), (8, 8), (4, 2)):
        jo, jd = jrays.get_rays(jerrors.band_view(jview, r0, hb))
        to, td = trays.get_rays(terrors.band_view(tview, r0, hb))
        assert to.shape == (hb, 32, 3)
        for got, want in ((to, jo), (td, jd), (to, o_full[r0:r0 + hb]),
                          (td, d_full[r0:r0 + hb])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)


def test_oom_fallback_splits_and_stitches():
    """A render that runs out of the card's memory above a band height is
    stitched from row bands and matches the unsplit frame; any other error
    propagates (``tests/test_core.py``'s
    ``test_oom_fallback_splits_and_stitches``)."""
    rc = make_raycaster(Volume.from_numpy(synthetic_volume(16), CPU),
                        view=Camera(dims=(16, 16)).view(CPU),
                        interpolation="trilinear", light_kd=0.0)
    ref, _ = trilinear.render_float(rc)
    calls = []

    def flaky(sub_rc):
        h = sub_rc.view.dims[1]
        calls.append(h)
        if h > 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return trilinear.render_float(sub_rc)

    img, ovf = terrors.render_with_oom_fallback(flaky, rc)
    assert max(calls) == 16 and 4 in calls and ovf == 0.0
    assert img.shape == ref.shape
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-6, rtol=0)

    def broken(sub_rc):
        raise ValueError("not a memory failure")

    with pytest.raises(ValueError, match="memory failure"):
        terrors.render_with_oom_fallback(broken, rc)
    assert terrors.is_oom(torch.cuda.OutOfMemoryError("x"))
    assert terrors.is_oom(RuntimeError("CUDA out of memory. Tried"))
    assert not terrors.is_oom(RuntimeError("CUDA error: illegal address"))
    assert not terrors.is_oom(MemoryError("host"))


def test_safe_call_logs_and_reraises_unless_nosafe(tmp_path):
    log = tlogger.Logger(str(tmp_path / "e.log"), quiet=True)

    def boom():
        raise RuntimeError("frame failed")

    assert terrors.safe_call(lambda: 5) == (5, None)
    res, err = terrors.safe_call(boom, log=log, nosafe=True, what="f1")
    assert res is None and isinstance(err, RuntimeError)
    with pytest.raises(RuntimeError):
        terrors.safe_call(boom, log=log)
    log.close()
    assert "ERROR in f1: frame failed" in (tmp_path / "e.log").read_text()


def _fill(prof, times):
    for (cfg, r), ms in times:
        prof.stats[cfg][r].add(ms)


def test_profiler_tables_match_volrt():
    """The same samples give the same avg, max and samples tables, the
    same roofline table from the same notes, and the same derived
    metrics."""
    rng = np.random.default_rng(7)
    times = [((f"c{i % 3}", f"r{i % 4}"), float(rng.uniform(0.1, 9.0)))
             for i in range(40)]
    j, t = jprof.Profiler(), tprof.Profiler()
    _fill(j, times)
    _fill(t, times)
    for name in ("print_avg", "print_max", "print_samples"):
        assert getattr(t, name)() == getattr(j, name)()
    j.note("c0", "r1", roofline_x=0.25)
    t.note("c0", "r1", roofline_x=0.25)
    assert t.print_roofline().splitlines()[1:] == (
        j.print_roofline().splitlines()[1:])
    assert tprof.MIN_SAMPLE_STAT == jprof.MIN_SAMPLE_STAT
    assert tprof.derived_metrics(2.5, 100, 7) == jprof.derived_metrics(
        2.5, 100, 7)
    for gone in ("print_mfu", "mfu", "chip_peak_flops",
                 "windowed_kernel_flops"):
        assert not hasattr(tprof, gone) and not hasattr(t, gone)
    t.reset()
    assert not t.stats and not t.notes and not t.ring


def test_profiler_waits_for_the_card(monkeypatch):
    """start and stop each synchronise the card (where torch uses one)
    before reading the clock, so a sample is the card's time, not the
    host's enqueue."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("sync"))
    prof = tprof.Profiler()
    prof.start("c", "r")
    assert calls == ["sync"]
    ms = prof.stop()
    assert calls == ["sync", "sync"] and ms >= 0.0
    assert prof.stats["c"]["r"].samples == 1 and prof.ring == [ms]


def test_bound_is_the_one_chip_smoke_uses():
    """The least-time count lives in ``utils/profiler.py``; chip_smoke.py
    imports it and defines no copy."""
    import chip_smoke

    assert chip_smoke.bound is tprof.bound
    src = inspect.getsource(chip_smoke)
    assert "PEAK_F32_FLOPS =" not in src and "FLOPS_FWD =" not in src
    b = tprof.bound(3.35e9, 1e6)
    assert b == {"bound_ms": 1.0, "bound_by": "bytes"}
    b = tprof.bound(0, 67e9)
    assert b == {"bound_ms": 1.0, "bound_by": "operations"}
    # A nominal march of 10 rays x 4 samples at 80 operations, 64 bytes of
    # volume and 160 of image: the bytes' 224 over 3.35 TB/s, above the
    # operations' 3200 over 67 TFLOP/s; 40 rays of 100 samples: those.
    assert tprof.nominal_bound_ms(10, 4, 64, 80) == pytest.approx(
        224 / 3.35e12 * 1e3)
    assert tprof.nominal_bound_ms(40, 100, 64, 80) == pytest.approx(
        320000 / 67e12 * 1e3)
    # A step also reads its target and zero-fills and writes the
    # gradients: 64 + 2 x 640 + 2 x 256 bytes.
    assert tprof.nominal_bound_ms(40, 1, 64, 1, grad_bytes=256) == (
        pytest.approx((64 + 1280 + 512) / 3.35e12 * 1e3))


def test_tf_editor_helpers_match_volrt(tmp_path):
    """(``tests/test_core.py``'s ``test_editor_ops`` and
    ``test_alpha_curve``, ``tests/test_bench_cli.py``'s TF file round
    trip) on a seeded LUT."""
    base = np.random.default_rng(2).uniform(0, 1, (128, 4)).astype(
        np.float32)
    jb, tb = jnp.asarray(base), torch.from_numpy(base)
    np.testing.assert_array_equal(ttf.edit_alpha(tb, 10, 20, 0.5).numpy(),
                                  np.asarray(jtf.edit_alpha(jb, 10, 20, 0.5)))
    np.testing.assert_array_equal(
        ttf.set_colors(tb, 0, 5, (1.0, 0.0, 0.25)).numpy(),
        np.asarray(jtf.set_colors(jb, 0, 5, (1.0, 0.0, 0.25))))
    h = np.array([-0.5, 0.0, 0.3, 0.5, 1.0, 2.0], np.float32)
    np.testing.assert_allclose(
        ttf.editor_alpha_curve(torch.from_numpy(h)).numpy(),
        np.asarray(jtf.editor_alpha_curve(jnp.asarray(h))), atol=1e-6)
    assert tb.equal(torch.from_numpy(base))  # the edits made new LUTs
    for save, load in ((ttf.save_tf, jtf.load_tf),
                       (jtf.save_tf, lambda p: ttf.load_tf(p, CPU))):
        path = str(tmp_path / "tf.npy")
        save(path, tb if save is ttf.save_tf else jb)
        np.testing.assert_array_equal(np.asarray(load(path)), base)


def test_read_png_matches_volrt(tmp_path):
    """``read_png`` reads either package's PNGs as ``volrt``'s does."""
    rng = np.random.default_rng(4)
    for shape in ((5, 7), (5, 7, 3), (5, 7, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for write in (tviz.write_png, jviz.write_png):
            path = str(tmp_path / "x.png")
            write(path, img)
            got = tviz.read_png(path)
            np.testing.assert_array_equal(got, img)
            np.testing.assert_array_equal(got, jviz.read_png(path))
