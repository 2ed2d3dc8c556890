"""The port's core modules (``volrt_torch.core``) against ``volrt.core``.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU. Tolerances: 1e-6 where the two compute the same f32
ops in the same order (ray setup, sampling), exact where nothing rounds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import volrt.constants as jc
import volrt_torch.constants as tc
from volrt.core import rays as jrays
from volrt.core import sampling as jsampling
from volrt.core import tf as jtf
from volrt.core import types as jtypes
from volrt.core import view as jview
from volrt_torch.core import rays as trays
from volrt_torch.core import sampling as tsampling
from volrt_torch.core import tf as ttf
from volrt_torch.core import types as ttypes
from volrt_torch.core import view as tview

ATOL = 1e-6
# The port's entry points default to the card; the tests ask for the CPU.
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for each test module of the port (every
    ``tests/test_torch_*.py`` imports this fixture). The suite runs six
    worker processes on eight cores, and torch's default of a thread a
    core makes each of its OpenMP regions wait for threads that other
    workers hold: ``march_fwd_plain`` over 577,649 one-sample rays took
    55.0 s on eight threads beside ten busy processes and 5.3 s on one
    (1.4 s on eight threads alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_constants_are_volrts():
    names = [n for n in dir(jc) if n.isupper()]
    assert names == [n for n in dir(tc) if n.isupper()]
    for n in names:
        assert getattr(tc, n) == getattr(jc, n), n


def test_default_tf_and_premultiply():
    base = ttf.default_transfer_fn(CPU)
    np.testing.assert_array_equal(_np(base), _np(jtf.default_transfer_fn()))
    rng = np.random.default_rng(3)
    tf = rng.uniform(0, 1, (tc.TF_SIZE, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(ttf.premultiply(torch.from_numpy(tf))),
        _np(jtf.premultiply(jnp.asarray(tf))))


def test_load_tf(tmp_path):
    path = str(tmp_path / "tf.npy")
    tf = np.random.default_rng(4).uniform(0, 1, (tc.TF_SIZE, 4))
    jtf.save_tf(path, tf)
    np.testing.assert_array_equal(_np(ttf.load_tf(path, CPU)),
                                  _np(jtf.load_tf(path)))
    np.save(path, tf[:5])
    with pytest.raises(ValueError):
        ttf.load_tf(path, CPU)


@pytest.mark.parametrize("dims", [(16, 16, 16), (32, 24, 20), (256, 256, 256)])
def test_default_ray_step(dims):
    assert ttypes.default_ray_step(dims) == jtypes.default_ray_step(dims)


@pytest.mark.parametrize("persp", [False, True])
@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (30.0, 20.0, 0.0),
                                    (-45.0, 135.0, 10.0)])
def test_camera_view(angles, persp):
    views = []
    for mod in (jview, tview):
        cam = mod.Camera(dims=(40, 24), perspective=persp)
        cam.toggle_perspective(update_mode=True)
        cam.set_camera_position(angles, 2.5)
        views.append(cam.view(CPU) if mod is tview else cam.view())
    jv, tv = views
    for f in ("origin", "direction", "right_plane", "up_plane", "light_pos"):
        np.testing.assert_array_equal(_np(getattr(tv, f)),
                                      _np(getattr(jv, f)), err_msg=f)
    assert (tv.dims, tv.perspective) == (jv.dims, jv.perspective)


def test_default_view_and_zoom():
    np.testing.assert_array_equal(_np(ttypes.View.default(CPU).right_plane),
                                  _np(jtypes.View.default().right_plane))
    jcam, tcam = jview.Camera(dims=(64, 64)), tview.Camera(dims=(64, 64))
    jcam.zoom(-1.0)
    tcam.zoom(-1.0)
    np.testing.assert_array_equal(_np(tcam.view(CPU).up_plane),
                                  _np(jcam.view().up_plane))


@pytest.mark.parametrize("persp", [False, True])
@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (30.0, 20.0, 0.0)])
def test_get_rays_and_intersect(angles, persp):
    jcam = jview.Camera(dims=(33, 20), perspective=persp)
    jcam.toggle_perspective(update_mode=True)
    jcam.set_camera_position(angles)
    jv = jcam.view()
    tv = ttypes.View.from_arrays(
        _np(jv.origin), _np(jv.direction), _np(jv.right_plane),
        _np(jv.up_plane), _np(jv.light_pos), jv.dims, jv.perspective, CPU)
    jo, jd = jrays.get_rays(jv)
    to, td = trays.get_rays(tv)
    assert to.shape == (20, 33, 3)
    np.testing.assert_allclose(_np(to), _np(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(td), _np(jd), atol=ATOL, rtol=0)
    jk = jrays.intersect_aabb(jo, jd)
    tk = trays.intersect_aabb(to, td)
    for a, b in zip(tk, jk):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL, rtol=0)
    assert _np(tk[2]).any() and not _np(tk[2]).all()


def test_intersect_zero_directions_and_inside_origins():
    rng = np.random.default_rng(5)
    o = rng.uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    o[:100] = rng.uniform(-0.9, 0.9, (100, 3))          # inside the cube
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d[::3, 0] = 0.0                                     # axis-parallel rays
    d[::5, 1] = 0.0
    d[::7] = 0.0                                        # no direction at all
    jk = jrays.intersect_aabb(jnp.asarray(o), jnp.asarray(d))
    tk = trays.intersect_aabb(torch.from_numpy(o), torch.from_numpy(d))
    for a, b in zip(tk, jk):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL, rtol=1e-6)
    assert (_np(tk[0]) >= 0.0).all()
    assert _np(tk[2])[:100].all()


def _positions(rng, n):
    """World positions inside, on and beyond the cube's faces, so that the
    clamped border taps are exercised on every axis."""
    p = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    p[: n // 4, 0] = rng.choice([-1.0, 1.0, -1.05, 1.05], n // 4)
    p[n // 4: n // 2, 2] = rng.choice([-1.0, 1.0], n // 2 - n // 4)
    return p


def test_sample_trilinear_f():
    rng = np.random.default_rng(6)
    grid = rng.uniform(0, 1, (12, 10, 14)).astype(np.float32)
    pos = _positions(rng, 4096)
    want = jsampling.sample_trilinear_f(jnp.asarray(grid), jnp.asarray(pos))
    got = tsampling.sample_trilinear_f(torch.from_numpy(grid),
                                       torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    # Beyond a face the sample is the border voxel's (clamp addressing).
    far = torch.tensor([[-3.0, -3.0, -3.0], [3.0, 3.0, 3.0]])
    got = tsampling.sample_trilinear_f(torch.from_numpy(grid), far)
    np.testing.assert_allclose(_np(got), [grid[0, 0, 0], grid[-1, -1, -1]],
                               atol=ATOL)


def test_tf_lookup_linear():
    rng = np.random.default_rng(7)
    tf = rng.uniform(0, 1, (tc.TF_SIZE, 4)).astype(np.float32)
    s = rng.uniform(0, 1, 4096).astype(np.float32)
    s[:6] = [0.0, 1.0, 0.5 / 128, 1 - 0.5 / 128, 1e-4, 0.9999]
    want = jsampling.tf_lookup_linear(jnp.asarray(tf), jnp.asarray(s))
    got = tsampling.tf_lookup_linear(torch.from_numpy(tf), torch.from_numpy(s))
    assert got.shape == (4096, 4)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


def test_map_float_int_and_write_color():
    rng = np.random.default_rng(8)
    c = rng.uniform(-0.2, 1.2, (64, 4)).astype(np.float32)
    c[0] = [0.0, 1.0, 255.5 / 256, 1.0 / 256]
    np.testing.assert_array_equal(
        _np(tsampling.map_float_int(torch.from_numpy(c), 128)),
        _np(jsampling.map_float_int(jnp.asarray(c), 128)))
    got = tsampling.write_color(torch.from_numpy(c))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        _np(got), _np(jsampling.write_color(jnp.asarray(c))))


def test_volume_and_make_raycaster():
    from tests.conftest import synthetic_volume

    vol = synthetic_volume(16)
    tvol = ttypes.Volume.from_numpy(vol[:, :12, :10], CPU)
    assert tvol.dims == (10, 12, 16) and tvol.data.dtype == torch.uint8
    with pytest.raises(ValueError):
        ttypes.Volume.from_numpy(vol[0], CPU)
    jrc = jtypes.make_raycaster(jtypes.Volume.from_numpy(vol))
    trc = ttypes.make_raycaster(ttypes.Volume.from_numpy(vol, CPU))
    np.testing.assert_array_equal(_np(trc.transfer_fn), _np(jrc.transfer_fn))
    assert trc.ray_step == jrc.ray_step
    assert trc.ray_threshold == pytest.approx(float(jrc.ray_threshold))
    assert trc.light_kd == pytest.approx(float(jrc.light_kd))
    assert (trc.esl, trc.shading, trc.view.dims) == (
        jrc.esl, jrc.shading, jrc.view.dims)
    assert trc.device == torch.device("cpu")


def test_entry_points_default_to_the_card():
    """With no ``device`` every constructor resolves to ``cuda:0``, with no
    probing and no fallback: where torch has no CUDA the call raises from
    torch itself instead of quietly building on the CPU."""
    from volrt_torch.core.device import default_device, resolve_device
    from volrt_torch.diff.render import scene_from_arrays, scene_from_volume

    assert default_device() == torch.device("cuda", 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert ttypes.View.default().origin.device == default_device()
        return
    vol = np.zeros((4, 4, 4), np.uint8)
    tf = np.zeros((tc.TF_SIZE, 4), np.float32)
    calls = [
        lambda: ttypes.Volume.from_numpy(vol),
        lambda: ttypes.View.default(),
        lambda: ttypes.View.from_arrays(*[[0.0, 0.0, 1.0]] * 5, (4, 4), False),
        lambda: tview.Camera(dims=(4, 4)).view(),
        lambda: ttf.default_transfer_fn(),
        lambda: ttypes.raycaster_from_arrays(
            vol, tf, *[[0.0, 0.0, 1.0]] * 5, (4, 4), False, 0.1, 0.95, 0.6),
        lambda: scene_from_volume(vol, tf, 0.1),
        lambda: scene_from_arrays(vol.astype(np.float32), tf, 0.1),
    ]
    for call in calls:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
            call()
