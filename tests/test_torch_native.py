"""The port's host C++ library (``volrt_torch.native``) against ``volrt``'s
(``volrt.native``, built as in a normal run) and against the port's plain
numpy versions, on the CPU: the real library, no skip.

Every native entry point equals ``volrt``'s to the bit; the plain versions
equal ``volrt``'s numpy paths. The native and numpy quantisers round some
voxels apart by 1 (glibc's ``pow`` against numpy's vectorised ``power``),
in ``volrt`` as in the port, so the loader takes one of them, the native
one, as ``volrt`` does.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_core import one_torch_thread  # noqa: F401
from tests.conftest import ASSET_PATH, synthetic_volume
from tests.test_native import _encode_dds_body
from volrt import native as jnative
from volrt.core import histogram as jhist
from volrt.core import rays as jrays
from volrt.core import types as jtypes
from volrt.io import pvm as jpvm
import volrt_torch
from volrt_torch import _build
from volrt_torch import native
from volrt_torch.core import esl as tesl
from volrt_torch.core import histogram as thist
from volrt_torch.core import rays as trays
from volrt_torch.core import types as ttypes
from volrt_torch.io import pvm as tpvm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _raw16(seed: int, shape: tuple) -> np.ndarray:
    """Seeded big-endian byte pairs ``(D, H, W, 2)``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(*shape, 2), dtype=np.uint8)


def _smooth16(shape: tuple) -> np.ndarray:
    """``tests/test_native.py``'s 16-bit volumes: noise over a ramp."""
    rng = np.random.default_rng(42)
    base = (rng.random(shape) * 60000).astype(np.uint16)
    zz = np.indices(shape).sum(0)
    v16 = ((base // 4) + (zz * 997 % 30000)).astype(np.uint16)
    return np.stack([(v16 >> 8).astype(np.uint8),
                     (v16 & 255).astype(np.uint8)], axis=-1)


def _pvm16(raw16: np.ndarray) -> bytes:
    """A two-component PVM3 payload (16-bit voxels, big-endian)."""
    d, h, w, _ = raw16.shape
    return (b"PVM3\n" + f"{w} {h} {d}\n1 1 1\n2\n".encode()
            + raw16.tobytes() + b"\0" * 4)


@pytest.mark.parametrize("kind", ["raw", "dds pvm"])
def test_sixteen_bit_volume_loads_to_volrts_bytes(tmp_path, monkeypatch,
                                                 kind):
    """The seed-5 (6, 5, 4) input, whose quantisation splits ``volrt``'s
    native and numpy paths in one voxel: the port's ``load_volume`` gives
    the bytes of ``volrt``'s, whose native library is built."""
    raw16 = _raw16(5, (6, 5, 4))
    v16 = raw16[..., 0].astype(np.uint16) * 256 + raw16[..., 1]
    native_q = jnative.quantize16(v16)
    assert native_q is not None, "volrt's native library is not built"
    with monkeypatch.context() as m:
        m.setattr(jnative, "quantize16", lambda *a, **k: None)
        assert (native_q != jpvm.quantize16(raw16)).sum() == 1
    if kind == "raw":
        path = str(tmp_path / "v16.raw")
        raw16.tofile(path)
        kw = dict(raw_dims=(4, 5, 6), raw_components=2)
    else:
        path = str(tmp_path / "v16.pvm")
        tpvm.write_dds(path, _pvm16(raw16), strip=8)
        kw = {}
    got, ginfo = tpvm.load_volume(path, **kw)
    want, winfo = jpvm.load_volume(path, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, native_q)
    assert ginfo == winfo


def _dds_streams():
    with open(ASSET_PATH, "rb") as f:
        asset = f.read()[len(tpvm.DDS_MAGIC_V1):]
    strip1 = [10, 20, 5, 200, 7, 13, 250, 0, 99, 128]
    strip3 = [1, 5, 9, 2, 250, 31, 44, 7, 0, 255, 128, 64]
    rng = np.random.default_rng(3)
    inter = [int(x) for x in rng.integers(0, 256, 103)]
    return {
        "shell32.pvm": (asset, 0),
        "strip 1": (_encode_dds_body(strip1, strip=1), 0),
        "strip 3": (_encode_dds_body(strip3, strip=3), 0),
        # skip > 1: the de-interleave, whole and in chunks of skip * block
        # (v3e's chunks are skip * 2^24 bytes; 5 here, as test_pvm.py does).
        "skip 3": (_encode_dds_body(inter, skip=3, strip=4), 0),
        "skip 3 block 5": (_encode_dds_body(inter, skip=3, strip=4), 5),
        "skip 4 block 7": (_encode_dds_body(inter, skip=4), 7),
        "empty": (_encode_dds_body([]), 0),
    }


@pytest.mark.parametrize("name", list(_dds_streams()))
def test_dds_decode_matches_volrt_and_the_plain_decoder(name):
    body, block = _dds_streams()[name]
    got = native.dds_decode(body, block)
    assert got == jnative.dds_decode(body, block)
    assert got == tpvm.dds_decode(body, block) == jpvm.dds_decode(body,
                                                                   block)
    assert (len(got) == 0) == (name == "empty")


def test_dds_reads_v3e_and_sizes_a_long_output(tmp_path):
    """A v3e container through ``read_dds`` (the blocked interleave at
    v3e's real chunk), a body whose output outgrows the decoder's first
    guess (2 MiB of runs from a 20 KB body: the second call sizes it), and
    a corrupt stream."""
    body = _encode_dds_body(list(range(0, 250, 2)), skip=2)
    path = str(tmp_path / "v3e.dds")
    with open(path, "wb") as f:
        f.write(tpvm.DDS_MAGIC_V2 + body)
    assert tpvm.read_dds(path) == jpvm.read_dds(path) == tpvm.dds_decode(
        body, tpvm.DDS_INTERLEAVE_BLOCK)
    data = np.zeros(2 << 20, np.uint8)
    data[::4096] = np.arange(512) % 251
    long = tpvm.dds_encode(data.tobytes(), strip=1)
    assert len(long) * 4 < (1 << 20) < data.size
    assert native.dds_decode(long) == data.tobytes()
    with pytest.raises(ValueError, match="corrupt"):
        native.dds_decode(b"\x00\x00\xff" + b"\xff" * 5)


QUANT_CASES = {"seed 5 (6, 5, 4)": _raw16(5, (6, 5, 4)),
               "seed 7 (3, 9, 2)": _raw16(7, (3, 9, 2)),
               "smooth (8, 8, 8)": _smooth16((8, 8, 8)),
               "smooth (16, 12, 10)": _smooth16((16, 12, 10)),
               "smooth (1, 1, 7)": _smooth16((1, 1, 7))}


@pytest.mark.parametrize("linear", [False, True], ids=["gradient", "linear"])
@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quantize16_matches_volrt(monkeypatch, case, linear):
    """Native against ``volrt``'s native to the bit, plain against
    ``volrt``'s numpy path to the bit, and native against plain within 1."""
    raw16 = QUANT_CASES[case]
    v16 = tpvm._voxels16(raw16)
    got = native.quantize16(v16, linear=linear)
    np.testing.assert_array_equal(got, jnative.quantize16(v16, linear=linear))
    np.testing.assert_array_equal(tpvm.quantize16(raw16, linear=linear), got)
    plain = tpvm.quantize16_plain(raw16, linear=linear)
    monkeypatch.setattr(jnative, "quantize16", lambda *a, **k: None)
    np.testing.assert_array_equal(plain, jpvm.quantize16(raw16,
                                                         linear=linear))
    assert np.abs(got.astype(int) - plain).max() <= 1
    with pytest.raises(ValueError):
        native.quantize16(v16[0])


def test_histogram_and_compute_histogram():
    vol = synthetic_volume(16, seed=3)
    counts = native.histogram(vol)
    assert counts.dtype == np.int64 and counts.shape == (256,)
    np.testing.assert_array_equal(counts, jnative.histogram(vol))
    np.testing.assert_array_equal(counts, np.bincount(vol.reshape(-1),
                                                      minlength=256))
    for v in (vol, np.zeros((2, 3, 4), np.uint8)):
        got = thist.compute_histogram(v)
        assert got.dtype == np.float32 and got.shape == (256,)
        np.testing.assert_array_equal(got, jhist.compute_histogram(v))


@pytest.mark.parametrize("shape,block", [((17, 23, 9), 8), ((32, 32, 32), 8),
                                         ((5, 3, 2), 8), ((20, 9, 31), 3)])
def test_esl_minmax_matches_volrt_and_the_grid(shape, block):
    """Against ``volrt``'s native scan and the corner of the port's torch
    grid (``build_min_max_grid``, padded to 32^3 with (255, 0)); the
    partial edge blocks cover only their voxels."""
    vol = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                      dtype=np.uint8)
    mn, mx = native.esl_minmax(vol, block)
    want_mn, want_mx = jnative.esl_minmax(vol, block)
    np.testing.assert_array_equal(mn, want_mn)
    np.testing.assert_array_equal(mx, want_mx)
    gd, gh, gw = mn.shape
    assert mn.shape == tuple(-(-n // block) for n in shape)
    grid = tesl.build_min_max_grid(torch.from_numpy(vol), block).numpy()
    np.testing.assert_array_equal(mn, grid[:gd, :gh, :gw, 0])
    np.testing.assert_array_equal(mx, grid[:gd, :gh, :gw, 1])
    edge = vol[(gd - 1) * block:, (gh - 1) * block:, (gw - 1) * block:]
    assert (mn[-1, -1, -1], mx[-1, -1, -1]) == (edge.min(), edge.max())
    with pytest.raises(ValueError):
        native.esl_minmax(vol, 0)


def test_core_helpers_match_volrt():
    for step in (0.06, 2.0 / 255, 0.0107, 1.5):
        for persp in (False, True):
            assert (trays.max_march_steps(step, persp)
                    == jrays.max_march_steps(step, persp))
    for dims in ((32, 32, 32), (256, 256, 256), (7, 300, 64), (1, 1, 2)):
        assert ttypes.ray_step_limits(dims) == jtypes.ray_step_limits(dims)
    assert (volrt_torch.ESL_MIN_BLOCK_SIZE, volrt_torch.ESL_VOLUME_DIMS) == (
        8, 32)


def test_the_library_builds_where_it_should_and_raises_without_g_plus_plus(
        tmp_path, monkeypatch):
    """It lives in ``volrt_torch/build/<hash>/`` (hashed with its flags,
    apart from the CUDA library); four builds into one place at once all
    load; with no compiler, or a source that does not compile, the build
    raises with what the compiler said."""
    assert native.load().volrt_native_abi_version() == 2
    path = _build.native_library_path()
    assert path.parent.parent == _build.BUILD_DIR and path.exists()
    assert path.parent != _build.library_path().parent
    lib = tmp_path / "h" / _build.NATIVE_LIB_NAME
    errors = []

    def build():
        try:
            _build._compile_native(lib)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(_build, "NATIVE_SRC", bad)
    with pytest.raises(RuntimeError, match="error"):
        _build._compile_native(tmp_path / "bad" / "lib.so")
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build._compile_native(tmp_path / "none" / "lib.so")


def test_loading_a_volume_imports_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "from volrt_torch import native\n"
        "from volrt_torch.io import pvm\n"
        "native.load()\n"
        f"data, _ = pvm.load_volume({ASSET_PATH!r})\n"
        "assert data.shape == (32, 32, 32)\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'volrt'))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
