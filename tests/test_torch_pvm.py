"""The port's jax-free copy of the volume loader (``volrt_torch.io.pvm``)
against ``volrt.io.pvm``: the same files decode to the same bytes, and what
one package writes the other reads."""
import numpy as np
import pytest

from tests.test_torch_core import one_torch_thread  # noqa: F401
from tests.conftest import ASSET_PATH, synthetic_volume
from volrt.io import pvm as jpvm
from volrt_torch.io import pvm as tpvm

def test_asset_decodes_to_the_same_volume():
    want, winfo = jpvm.load_volume(ASSET_PATH)
    got, ginfo = tpvm.load_volume(ASSET_PATH)
    assert got.dtype == np.uint8 and got.shape == (32, 32, 32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, synthetic_volume(32))
    assert ginfo == winfo
    # The port's native decoder, and its plain numpy one, give the bytes
    # of volrt's (its native one where it is built).
    want = jpvm.read_dds(ASSET_PATH)
    assert tpvm.read_dds(ASSET_PATH) == want
    with open(ASSET_PATH, "rb") as f:
        body = f.read()[len(tpvm.DDS_MAGIC_V1):]
    assert tpvm.dds_decode(body) == want
    assert tpvm.read_dds(ASSET_PATH + ".missing") is None


@pytest.mark.parametrize("dds", [False, True])
@pytest.mark.parametrize("shape", [(5, 7, 9), (16, 12, 20)])
def test_write_read_round_trip(tmp_path, shape, dds):
    rng = np.random.default_rng(sum(shape))
    vol = rng.integers(0, 256, size=shape, dtype=np.uint8)
    vol[1:3] = 7                      # runs, for the DDS zero-width groups
    mine, theirs = str(tmp_path / "t.pvm"), str(tmp_path / "j.pvm")
    meta = dict(scale=(1.0, 0.5, 2.0), description="seeded", comment="c")
    tpvm.write_pvm(mine, vol, dds=dds, **meta)
    jpvm.write_pvm(theirs, vol, dds=dds, **meta)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    for read in (tpvm.read_pvm, jpvm.read_pvm):
        back = read(mine)
        np.testing.assert_array_equal(back.data, vol)
        assert (back.width, back.height, back.depth) == shape[::-1]
        assert back.scale == meta["scale"] and back.description == "seeded"
    assert tpvm.dds_encode(vol.tobytes(), strip=shape[2]) == jpvm.dds_encode(
        vol.tobytes(), strip=shape[2])


@pytest.mark.parametrize("path", ["plain", "native"])
def test_sixteen_bit_quantisation(monkeypatch, path):
    """Each of the port's two quantisers against ``volrt``'s of the same
    kind: the plain one (numpy) against ``volrt``'s numpy path, the native
    one, which the loader takes, against ``volrt``'s native one. On this
    input the two kinds round one voxel in 120 apart, in both packages
    (``tests/test_torch_native.py``)."""
    from volrt import native

    rng = np.random.default_rng(5)
    raw16 = rng.integers(0, 256, size=(6, 5, 4, 2), dtype=np.uint8)
    mine = tpvm.quantize16_plain if path == "plain" else tpvm.quantize16
    if path == "plain":
        monkeypatch.setattr(native, "quantize16", lambda *a, **k: None)
    else:
        assert native.available(), "volrt's native library is not built"
    for linear in (False, True):
        np.testing.assert_array_equal(
            mine(raw16, linear=linear),
            jpvm.quantize16(raw16, linear=linear))


def test_read_raw_and_errors(tmp_path):
    vol = synthetic_volume(8)
    path = str(tmp_path / "v.raw")
    vol.tofile(path)
    np.testing.assert_array_equal(tpvm.read_raw(path, (8, 8, 8)),
                                  jpvm.read_raw(path, (8, 8, 8)))
    data, info = tpvm.load_volume(path, raw_dims=(8, 8, 8))
    np.testing.assert_array_equal(data, vol)
    assert info == jpvm.load_volume(path, raw_dims=(8, 8, 8))[1]
    with pytest.raises(ValueError, match="raw_dims"):
        tpvm.load_volume(path)
    with pytest.raises(ValueError, match="RAW size"):
        tpvm.read_raw(path, (8, 8, 4))
    with pytest.raises(ValueError, match="extension"):
        tpvm.load_volume(str(tmp_path / "v.vol"))
    with pytest.raises(FileNotFoundError):
        tpvm.read_pvm(str(tmp_path / "none.pvm"))
    with pytest.raises(ValueError, match="PVM"):
        tpvm._parse_pvm_payload(b"not a pvm payload")


def test_cli_renders_and_reports_the_asset(tmp_path, capsys):
    import json

    from volrt.viz import read_png
    from volrt_torch import cli

    out = str(tmp_path / "shell.png")
    for rung in ("3", "2"):
        assert cli.main(["render", "-f", ASSET_PATH, "-r", rung, "-s", "24",
                         "24", "--device", "cpu", "-o", out]) == 0
        img = read_png(out)
        assert img.shape == (24, 24, 4)
        assert img[..., 3].max() > 0 and len(np.unique(img)) > 10
    capsys.readouterr()
    assert cli.main(["info", "-f", ASSET_PATH]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["volume"]["shape_zyx"] == [32, 32, 32]
    assert info["volume"]["dims"] == [32, 32, 32]
    vol = synthetic_volume(8)
    raw = str(tmp_path / "v.raw")
    vol.tofile(raw)
    assert cli.main(["render", "-f", raw, "--raw-dims", "8", "8", "8", "-s",
                     "16", "16", "--device", "cpu", "-o", out]) == 0
