"""The port's benchmark suite (``volrt_torch.bench.harness``), its
headline (``python -m volrt_torch.bench``) and the rest of its CLI
(``render --orbit/--background/--nosafe/--log``, ``bench``, ``fit
--log``) against ``volrt``'s, on the CPU.

Configurations, poses and render states must equal ``volrt``'s exactly
(names, fields, view vectors to the bit: the cameras take the same f32
operations); the background composite to the bit; an orbit frame equal to
the bit to a single render at its pose. The suite runs here at 8^3-32^3
and 16^2 (times on the CPU are no device metric; the card's run is
``chip_smoke.py``'s), the CLI in process.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_core import one_torch_thread  # noqa: F401
from tests.conftest import ASSET_PATH
from volrt import cli as jcli
from volrt.bench import harness as jharness
from volrt.core.view import Camera as JCamera
from volrt_torch import cli
from volrt_torch.bench import __main__ as headline
from volrt_torch.bench import harness
from volrt_torch.core.view import Camera
from volrt_torch.renderers import get_renderer
from volrt_torch.utils.logger import Logger
from volrt_torch.viz import read_png

CPU = "cpu"
TINY = [harness.BenchConfig("tiny_8", volume_size=8, viewport=16),
        harness.BenchConfig("tiny_nn", volume_size=8, viewport=16,
                            interpolation="nearest"),
        harness.BenchConfig("tiny_phong", volume_size=8, viewport=16,
                            shading="phong"),
        harness.BenchConfig("shell32", viewport=16, file=ASSET_PATH)]


@pytest.mark.parametrize("small", [False, True])
def test_default_suite_is_volrts(small):
    """Every config of ``volrt``'s suite, in its order and under its name,
    BASELINE config 4 (``phong_esl_256``) and a file's config included."""
    got = harness.default_suite(small=small, files=[ASSET_PATH])
    want = jharness.default_suite(small=small, files=[ASSET_PATH])
    assert [dataclasses.asdict(c) for c in got] == [
        dataclasses.asdict(c) for c in want]
    assert got[0].name == "shell32" and got[0].file == ASSET_PATH
    names = [c.name for c in got]
    assert ("phong_esl_64" if small else "phong_esl_256") in names
    assert harness.BENCH_ANGLES == jharness.BENCH_ANGLES
    assert harness.MAX_BENCH_SAMPLE_MS == jharness.MAX_BENCH_SAMPLE_MS


def test_render_states_and_rungs_are_volrts():
    """``make_raycaster_for`` and ``renderer_fns`` give ``volrt``'s state
    and pick its rungs, config by config."""
    from volrt.core.types import Volume as JVolume
    from volrt_torch.core.types import Volume

    vol = harness.synthetic_volume(8)
    for cfg in [*TINY[:3], harness.BenchConfig("no_optim", 8, esl=False,
                                               ert=False),
                harness.BenchConfig("ray_step_1.7", 8,
                                    ray_step_factor=1.7)]:
        j = jharness.make_raycaster_for(cfg, JVolume.from_numpy(vol))
        t = harness.make_raycaster_for(cfg, Volume.from_numpy(vol, CPU),
                                       device=CPU)
        for f in ("ray_step", "ray_threshold", "esl", "light_kd",
                  "interpolation", "shading", "esl_block_dims"):
            assert getattr(t, f) == pytest.approx(getattr(j, f)), f
        np.testing.assert_array_equal(t.esl_empty.numpy(),
                                      np.asarray(j.esl_empty))
        for f in ("origin", "direction", "right_plane", "up_plane"):
            np.testing.assert_array_equal(getattr(t.view, f).numpy(),
                                          np.asarray(getattr(j.view, f)))
        assert [r for r, _, _ in harness.renderer_fns(t, range(6))] == [
            r for r, _, _ in jharness.renderer_fns(j, list(range(6)))]


def test_run_suite_times_every_cell():
    """The forward suite on the CPU: every rung that applies to a config
    gets ``frames`` samples and a finite roofline note; rung 0 skips the
    file's config, as ``volrt``'s skips heavy ones."""
    prof = harness.run_suite(TINY, renderers=(0, 1, 2, 3, 4, 5), frames=2,
                             logger=Logger(path=None, quiet=True),
                             device=CPU)
    want = {"tiny_8": {"jax-golden", "xla-batched", "pallas-trilinear",
                       "pallas-blocked", "pallas-v3"},
            "tiny_nn": {"jax-golden", "xla-batched", "pallas-nn"},
            "tiny_phong": {"pallas-v3"},
            "shell32": {"xla-batched", "pallas-trilinear", "pallas-blocked",
                        "pallas-v3"}}
    for cfg, rungs in want.items():
        assert set(prof.stats[cfg]) == rungs, cfg
        for r in rungs:
            assert prof.stats[cfg][r].samples == 2
            x = prof.notes[cfg][r]["roofline_x"]
            assert np.isfinite(x) and x > 0
    assert "config,jax-golden,pallas-blocked" in prof.print_avg()
    assert len(prof.print_roofline().splitlines()) == 1 + 1 + len(want)


def test_run_diff_suite_times_the_steps():
    prof = harness.run_diff_suite([(8, 16)], frames=2, device=CPU,
                                  logger=Logger(path=None, quiet=True))
    cell = prof.stats["diff_8_16"]
    assert set(cell) == {"fused-v3", "fused-onepass"}
    assert all(s.samples == 2 for s in cell.values())
    assert np.isfinite(prof.notes["diff_8_16"]["fused-onepass"][
        "roofline_x"])
    plain = harness.run_diff_suite([(8, 16)], frames=2, fused=False,
                                   device=CPU)
    assert set(plain.stats["diff_8_16"]) == {"plain-diff"}


def test_cli_bench_writes_the_tables(tmp_path, monkeypatch, capsys):
    """``cli bench`` with ``volrt``'s flags: ``-f`` adds the file's config
    to the suite, ``--diff`` the steps, ``-o`` the CSV of the four tables.
    The configs are shrunk to ``TINY`` and the steps to 8^3 / 16^2 for
    the CPU."""
    seen = {}

    def suite(small=False, files=None):
        seen["suite"] = (small, files)
        return [c for c in TINY if c.file is None] + [
            dataclasses.replace(TINY[-1], name=os.path.splitext(
                os.path.basename(f))[0], file=f) for f in files or []]

    diff = harness.run_diff_suite

    def diff_suite(configs=None, **kw):
        seen["diff"] = configs
        return diff(configs=[(8, 16)], **kw)

    monkeypatch.setattr(harness, "default_suite", suite)
    monkeypatch.setattr(harness, "run_diff_suite", diff_suite)
    csv = str(tmp_path / "r.csv")
    log = str(tmp_path / "b.log")
    assert cli.main(["bench", "--small", "--frames", "2", "--renderers",
                     "2", "3", "4", "5", "--diff", "-o", csv, "-f",
                     ASSET_PATH, "--device", CPU, "--log", log]) == 0
    assert seen == {"suite": (True, [ASSET_PATH]),
                    "diff": [(64, 256), (128, 512)]}
    tables = open(csv).read().strip().split("\n\n")
    assert [t.splitlines()[0] for t in tables] == [
        "average ms:", "max ms:", "samples:",
        tables[3].splitlines()[0]]
    assert tables[3].startswith("nominal_roofline_x")
    avg = {row.split(",")[0]: row.split(",")[1:]
           for row in tables[0].splitlines()[2:]}
    assert set(avg) == {"tiny_8", "tiny_nn", "tiny_phong", "shell32",
                        "diff_8_16"}
    assert "average ms:" in open(log).read()
    assert "average ms:" in capsys.readouterr().out
    # bench --sharded times render_float_sharded's ranks on the card
    # (chip_smoke.py phase 21) and refuses the CPU, as the headline does.
    with pytest.raises(ValueError, match="CUDA"):
        cli.main(["bench", "--sharded", "--device", CPU])


def test_headline_prints_the_old_keys(monkeypatch, capsys):
    """``python -m volrt_torch.bench`` prints the line ``cli bench`` did,
    under root ``bench.py``'s key names (a stub timer here)."""
    step = dict(ms=2.0, ms_p90=2.5, loss=0.5, ray_steps_per_s=3e9,
                device="stub", precision="f32")
    monkeypatch.setattr(harness, "bench_diff_step", lambda *a, **k: step)
    monkeypatch.setattr(harness, "bench_fwd_step", lambda *a, **k: dict(
        ms=1.0, ray_steps_per_s=6e9))
    assert headline.main(["--iters", "3", "--device", CPU]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "ms", "ms_p90", "loss",
                         "fwd_ms", "fwd_ray_steps_per_s", "iters", "device",
                         "precision"}
    assert line["metric"] == "diff_fwd_bwd_ray_steps_per_s"
    assert line["value"] == 3e9 and line["fwd_ms"] == 1.0


def test_background_composite_is_volrts():
    img = np.random.default_rng(9).integers(0, 256, (9, 11, 4),
                                            dtype=np.uint8)
    for bg in (0.0, 0.2, 0.25, 1.0):
        np.testing.assert_array_equal(cli._composite_bg(img, bg),
                                      jcli._composite_bg(img, bg))


def test_cli_render_orbit(tmp_path, capsys):
    """``render --orbit 3 --background 0.2 --log``: three frames
    ``<base>_%04d.png``, each equal to the bit to a single render at its
    pose, the poses ``volrt``'s camera takes; the session in the log."""
    out, log = str(tmp_path / "orb.png"), str(tmp_path / "r.log")
    argv = ["render", "-f", ASSET_PATH, "-s", "16", "16", "--orbit", "3",
            "--background", "0.2", "--device", CPU]
    assert cli.main(argv + ["-o", out, "--log", log]) == 0
    assert "frame 3/3" in open(log).read()
    assert "frame 3/3" in capsys.readouterr().out
    rc = cli._make_rc(cli.parser().parse_args(argv + ["-o", out]))
    cam, jcam = Camera(dims=(16, 16)), JCamera(dims=(16, 16))
    for c in (cam, jcam):
        c.toggle_perspective(update_mode=True)
        c.set_camera_position((0.0, 0.0, 0.0), 3.0)
    quiet = Logger(path=None, quiet=True)
    for i in range(3):
        view, jview = cam.view(CPU), jcam.view()
        np.testing.assert_array_equal(view.origin.numpy(),
                                      np.asarray(jview.origin))
        np.testing.assert_array_equal(view.up_plane.numpy(),
                                      np.asarray(jview.up_plane))
        want = cli._composite_bg(cli._render_frame(
            get_renderer(3), rc.replace(view=view), quiet), 0.2)
        got = read_png(str(tmp_path / f"orb_{i:04d}.png"))[::-1]
        np.testing.assert_array_equal(got, want)
        cam.rotate((0.0, 120.0, 0.0))
        jcam.rotate((0.0, 120.0, 0.0))


def test_cli_render_nosafe_continues_past_a_failed_frame(tmp_path,
                                                          monkeypatch):
    frame = cli._render_frame
    calls = []

    def flaky(mod, rc, log):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("frame failed")
        return frame(mod, rc, log)

    monkeypatch.setattr(cli, "_render_frame", flaky)
    out = str(tmp_path / "o.png")
    argv = ["render", "--synthetic", "8", "-s", "8", "8", "--orbit", "3",
            "--device", CPU, "-o", out]
    assert cli.main(argv + ["--nosafe"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["o_0000.png", "o_0002.png"]
    calls.clear()
    with pytest.raises(RuntimeError, match="frame failed"):
        cli.main(argv)


def test_cli_fit_log(tmp_path, capsys):
    log = str(tmp_path / "f.log")
    assert cli.main(["fit", "--synthetic", "8", "-s", "8", "8", "--steps",
                     "2", "--device", CPU, "--log", log]) == 0
    text = open(log).read()
    assert "fit step 1" in text and "final loss" in text
    assert "fit step 1" in capsys.readouterr().out

