"""A run whose timed path is broken underneath comes out not correct, for
each fault a cell can have; and each cell's control (the reference in the
precision below the configuration's, in the program's place) fails one of
its limits while the program passes them, at a size a test run holds."""
from __future__ import annotations

import torch
import pytest

from portbench import calibrate, harness
from tinybench import run_cell

VIEWER = ["synth256-viewer.phong1024", "synth256-viewer.cli4k"]
FIT = ["synth256-fit.full1024", "synth256-fit.phong1024"]


def alter_answer(monkeypatch):
    """Each march's image, one pixel set to its colour's complement."""
    from volrt_torch.renderers import fwd_v3, trilinear

    for mod, name in ((fwd_v3, "march_fwd"), (trilinear, "march_tri")):
        orig = getattr(mod, name)

        def altered(*a, _orig=orig, **k):
            out = _orig(*a, **k).clone()
            out[out.shape[0] // 2] = 1.0 - out[out.shape[0] // 2]
            return out

        monkeypatch.setattr(mod, name, altered)


def state_unchanged(monkeypatch):
    """The optimiser's step leaves parameters and moments as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def half_batch(monkeypatch):
    """The step kernel marches the first half of the rays only, its
    cotangent the mean over them; the image's other half repeats their
    residuals, so that the loss is their mean too."""
    from volrt_torch.renderers import diff_v3

    orig = diff_v3.l2_step

    def half(o, d, k0, kfar, alive, density, tf, scal, tgt, **kw):
        n = o.shape[0] // 2
        alive = alive.clone()
        alive[n:] = False
        scal = scal.clone()
        scal[6] = scal[6] * 2.0
        out, dd, dt = orig(o, d, k0, kfar, alive, density, tf, scal, tgt,
                           **kw)
        out[n:2 * n] = tgt[n:2 * n] + (out[:n] - tgt[:n])
        return out, dd, dt

    monkeypatch.setattr(diff_v3, "l2_step", half)


@pytest.mark.parametrize("cell,fault", [(c, alter_answer) for c in VIEWER]
                         + [(c, f) for c in FIT
                            for f in (state_unchanged, half_batch)])
def test_a_fault_is_not_correct(tiny_root, capsys, monkeypatch, cell, fault):
    rc, result, err = run_cell(tiny_root, cell, capsys)
    assert rc == 0 and result["correct"] is True
    fault(monkeypatch)
    rc, result, err = run_cell(tiny_root, cell, capsys)
    assert rc == 0 and result["correct"] is False
    assert any(line.endswith("FAIL") for line in err)


@pytest.mark.parametrize("cell", VIEWER + FIT)
def test_the_control_fails_a_limit(tiny_root, cell):
    c = harness.Cell(cell, tiny_root)
    run = c.driver().Run(c, 2**31 + 99, torch.device("cpu"))
    run.window(0.2)
    run.free()
    checks = run.check()
    assert all(v <= lim for v, lim in checks.values())
    ctrl = calibrate.controls(run, True, False)["control"]
    assert any(ctrl[k] > lim for k, (_, lim) in checks.items()), ctrl
