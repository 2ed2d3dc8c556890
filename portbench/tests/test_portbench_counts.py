"""The frozen counts and the trace's reduction against hand counts."""
from __future__ import annotations

import math
import types

import pytest
import torch

from conftest import ROOT
from portbench import harness, peaks, tracing
from portbench import reference as ref


def test_kernel_work_by_hand():
    c = {"taken": 1000, "gated": 100, "skipped": 10}
    fwd = harness.kernel_counts(ROOT, "march_fwd")
    assert fwd.work(c, 64, 4096, 4, True) == (
        1000 * 80 + 100 * 282 + 10 * 15,
        4096 * 4 + 2048 + 32 + 4096 + 64 * (33 + 16))
    tri = harness.kernel_counts(ROOT, "march_tri")
    assert tri.work(c, 64, 4096, 4, True) == (
        1000 * 80, 4096 * 4 + 2048 + 32 + 64 * (33 + 16))
    l2 = harness.kernel_counts(ROOT, "l2_step")
    assert l2.work(c, 64, 4096, 2, False) == (
        1000 * 226 + 100 * 786 + 10 * 30,
        4096 * 6 + 4096 + 32 + 64 * (33 + 32))


def test_least_time_and_roofline():
    assert peaks.least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.roofline_pct([2.0, 2.0], [(67e12, 0), (67e12, 0)]) == \
        pytest.approx(50.0)
    assert peaks.roofline_pct([], [(1, 1)]) is None


def _brute_samples(r, ray_step):
    """Samples each ray of a march without ERT takes, one ray at a time:
    ``k0 + i * step <= kfar`` in f32."""
    n = 0
    for k0, kf, alive in zip(r["k0"].tolist(), r["kfar"].tolist(),
                             r["alive"].tolist()):
        if not alive:
            continue
        i = 0
        while True:
            k = torch.tensor(k0, dtype=torch.float32) + (
                torch.tensor(float(i), dtype=torch.float32)
                * torch.tensor(ray_step, dtype=torch.float32))
            if float(k) > kf:
                break
            n += 1
            i += 1
    return n


def test_reference_counts_samples_by_hand():
    vol = ref.synthetic_volume(16, 5, "cpu")
    tf = ref.premultiply(ref.default_tf_base("cpu"))
    view = ref.pose((45, 45, 0), True, 2.0, (12, 10))
    r = ref.v3_rays(view, "cpu")
    step = ref.default_ray_step((16, 16, 16))
    counts = ref.Counts("cpu")
    ref.march_v3(r, vol.float() / 255.0, tf, ray_step=step, thr=2.0,
                 counts=counts)
    assert counts.as_dict() == {"taken": _brute_samples(r, step),
                                "skipped": 0, "gated": 0}
    # ESL: every sample is taken or skipped.
    counts_esl = ref.Counts("cpu")
    ref.march_v3(r, vol.float() / 255.0, tf, ray_step=step, thr=2.0,
                 esl=ref.esl_empty(vol, tf), counts=counts_esl)
    got = counts_esl.as_dict()
    assert got["taken"] + got["skipped"] == counts.as_dict()["taken"]


def _event(name, start, end, cuda, annotation=False):
    dev = (torch.autograd.DeviceType.CUDA if cuda
           else torch.autograd.DeviceType.CPU)
    return types.SimpleNamespace(
        name=name, device_type=dev, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_trace_reduction_by_hand():
    events = [
        _event(tracing.WINDOW, 0, 1000, False),
        _event("portbench.render_float", 0, 300, False, True),
        _event("portbench.render_float", 0, 1000, True, True),
        _event("aten::fill_", 100, 200, False),
        _event("march_fwd_kernel", 200, 500, True),
        _event("copy", 450, 600, True),
        _event("march_fwd_kernel", 700, 900, True),
    ]
    t = tracing.reduce(events)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(600e-6)
    assert t.launches("march_fwd") == [pytest.approx(300e-6),
                                       pytest.approx(200e-6)]
    gaps = dict(t.idle_gaps)
    assert gaps["aten::fill_"] == pytest.approx(200e-6)
    assert gaps[tracing.OUTSIDE] == pytest.approx(200e-6)
    assert math.isclose(sum(gaps.values()), 400e-6)
    assert t.device_ops[0] == ["march_fwd_kernel", pytest.approx(500e-6)]
