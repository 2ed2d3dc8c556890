"""The readers of the program's spans: in a traced run on the CPU, under a
CPU profiler, the host's milliseconds read from the spans of the window's
first pass; the stream's are absent (the CPU records no stream events),
and so is every one of them where the program has no spans."""
from __future__ import annotations

import json
import sys

import pytest

from conftest import ROOT
from portbench import tracing
from tinybench import run_cell, stub_profile

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPANS = ("ray_setup", "volume_copy", "optimizer")
READERS = [m for m in BENCH["per_layer"]
           if m["name"].split("_ms.")[0].rsplit("_", 1)[0] in SPANS]


def profile_on_cpu(call, n: int):
    """``tracing.profile_calls`` on the CPU: two passes of the calls, each
    under a CPU profiler as the window's two passes are under theirs, and
    ``stub_profile``'s trace."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            for i in range(n):
                call(i)
    return stub_profile(lambda i: None, n)


@pytest.fixture
def no_records():
    from volrt_torch.utils import trace

    trace.clear()
    yield trace
    trace.clear()


def test_the_eight_span_readers():
    assert sorted(m["name"] for m in READERS) == sorted(
        f"{s}_{side}_ms.{kind}" for s, side, kind in [
            ("ray_setup", "stream", "view"), ("ray_setup", "host", "view"),
            ("volume_copy", "stream", "view"), ("ray_setup", "stream", "fit"),
            ("ray_setup", "host", "fit"), ("volume_copy", "stream", "fit"),
            ("optimizer", "stream", "fit"), ("optimizer", "host", "fit")])
    for m in READERS:
        assert m["unit"] == "ms" and m["better"] == "lower"
        assert m["source"] == ("host_clock" if "_host_" in m["name"]
                               else "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_host_ms_from_the_spans_and_no_stream_ms_on_the_cpu(
        tiny_root, capsys, monkeypatch, no_records, cell):
    monkeypatch.setattr(tracing, "profile_calls", profile_on_cpu)
    rc, result, _ = run_cell(tiny_root, cell, capsys, trace=1)
    assert rc == 0 and result["correct"]
    mine = [m["name"] for m in READERS if cell in m["workloads"]]
    assert len(mine) == (3 if "viewer" in cell else 5)
    for name in mine:
        if "_host_ms." in name:
            assert result["metrics"][name]["value"] > 0.0, name
            assert result["metrics"][name]["unit"] == "ms"
        else:
            assert name not in result["metrics"], name
    # Both passes recorded; each call of the first recorded one ray setup.
    assert no_records.summary()["volrt_torch.ray_setup"].calls == 16
    first = no_records.summary(no_records.call_ids()[:8])
    assert first["volrt_torch.ray_setup"].calls == 8
    assert first["volrt_torch.ray_setup"].spans == 8


def test_calls_profiled_before_the_window_are_left_out(
        tiny_root, capsys, monkeypatch, no_records):
    """A profiler that records before the window (here one long ray
    setup of a call of its own) adds nothing to what the readers read:
    they read the first of the window's two passes, the last calls
    recorded."""
    import time

    from torch.profiler import ProfilerActivity, profile

    def stale_then_window(call, n: int):
        with profile(activities=[ProfilerActivity.CPU]):
            with no_records.span("ray_setup", rays=1):
                time.sleep(0.2)
        return profile_on_cpu(call, n)

    monkeypatch.setattr(tracing, "profile_calls", stale_then_window)
    rc, result, _ = run_cell(tiny_root, "synth256-fit.full1024", capsys,
                             trace=1)
    assert rc == 0 and result["correct"]
    ids = no_records.call_ids()
    assert len(ids) == 1 + 16
    read = result["metrics"]["ray_setup_host_ms.fit"]["value"]
    first = no_records.summary(ids[1:9])["volrt_torch.ray_setup"]
    assert read == pytest.approx(first.host_ms) and read < 200.0 / 8


def test_a_program_without_spans_reads_nothing(tiny_root, capsys,
                                               monkeypatch, no_records):
    """The parent's program has no ``volrt_torch.utils.trace``: each
    reader returns None and the run reports the metrics it had."""
    monkeypatch.setattr(tracing, "profile_calls", profile_on_cpu)
    import volrt_torch.utils

    monkeypatch.delattr(volrt_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "volrt_torch.utils.trace", None)
    cell = "synth256-fit.full1024"
    rc, result, _ = run_cell(tiny_root, cell, capsys, trace=1)
    assert rc == 0 and result["correct"]
    assert not {m["name"] for m in READERS} & set(result["metrics"])
    assert "host_enqueue_ms_per_step" in result["metrics"]
