"""The last line of a run: its keys, units and checks, the checks again as
the last lines of standard error; with a stub clock, so that the window
closes after a known number of calls."""
from __future__ import annotations

import json
import time

import pytest

from conftest import ROOT
from portbench import tracing
from tinybench import FakeClock, run_cell, stub_profile

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def shown(cell: str, key: str) -> dict:
    return {m["name"]: m["unit"] for m in BENCH[key]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_line(tiny_root, capsys, monkeypatch, cell):
    monkeypatch.setattr(time, "perf_counter", FakeClock(0.25))
    rc, res, err = run_cell(tiny_root, cell, capsys, seconds=1.0)
    assert rc == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    # The stub clock moves 0.25 s a reading; a training step reads it once,
    # a frame twice (its end, and the next one's start): a window of 1 s
    # holds 4 steps or 2 frames.
    fit = "frame_ms_p95" not in shown(cell, "end_to_end")
    assert res["attempted"] == (4 if fit else 2)
    assert {k: v["unit"] for k, v in res["metrics"].items()} == shown(
        cell, "end_to_end")
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    checks = res["checks"]
    assert checks and all(set(c) == {"value", "limit"}
                          for c in checks.values())
    tail = err[-len(checks):]
    assert [x.split(":")[0] for x in tail] == [f"check {k}" for k in checks]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(tiny_root, capsys, monkeypatch, cell):
    monkeypatch.setattr(tracing, "profile_calls", stub_profile)
    rc, res, _ = run_cell(tiny_root, cell, capsys, trace=1)
    assert rc == 0 and res["correct"] is True
    assert {k: v["unit"] for k, v in res["metrics"].items()} == shown(
        cell, "per_layer")
    assert res["device"]["busy_s"] == 0.8 and res["device"]["window_s"] == 1.0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    idle = [k for k in res["metrics"] if k.startswith("device_idle_pct")]
    assert [res["metrics"][k]["value"] for k in idle] == [pytest.approx(20.0)]
    for k, v in res["metrics"].items():
        if k.endswith("_roofline"):
            assert 0.0 < v["value"] <= 100.0
