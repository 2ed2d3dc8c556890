"""The benchmark file holds to its contract, every name it uses is found as
a file by that name, and a cell is added by new files and entries alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import ROOT
from portbench import tracing
from tinybench import run_cell, stub_profile

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("key,fields", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contract_keys(key, fields):
    for entry in BENCH[key]:
        assert fields <= set(entry) <= fields | {"workloads"}, entry
        assert NAME.match(entry["name"]), entry["name"]
        for k in ("why", "layer", "source"):
            if k in entry and key in ("configs", "workloads", "per_layer"):
                assert LINE.match(entry[k]), entry[k]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in (
                "lower", "higher")


def test_bounds_cells_and_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(
        cells)
    for w in cells.values():
        assert w["chips"] in (1, 4)
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        shown = [m for m in BENCH["end_to_end"] if w["name"] in
                 m.get("workloads", [w["name"]])]
        assert {m["name"] for m in shown} > {"setup_s"}
        layer = [m for m in BENCH["per_layer"] if w["name"] in
                 m.get("workloads", [w["name"]])]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in {s["name"] for s in shown}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    used = {w["config"] for w in cells.values()}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_every_name_is_found_as_a_file():
    pkg = ROOT / "portbench"
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        tr = json.loads((pkg / "traffic" / f"{w['name']}.json").read_text())
        assert (pkg / "drivers" / f"{tr['driver']}.py").is_file()
        assert (pkg / "counts" / f"{tr['kernel']}.py").is_file()
        assert set(tr["limits"]) >= {"max_abs"} or set(tr["limits"]) >= {
            "loss_gap", "grad1_gap", "change_gap"}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        if m["name"] != "setup_s":
            assert (pkg / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_a_cell_is_added_by_new_files_and_entries(tiny_root, capsys,
                                                  monkeypatch):
    """A dummy configuration, cell and per-layer metric, added as files and
    entries of a copy of the benchmark, run (untraced, and traced with a
    stub trace) without a file edited."""
    pkg = tiny_root / "portbench"
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((pkg / "configs" / "synth256-viewer.json").read_text())
    cfg.update(name="dummy", volume=dict(cfg["volume"], size=12))
    (pkg / "configs" / "dummy.json").write_text(json.dumps(cfg))
    tr = json.loads((pkg / "traffic" / "synth256-viewer.phong1024.json")
                    .read_text())
    tr.update(viewport=[16, 16], shading="phong", esl=False)
    (pkg / "traffic" / "dummy.lowres.json").write_text(json.dumps(tr))
    (pkg / "metrics" / "frames_traced.py").write_text(
        "def read(ctx):\n    return float(len(ctx.host_enqueue_ms))\n")
    bench["configs"].append(dict(bench["configs"][0], name="dummy",
                                 file="portbench/configs/dummy.json"))
    bench["workloads"].append({"name": "dummy.lowres", "config": "dummy",
                               "traffic": "lowres", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if "frames_per_s" == m["name"]:
            m["workloads"].append("dummy.lowres")
    bench["per_layer"].append({
        "name": "frames_traced", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "frames_per_s", "workloads": ["dummy.lowres"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, result, _ = run_cell(tiny_root, "dummy.lowres", capsys)
    assert rc == 0 and result["correct"]
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    monkeypatch.setattr(tracing, "profile_calls", stub_profile)
    rc, result, _ = run_cell(tiny_root, "dummy.lowres", capsys, trace=1)
    assert rc == 0 and result["correct"]
    assert result["metrics"]["frames_traced"] == {"value": 8.0,
                                                  "unit": "frames"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    """The benchmark's files alone, without the program beside them."""
    import subprocess
    import sys

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert "{" not in res.stdout
