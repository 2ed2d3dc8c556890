"""The import guard: a run that loads JAX or the JAX package prints no
result, names are compared whole (``volrt_torch`` is not ``volrt``), and
the reference loads nothing of the program."""
from __future__ import annotations

import subprocess
import sys
import types

from conftest import ROOT
from portbench import harness
from tinybench import run_cell


def test_whole_top_level_names(monkeypatch):
    for name in ("volrt_torch", "volrt_torch.core", "volrtx", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "volrt.core",
                        types.ModuleType("volrt.core"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "volrt"]


def test_a_run_loads_neither(tiny_root, capsys):
    cell = "synth256-viewer.cli4k"
    rc, result, _ = run_cell(tiny_root, cell, capsys)
    assert rc == 0 and result is not None
    assert harness.forbidden_modules() == []


def test_a_run_with_jax_loaded_gives_no_result(tiny_root, capsys,
                                                monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, result, err = run_cell(tiny_root, "synth256-viewer.cli4k", capsys)
    assert rc != 0 and result is None
    assert "jax" in err[-1]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference, portbench.harness, "
            "portbench.peaks, portbench.tracing\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'volrt_torch', 'volrt', 'jax', 'jaxlib', 'flax'}))" % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert res.stdout.strip() == "[]"
