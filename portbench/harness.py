"""The benchmark's machinery, driven by ``BENCHMARK.json`` and by files found
by name under ``portbench/``:

- ``configs/<config>.json``: a configuration (a deployment of the system);
- ``traffic/<cell>.json``: a cell's traffic, whose ``driver`` names
- ``drivers/<driver>.py``: the code that drives one kind of entry point;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``counts/<kernel>.py``: a kernel's operations and bytes.

A later change adds a configuration, a cell, a driver or a metric by adding
such files and entries, without editing one that exists.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# Top-level module names a run may not load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "volrt")


def process_start() -> float:
    """The wall-clock time at which this process started, from the
    kernel's record of it; the time of this call where that is unreadable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


@dataclasses.dataclass
class Window:
    """What the end-to-end readers read of a measured window: the kind of
    call (``"frame"`` or ``"step"``), the calls completed, the window's
    wall seconds, each call's seconds, and a call's rays and samples a ray
    by volrt's accounting (``int(2 / ray_step)``)."""
    call: str
    calls: int
    seconds: float
    times: list
    n_rays: int
    ray_steps: int


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module of its own named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = load_bench(self.root)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(self.root / self.config_entry["file"])
        self.traffic = load_json(self.pkg / "traffic" / f"{name}.json")

    @property
    def pkg(self) -> Path:
        return self.root / "portbench"

    def driver(self):
        kind = self.traffic["driver"]
        return load_module(self.pkg / "drivers" / f"{kind}.py",
                           f"portbench_driver_{kind}")

    def _metrics(self, key: str) -> list[dict]:
        return [m for m in self.bench[key]
                if self.name in m.get("workloads", [self.name])]

    def end_to_end(self) -> list[dict]:
        return self._metrics("end_to_end")

    def per_layer(self) -> list[dict]:
        return self._metrics("per_layer")

    def reader(self, metric: str):
        return load_module(self.pkg / "metrics" / f"{metric}.py",
                           f"portbench_metric_{metric}")


def kernel_counts(root: Path, kernel: str):
    return load_module(Path(root) / "portbench" / "counts" / f"{kernel}.py",
                       f"portbench_counts_{kernel}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, the part before the first
    dot, is one of :data:`FORBIDDEN` as a whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile of ``values``, linear between ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def sync(device) -> None:
    """Wait for ``device`` to finish its queued work (a card; the CPU has
    none queued)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def check_lines(checks: dict) -> list[str]:
    """``checks`` (name -> (value, limit)) as lines for standard error."""
    return [f"check {k}: {v:.9g} limit {lim:.9g} "
            f"{'ok' if v <= lim else 'FAIL'}"
            for k, (v, lim) in checks.items()]


def checks_json(checks: dict) -> dict:
    return {k: {"value": float(v), "limit": float(lim)}
            for k, (v, lim) in checks.items()}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: dict | None = None
                ) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks_json(checks)
    return json.dumps(out)
