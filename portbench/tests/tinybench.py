"""Helpers of the benchmark's CPU tests: the cut to a tiny size, a stub
clock, and one cell run on the CPU."""
from __future__ import annotations

import json
from pathlib import Path

TINY_VOLUME = 16


def shrink(root: Path) -> None:
    """Cut every cell of the benchmark under ``root`` to a 16^3 volume and
    a 32-pixel viewport, with short warm-ups and traced windows."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["volume"]["size"] = TINY_VOLUME
        path.write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        path = root / "portbench" / "traffic" / f"{w['name']}.json"
        tr = json.loads(path.read_text())
        wide = tr["viewport"][0] > tr["viewport"][1]
        tr["viewport"] = [32, 24] if wide else [32, 32]
        tr["trace_calls"] = 8
        if tr["driver"] == "fit":
            tr["warmup_steps"] = 4
            tr["reference_points"] = 1 << 14
        else:
            tr["warmup_cycles"] = 1
        path.write_text(json.dumps(tr))


class FakeClock:
    """A ``time.perf_counter`` that moves ``tick`` seconds a reading."""

    def __init__(self, tick: float = 0.01):
        self.t, self.tick = 1000.0, tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


def run_cell(root: Path, workload: str, capsys, trace: int = 0,
             seconds: float = 0.2, seed: int = 2**31 + 12345):
    """Run one cell on the CPU -> ``(rc, result or None, stderr lines)``."""
    from portbench import run

    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  root=root, device="cpu")
    out, err = capsys.readouterr()
    lines = [x for x in out.splitlines() if x.strip()]
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.splitlines()


def stub_profile(call, n: int):
    """``tracing.profile_calls`` without a profiler, for a CPU run: the
    calls run, and the trace is made up: a window of 1 s, 0.8 s busy, one
    launch of each of the program's march kernels."""
    from portbench import tracing

    for i in range(n):
        call(i)
    kernels = {name: [(float(i), 0.1)] for i, name in enumerate(
        ("march_fwd_kernel", "march_ladder_kernel", "l2_step_kernel"))}
    return tracing.Trace(window_s=1.0, busy_s=0.8,
                         device_ops=[["march_fwd_kernel", 0.8]],
                         idle_gaps=[["portbench.render_float", 0.2]],
                         kernels=kernels)
