#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, over many
seeds in one process (one build, one start of the card).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control 1 2 3 [--fault 1 2 3] [--seconds 1] [--out FILE]

For each seed: the cell's set-up, a short window at its own load, then the
numbers the check compares (the lower readings). For each ``--control``
seed also the control's: the reference put in the program's place in the
nearest precision below the configuration's (a frame: the reference
computed in bf16; a training step: the density's storage rounding fp8 in
place of bf16). For each ``--fault`` seed of a training cell, a fault
planted in the reference put in the program's place: half of each view's
rays left out, the mean taken over the rest. Each seed's readings are a
JSON line on standard output and in ``--out``. The benchmark's runs do not
run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import reference as ref  # noqa: E402


def controls(run, with_control: bool, with_fault: bool) -> dict:
    out = {}
    if run.call == "frame":
        if with_control:
            low = run.ref_frames(list(run.refs), dtype=torch.bfloat16)
            out["control"] = run.frame_gaps(low, run.refs)
        return out
    if with_control:
        out["control"] = run.gaps(run.reference_readings(rnd=ref.round_fp8),
                              run.want)
    if with_fault:
        out["half_batch"] = run.gaps(run.reference_readings(rows=0.5), run.want)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--fault", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    dev = torch.device("cuda:0")
    driver = cell.driver()
    rows = []
    for seed in args.seeds:
        t0 = time.time()
        run = driver.Run(cell, seed, dev)
        t1 = time.time()
        win = run.window(args.seconds)
        run.free()
        t2 = time.time()
        checks = run.check()
        t3 = time.time()
        row = {"workload": cell.name, "seed": seed, "setup_s": t1 - t0,
               "calls": win.calls, "check_s": t3 - t2,
               "program": {k: v for k, (v, _) in checks.items()}}
        row.update(controls(run, seed in args.control, seed in args.fault))
        row["controls_s"] = time.time() - t3
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del run
        torch.cuda.empty_cache()
    for name in rows[0]["program"]:
        lows = [r["program"][name] for r in rows]
        ups = [r[k][name] for r in rows for k in ("control", "half_batch")
               if k in r]
        print(f"{name}: lower {max(lows):.6g} (over {len(lows)} seeds); "
              f"upper {min(ups) if ups else float('nan'):.6g} "
              f"(over {len(ups)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
