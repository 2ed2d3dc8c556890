#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this process finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's inputs from the seed, builds the program's objects
and warms up every shape the cell uses. With ``--trace 0`` it then measures
for ``--seconds`` and reports the cell's end-to-end metrics; with
``--trace 1`` it reports the cell's per-layer metrics from a traced window.
Either way it then compares what the timed path produced with the plain
reference (``portbench/reference.py``) and prints each number compared
beside its limit, as the last lines of standard error and under
``checks``, the last key of the result. The result is the last line of
standard output, one JSON object. Without a card, or with fewer cards
than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it exits with another code than 0 and prints no result.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, root: Path = ROOT, device: str = "cuda:0") -> int:
    t_start = harness.process_start()
    args = parse(argv)
    cell = harness.Cell(args.workload, root)
    import torch

    parts = {"start_to_torch": time.time() - t_start}
    on_card = device.startswith("cuda")
    chips = cell.workload["chips"]
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} card(s); this process sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        torch.set_num_threads(1)
        t0 = time.time()
        torch.cuda.init()
        torch.empty(1, device=device)
        parts["cuda_init"] = time.time() - t0
    dev = torch.device(device)
    run = cell.driver().Run(cell, args.seed, dev)
    setup_s = time.time() - t_start
    parts.update(run.parts)

    if args.trace:
        ctx = run.trace(cell.traffic["trace_calls"])
        attempted = 3 * cell.traffic["trace_calls"]
    else:
        win = run.window(args.seconds)
        attempted = win.calls
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    run.free()
    checks = run.check()
    correct = all(v <= lim for v, lim in checks.values())

    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3

    metrics, breakdown = {}, None
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    device_out = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                  "count": chips, "memory_peak_bytes": int(peak)}
    if args.trace:
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = harness.metric(value, m["unit"])
        device_out.update(busy_s=ctx.trace.busy_s,
                          window_s=ctx.trace.window_s)
        breakdown = ctx.trace.breakdown()
    else:
        for m in cell.end_to_end():
            value = (setup_s if m["name"] == "setup_s"
                     else cell.reader(m["name"]).read(win))
            if value is not None:
                metrics[m["name"]] = harness.metric(value, m["unit"])

    print("setup_s " + " ".join(f"{k}={v:.3f}" for k, v in parts.items()),
          file=sys.stderr)
    sys.stderr.flush()
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct, attempted, 0, metrics, device_out,
                              checks, breakdown))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
