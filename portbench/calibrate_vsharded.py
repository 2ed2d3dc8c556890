#!/usr/bin/env python3
"""The readings that the volume-sharded cell's correctness limits are set
from, over several seeds in one process (rank 0 here, the other ranks
started anew for each seed), as ``calibrate.py`` takes them for the
one-card cells.

    python3 portbench/calibrate_vsharded.py --workload <cell> \
        --seeds 1 2 ... [--control 1 2] [--kinds control halo_dropped ...] \
        [--seconds 1] [--out FILE]
    python3 portbench/calibrate_vsharded.py --workload <cell> \
        --reference-only --seeds 1 [--kinds ...] [--witness 0 2] [--out FILE]

For each seed: the cell's set-up, a short window, then the numbers the
check compares (the lower readings). For each ``--control`` seed also the
control's (the reference with the density stored in bf16, the precision
below the configuration's f32) and each fault's, planted in the reference
put in the program's place (``reference_vsharded.FAULTS``): no opacity
scan, the halo's gradient dropped, half of each view's rays, the state
left unchanged (``--kinds`` picks some). Each seed's readings are a JSON
line on standard output and in ``--out``. The benchmark's runs do not run this.

``--reference-only`` reads the control and the faults alone, on one card
and without the program: the reference of the whole volume, unsharded,
against itself with the control or the fault planted, a JSON line a kind
as each ends. Its leaves are the cell's (the plane rows within
``PLANE_ROWS`` of a plane) and also those with the one row each side of
a plane, the rows that a lost halo fold touches. ``--witness`` names views
whose first step it also takes twice in the reference, its samples on the
whole volume's lattice (``knear + j * step``) and on the slabs' lattices
as the slab kernels place them (``reference_vsharded._slab_lattice``):
the loss and the leaves' gradient norms of each, for the program's
readings on the same inputs to be held to.
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
from portbench import reference_vsharded as rvs  # noqa: E402


def _emit(row: dict, out: str | None) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def reference_only(cell, seed: int, kinds, witness, dev, out) -> None:
    """The gaps of the control and of each fault against the reference of
    the same inputs, on ``dev`` alone (one process, the rays unsplit)."""
    cfg, tr = cell.config, cell.traffic
    n, noise = cfg["volume"]["size"], cfg["volume"]["noise"]
    n_slabs = cell.workload["chips"]
    step = ref.default_ray_step((n, n, n))
    thr = tr["ray_threshold"]
    views = ref.poses(tr["poses"], tuple(tr["viewport"]))
    tf0 = ref.default_tf_base(dev)
    t0 = time.time()
    wanted = sorted({*((0, 1) if kinds else ()), *witness})
    second = rvs.density_rows(n, 0, n, seed, dev, stream=1, noise=noise)
    targets = dict(zip(wanted, rvs.render(second, tf0,
                                          [views[v] for v in wanted],
                                          ray_step=step, thr=thr)))
    del second
    # The cell's leaves, then the one row each side of a plane.
    leaves = rvs.leaf_rows(n, n_slabs) + rvs.leaf_rows(n, n_slabs, 1)[-1:]
    narrow = [*range(n_slabs), n_slabs + 1]
    cell_leaves = [*range(n_slabs), n_slabs]

    def readings(**kw):
        density = rvs.density_rows(n, 0, n, seed, dev, noise=noise)
        got = rvs.first_steps(density, tf0, views[:2],
                              [targets[0], targets[1]], ray_step=step,
                              thr=thr, lr=tr["lr"], n_slabs=n_slabs,
                              points=tr["reference_points"], leaves=leaves,
                              **kw)
        del density
        return got

    def pick(r, idx):
        return {"loss": r["loss"],
                **{k: [r[k][i] for i in idx] + [r[k][-1]]
                   for k in ("grad1", "change")}}

    gaps = cell.driver().gaps
    if kinds:
        want = readings()
        _emit({"seed": seed, "kind": "reference", "s": time.time() - t0,
               "readings": want}, out)
    for kind in kinds:
        got = (readings(rnd=ref.round_bf16) if kind == "control"
               else readings(fault=kind))
        _emit({"seed": seed, "kind": kind, "s": time.time() - t0,
               "gaps": gaps(pick(got, cell_leaves), pick(want, cell_leaves)),
               "gaps_one_row": gaps(pick(got, narrow), pick(want, narrow)),
               "readings": got}, out)
    for v in witness:
        density = rvs.density_rows(n, 0, n, seed, dev, noise=noise)
        r = ref.v3_rays(views[v], dev)
        grad = torch.empty(density.shape, dtype=torch.float32, device=dev)
        for lattice in (False, True):
            grad.zero_()
            loss, d_tf = rvs.march_loss(
                density, tf0, r, targets[v].reshape(-1, 4),
                r["o"].shape[0], ray_step=step, thr=thr,
                points=tr["reference_points"], grad=grad.view(-1),
                n_slabs=n_slabs, slab_lattice=lattice)
            norms = [s ** 0.5 for s in rvs.sq_norms_at(
                grad, 0, rvs.leaf_rows(n, n_slabs))]
            _emit({"seed": seed, "kind": "witness", "view": v,
                   "slab_lattice": lattice, "s": time.time() - t0,
                   "loss": loss, "grad1": norms + [
                       float(torch.linalg.vector_norm(d_tf))]}, out)
        del density, grad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--kinds", nargs="*",
                   default=["control", *rvs.FAULTS],
                   help="the control and faults read on --control seeds")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out")
    p.add_argument("--reference-only", action="store_true")
    p.add_argument("--witness", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    dev = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    if args.reference_only:
        for seed in args.seeds:
            reference_only(cell, seed, args.kinds, args.witness, dev,
                           args.out)
        return 0
    driver = cell.driver()
    rows = []
    for seed in args.seeds:
        t0 = time.time()
        run = driver.Run(cell, seed, dev)
        t1 = time.time()
        win = run.window(args.seconds)
        run.free()
        t2 = time.time()
        checks = run.check(
            controls=args.kinds if seed in args.control else ())
        row = {"workload": cell.name, "seed": seed, "setup_s": t1 - t0,
               "calls": win.calls, "check_s": time.time() - t2,
               "program": {k: v for k, (v, _) in checks.items()}}
        row.update(getattr(run, "calibration", {}))
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del run
        torch.cuda.empty_cache()
    kinds = sorted({k for r in rows for k, v in r.items()
                    if isinstance(v, dict) and k != "program"})
    for name in rows[0]["program"]:
        lows = [r["program"][name] for r in rows]
        ups = {k: min(r[k][name] for r in rows if k in r) for k in kinds}
        print(f"{name}: lower {max(lows):.6g} (over {len(lows)} seeds); "
              + ", ".join(f"{k} {v:.6g}" for k, v in ups.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
