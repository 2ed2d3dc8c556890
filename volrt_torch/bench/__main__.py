"""The port's headline line (the counterpart of ``volrt``'s root
``bench.py``): the one-launch L2 step and the forward render at 256^3 /
1024^2, one JSON line under ``bench.py``'s key names.

    python -m volrt_torch.bench [--synthetic 256] [-s 1024] [--iters 20]
        [--fast]

No ``mfu`` and no ``vs_baseline``: both are defined against a TPU. Times a
CUDA device and refuses the CPU. ``--fast`` times both in ``volrt``'s fast
mode (the density as bf16: the kernels' bf16 instances), which is what
``volrt``'s ``bench.py`` times; without it f32, the port's recorded
figures. ``precision`` says which. The suite is ``python -m
volrt_torch.cli bench``.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m volrt_torch.bench",
        description="time the L2 step and the forward render; prints one "
        "JSON line")
    p.add_argument("--synthetic", type=int, default=256,
                   help="synthetic volume size")
    p.add_argument("-s", "--size", type=int, default=1024,
                   help="viewport edge")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="a CUDA device; the bench refuses the CPU")
    p.add_argument("--fast", action="store_true",
                   help="volrt's fast mode (bf16 density), as volrt's "
                   "bench.py times it; f32 without")
    args = p.parse_args(argv)

    from volrt_torch.bench.harness import bench_diff_step, bench_fwd_step

    m = bench_diff_step(args.synthetic, args.size, iters=args.iters,
                        fused=True, onepass=True, device=args.device,
                        fast=args.fast)
    f = bench_fwd_step(args.synthetic, args.size, iters=args.iters,
                       device=args.device, fast=args.fast)
    print(json.dumps({
        "metric": "diff_fwd_bwd_ray_steps_per_s",
        "value": m["ray_steps_per_s"],
        "unit": "rays*steps/s",
        "ms": m["ms"],
        "ms_p90": m["ms_p90"],
        "loss": m["loss"],
        "fwd_ms": f["ms"],
        "fwd_ray_steps_per_s": f["ray_steps_per_s"],
        "iters": args.iters,
        "device": m["device"],
        "precision": m["precision"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
