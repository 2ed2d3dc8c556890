"""Where a step's time goes on the card: a ``torch.profiler`` trace of a
few steps, summed by kernel name.

    python -m volrt_torch.bench.trace_step --route onepass --steps 10

    python -m volrt_torch.bench.trace_step --route ladder --renderer 4
    python -m volrt_torch.bench.trace_step --route ladder --renderer 3 --cli-look
    python -m volrt_torch.bench.trace_step --route round1 --blocked 1

Routes: ``onepass`` (the one-launch L2 step), ``twokernel`` (forward and
backward kernels under autograd), ``round1`` (the same step through
``render_image_fused(blocked=)``: the ``diff_blocked`` kernel pair, or with
``--blocked 0`` the ``diff_tri`` pair, which takes a volume at most 128
voxels wide), ``fwd`` (``fwd_v3.render_float``) and
``ladder`` (``render_float`` of rung ``--renderer``), each on the
benchmark's scene (``bench/harness.py``); ``--cli-look`` gives the ladder
route the frame ``cli render`` renders by default instead (the camera at
distance 3, diffuse kd 0.6, ERT 0.95, the leading ESL leap, one launch of
``esl_leap_kernel`` a frame); ``--esl`` turns ESL on for the benchmark
scene (rung 5's and the steps' ESL mode, the leap on rungs 2-4). Prints
one JSON object: the
card's name and power limit, device time per step by kernel name, the
window's wall time and the card's idle share in it (one minus device time
over wall time, the host synchronising only at the window's end).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from volrt_torch.bench import harness
from volrt_torch.core.types import Volume, make_raycaster
from volrt_torch.core.view import Camera
from volrt_torch.diff.fused import render_image_fused
from volrt_torch.renderers import diff_v3, get_renderer


def make_step(route: str, volume_size: int, viewport: int,
              device: torch.device, renderer: int = 5,
              cli_look: bool = False, blocked: bool = True,
              esl: bool = False):
    """The benchmark's step for ``route`` as a no-argument callable."""
    if route in ("fwd", "ladder"):
        interp = "nearest" if renderer == 2 else "trilinear"
        if cli_look:
            rc = make_raycaster(
                Volume.from_numpy(harness.synthetic_volume(volume_size),
                                  device),
                Camera(dims=(viewport, viewport)).view(device),
                interpolation=interp)
        else:
            rc = harness.bench_pose(volume_size, viewport, device,
                                    interp).replace(esl=esl)
        render_float = get_renderer(renderer).render_float
        return lambda: render_float(rc)
    scene, view, target = harness.diff_bench_scene(volume_size, viewport,
                                                   device=device)
    if route == "onepass":
        return lambda: diff_v3.l2_loss_grads_v3_onepass(
            scene, view, target, ray_threshold=2.0, esl=esl)

    def two_kernel():
        if route == "round1":
            img = render_image_fused(scene, view, ray_threshold=2.0,
                                     blocked=blocked)
        else:
            img = diff_v3.render_image_v3(scene, view, ray_threshold=2.0,
                                          esl=esl)
        loss = torch.mean((img - target) ** 2)
        return loss, torch.autograd.grad(
            loss, [scene.density, scene.tf_base])

    return two_kernel


def trace(step, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        t_enqueued = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, float(us), e.count))
    device_us = sum(us for _, us, _ in rows)
    if device_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    wall_us = (t1 - t0) * 1e6
    rows.sort(key=lambda r: -r[1])
    return {
        "steps": steps,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "host_enqueue_ms_per_step": (t_enqueued - t0) * 1e3 / steps,
        "device_ms_per_step": device_us / steps / 1e3,
        "idle_share": 1.0 - device_us / wall_us,
        "kernels_per_step": sum(n for _, _, n in rows) / steps,
        "by_name": [{"name": name[:100], "us_per_step": us / steps,
                     "share": us / device_us, "calls_per_step": n / steps}
                    for name, us, n in rows],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--route",
                   choices=("onepass", "twokernel", "round1", "fwd", "ladder"),
                   default="onepass")
    p.add_argument("--blocked", type=int, choices=(0, 1), default=1,
                   help="the round1 route's kernel pair: 1 diff_blocked, "
                   "0 diff_tri")
    p.add_argument("--renderer", type=int, default=4,
                   help="the ladder route's rung (the fwd route is rung 5)")
    p.add_argument("--cli-look", action="store_true",
                   help="the ladder route renders cli render's default "
                   "frame instead of the benchmark pose")
    p.add_argument("--esl", action="store_true",
                   help="ESL on the benchmark scene: rung 5's and the "
                   "steps' sample skipping, the leap on rungs 2-4")
    p.add_argument("--synthetic", type=int, default=256)
    p.add_argument("-s", "--size", type=int, default=1024)
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    renderer = args.renderer if args.route == "ladder" else 5
    out = {"card": smi.stdout.strip().splitlines()[0], "route": args.route,
           "volume": args.synthetic, "viewport": args.size}
    if args.route == "ladder":
        out.update(renderer=renderer, cli_look=args.cli_look)
    if args.route == "round1":
        out.update(blocked=bool(args.blocked))
    if args.esl:
        out.update(esl=True)
    out.update(trace(make_step(args.route, args.synthetic, args.size, device,
                               renderer, args.cli_look, bool(args.blocked),
                               args.esl),
                     args.steps))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
