"""Where a step's time goes on the card: a ``torch.profiler`` trace of a
few steps, the device's busy time in it and the program's spans
(``volrt_torch.utils.trace``) of each step.

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
one JSON object: the card's name and power limit; per step, the window's
wall time, the host's enqueue, the device's busy time (the union of its
operations in time) and the card's idle share in the window (the host
synchronising only at the window's end); the launches per step of the
march wrappers, the leap, the ray setup and the update (their counters);
and each span's host ms, stream ms (its device stages'), work and count
per step.
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
from volrt_torch.renderers.cuda import leap, march, rays
from volrt_torch.train import adam


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


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals: the time in
    which any of them ran, overlapping ones counted once."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy if cur_e is None else busy + cur_e - cur_s


def launches() -> dict[str, int]:
    """The march wrappers', the leap's, the ray setup's and the update's
    launch counters as they stand (``renderers/cuda/march.py``,
    ``leap.py``, ``rays.py``, ``train/adam.py``)."""
    fns = (march.march_fwd, march.march_bwd, march.l2_step, march.march_tri,
           march.march_blocked, leap.esl_start, rays.ray_setup,
           adam.adam_step)
    return {fn.__name__: fn.launches for fn in fns}


def trace(step, steps: int) -> dict:
    """Trace ``steps`` calls of ``step`` after two untraced ones: the
    profiler records the device alone, so the host runs near its untraced
    speed, and each call is one top-level span that the program's spans
    nest in."""
    from torch.profiler import ProfilerActivity, profile

    from volrt_torch.utils import trace as spans

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    spans.clear()
    before = launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with spans.span("step"):
                step()
        t_enqueued = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    device = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    busy_ms = busy_us(device) / 1e3
    wall_ms = (t1 - t0) * 1e3
    launched = {k: (n - before[k]) / steps
                for k, n in launches().items() if n > before[k]}
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "host_enqueue_ms_per_step": (t_enqueued - t0) * 1e3 / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_step": len(device) / steps,
        "launches_per_step": launched,
        "spans_per_step": [
            {"name": s.name, "host_ms": s.host_ms, "stream_ms": s.stream_ms,
             "work": s.work, "unit": s.unit, "spans": s.spans / steps}
            for s in spans.summary().values()],
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
