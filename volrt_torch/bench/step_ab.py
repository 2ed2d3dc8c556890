"""Time the step kernels of two source trees on one card, in turns.

    python volrt_torch/bench/step_ab.py --roots OLD NEW NEW OLD

Each ``--roots`` entry is the root of a checkout of this repository (for
instance a ``git archive`` of an earlier commit unpacked into a directory
that ``.gitignore`` lists). Every entry runs in a process of its own that
imports ``volrt_torch`` from that root, builds its kernels and times, at
256^3 / 1024^2 on the benchmark pose, ERT off, unshaded:

- scene ``a``, the benchmark's (``diff_bench_scene``), and scene ``b``, a
  uniform-noise f32 density of 256^3 from numpy (seed 5) under the same TF
  and pose, whose samples spread over the TF's rows;
- on each: ``l2_step`` whole, ``need_dtf=False`` and ``need_dvol=False``;
  ``march_bwd`` the same three ways; ``march_fwd``; the one-launch step
  (``l2_loss_grads_v3_onepass``) and the two-kernel step (autograd through
  ``render_image_v3``), each timed as ``bench_diff_step`` times them;
- the round-1 backwards beside them: ``diff_blocked_bwd`` on scene ``a``
  and ``diff_tri_bwd`` on the ``[96, 96, 128]`` middle of the 128^3
  synthetic volume.

Kernels are timed with their wrapper and the gradients' zero-fill, median
of 20 calls after a warm-up (``harness.time_cuda``). Each process also
prints the registers and spills that ``ptxas`` reported for the step
kernels. The parent prints every process's JSON line, then one table:
each time per root in call order, and the ratio of the second root's
median over its runs to the first root's. Needs a CUDA card; the roots'
order is the caller's.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

ITERS = 20
NOISE_SEED = 5


def _build_report(build_log: str) -> dict:
    """Registers and spill bytes of each step kernel variant ptxas built."""
    out = {}
    for chunk in build_log.split("Compiling entry function")[1:]:
        name = re.match(r"\s*'([^']+)'", chunk).group(1)
        kernel = next((k for k in ("l2_step_kernel", "march_bwd_kernel",
                                   "round1_bwd_kernel") if k in name), None)
        if kernel is None:
            continue
        regs = int(re.search(r"Used (\d+) registers", chunk).group(1))
        spill = int(re.search(r"(\d+) bytes spill stores", chunk).group(1))
        prev = out.get(kernel, (0, 0, 0))
        out[kernel] = (max(prev[0], regs), max(prev[1], spill), prev[2] + 1)
    return {k: {"max_registers": r, "max_spill_bytes": s, "variants": n}
            for k, (r, s, n) in out.items()}


def child(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import volrt_torch
    from volrt_torch import _build
    from volrt_torch.bench.harness import (
        diff_bench_scene, synthetic_volume, time_cuda)
    from volrt_torch.core.tf import default_transfer_fn
    from volrt_torch.core.types import default_ray_step
    from volrt_torch.core.view import Camera
    from volrt_torch.diff.render import scene_from_arrays, scene_from_volume
    from volrt_torch.renderers import diff_v3, fwd_v3
    from volrt_torch.renderers.cuda.march import l2_step, march_bwd, march_fwd
    from volrt_torch.renderers.cuda.round1 import (
        diff_blocked_bwd, diff_tri_bwd)

    assert os.path.dirname(volrt_torch.__file__).startswith(
        os.path.abspath(root)), volrt_torch.__file__
    dev = torch.device("cuda", 0)
    _build.load()
    res = {"root": root, "build": _build_report(
        (_build.library_path().parent / "build.log").read_text())}
    med = lambda fn: float(np.median(time_cuda(fn, ITERS)))  # noqa: E731

    scene_a, view, target = diff_bench_scene(256, 1024, device=dev)
    noise = np.random.default_rng(NOISE_SEED).uniform(
        0.0, 1.0, (256, 256, 256)).astype(np.float32)
    scene_b = scene_from_arrays(noise, default_transfer_fn("cpu").numpy(),
                                scene_a.ray_step, device=dev)
    leaves = {}
    for name, scene in (("a", scene_a), ("b", scene_b)):
        t = {}
        with torch.no_grad():
            args, kw = fwd_v3.ray_args(
                view, scene.density, scene.premult_tf(), scene.ray_step,
                2.0, 0.0, loss_scale=2.0 / (1024 * 1024 * 4))
            tgt = target.reshape(-1, 4)
            out = march_fwd(*args, **kw)
            g = out * args[7][6]
            t["march_fwd"] = med(lambda: march_fwd(*args, **kw))
            for label, need in (("", {}), (" need_dtf=False",
                                           {"need_dtf": False}),
                                (" need_dvol=False", {"need_dvol": False})):
                t["l2_step" + label] = med(
                    lambda: l2_step(*args, tgt, **need, **kw))
                t["march_bwd" + label] = med(
                    lambda: march_bwd(*args, out, g, **need, **kw))
            if name == "a":
                del kw["shade"]
                t["diff_blocked_bwd"] = med(
                    lambda: diff_blocked_bwd(*args, out, g, **kw))
        t["step onepass"] = med(lambda: diff_v3.l2_loss_grads_v3_onepass(
            scene, view, target, ray_threshold=2.0)[0])
        params = [scene.density, scene.tf_base]

        def two_kernel():
            img = diff_v3.render_image_v3(scene, view, ray_threshold=2.0)
            loss = torch.mean((img - target) ** 2)
            return torch.autograd.grad(loss, params)
        t["step two-kernel"] = med(two_kernel)
        leaves[name] = t

    # diff_tri_bwd where chip_smoke.py runs it: the [96, 96, 128] crop.
    crop = synthetic_volume(128)[16:112, 16:112, :]
    scene = scene_from_volume(crop, default_transfer_fn(dev),
                              default_ray_step((128, 96, 96)), device=dev)
    cam = Camera(dims=(1024, 1024))
    cam.zoom(-1.0)
    with torch.no_grad():
        args, kw = fwd_v3.ray_args(cam.view(dev), scene.density,
                                   scene.premult_tf(), scene.ray_step, 2.0,
                                   0.0)
        del kw["shade"]
        out = march_fwd(*args, shade=False, **kw)
        g = out * (2.0 / out.numel())
        leaves["a"]["diff_tri_bwd [96,96,128]"] = med(
            lambda: diff_tri_bwd(*args, out, g, **kw))
    res["ms"] = leaves
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--roots", nargs="+", required=True,
                   help="source trees, timed in this order")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.roots[0])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = []
    for root in args.roots:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--roots", root], capture_output=True, text=True, check=False,
            timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    # The ratio of the second distinct root's median to the first's.
    first, second = list(dict.fromkeys(args.roots))[:2] + [None] * (
        len(set(args.roots)) < 2)
    print(f"| scene | time (ms) | {' | '.join(args.roots)} | "
          f"{second} / {first} |")
    print(f"| --- | --- |{' --- |' * len(args.roots)} --- |")
    for scene, times in runs[0]["ms"].items():
        for key in times:
            row = [r["ms"][scene][key] for r in runs]
            by = {root: float(np.median([v for v, r in zip(row, args.roots)
                                         if r == root]))
                  for root in (first, second) if root is not None}
            ratio = f"{by[second] / by[first]:.3f}" if second else "-"
            print(f"| {scene} | {key} | "
                  + " | ".join(f"{v:.4f}" for v in row) + f" | {ratio} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
