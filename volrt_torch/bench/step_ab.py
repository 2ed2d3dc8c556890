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
- the round-1 routes beside them: ``diff_blocked_fwd`` and
  ``diff_blocked_bwd`` (whole, ``need_dtf=False``, ``need_dvol=False``) on
  both scenes, and the ``render_image_fused(blocked=True)`` step on scene
  ``a``; ``diff_tri_fwd``, ``diff_tri_bwd`` the same three ways and the
  ``blocked=False`` step on the ``[96, 96, 128]`` middle of the 128^3
  synthetic volume (scene ``crop``, ``chip_smoke.py`` phase 13's).

Kernels are timed with their wrapper and the gradients' zero-fill, median
of 20 calls after a warm-up (``harness.time_cuda``); the round-1
backwards take the round-1 forward's image and the cotangent of a mean
square against a zero target. Each process also prints the registers and
spills that ``ptxas`` reported for each variant of the backward kernels,
and their scatter opcodes in the SASS (:func:`sass_counts`). The parent
prints every process's JSON line, then one table: each time per
root in call order, and the ratio of the second root's median over its
runs to the first root's. Needs a CUDA card; the roots' order is the
caller's.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ITERS = 20
NOISE_SEED = 5
# The backwards' leaf-skipping variants: (label, keywords).
NEEDS = (("", {}), (" need_dtf=False", {"need_dtf": False}),
         (" need_dvol=False", {"need_dvol": False}))


def ptxas_report(build_log: str) -> dict:
    """Registers and spill bytes that ptxas reported for each variant of
    the backward kernels, in the build log's order."""
    out = {}
    for chunk in build_log.split("Compiling entry function")[1:]:
        name = re.match(r"\s*'([^']+)'", chunk).group(1)
        kernel = next((k for k in ("l2_step_kernel", "march_bwd_kernel",
                                   "round1_bwd_kernel") if k in name), None)
        if kernel is None:
            continue
        regs = int(re.search(r"Used (\d+) registers", chunk).group(1))
        spill = int(re.search(r"(\d+) bytes spill stores", chunk).group(1))
        rep = out.setdefault(kernel, {"registers": [], "spill_bytes": []})
        rep["registers"].append(regs)
        rep["spill_bytes"].append(spill)
    return out


def sass_counts(lib: str) -> dict:
    """Scatter opcodes in the backward kernels' SASS (``cuobjdump -sass``),
    summed over each kernel's variants: ``ATOMS`` (shared-memory atomics),
    ``RED`` and ``ATOM`` (global), ``MATCH``, ``SHFL``, ``VOTE``. Empty
    where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = next((k for k in ("l2_step_kernel", "march_bwd_kernel",
                                       "round1_bwd_kernel")
                           if k in m.group(1)), None)
            continue
        m = re.search(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if kernel is None or m is None:
            continue
        op = m.group(1).split(".")[0]
        if op in ("ATOMS", "RED", "REDG", "ATOM", "ATOMG", "MATCH", "SHFL",
                  "VOTE"):
            counts = out.setdefault(kernel, {})
            counts[op] = counts.get(op, 0) + 1
    return out


def _round1_times(fwd, bwd, args, kw, med) -> dict:
    """A round-1 pair's forward, and its backward whole and with either
    scatter left out, on one scene's ray arguments."""
    kw = {k: v for k, v in kw.items() if k != "shade"}
    out = fwd(*args, **kw)
    g = out * (2.0 / out.numel())
    t = {fwd.__name__: med(lambda: fwd(*args, **kw))}
    for label, need in NEEDS:
        t[bwd.__name__ + label] = med(
            lambda: bwd(*args, out, g, **need, **kw))
    return t


def child(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import volrt_torch
    from volrt_torch import _build
    from volrt_torch.bench.harness import (
        crop_bench_scene, diff_bench_scene, time_cuda)
    from volrt_torch.core.tf import default_transfer_fn
    from volrt_torch.diff.fused import render_image_fused
    from volrt_torch.diff.render import scene_from_arrays
    from volrt_torch.renderers import diff_v3, fwd_v3
    from volrt_torch.renderers.cuda.march import l2_step, march_bwd, march_fwd
    from volrt_torch.renderers.cuda.round1 import (
        diff_blocked_bwd, diff_blocked_fwd, diff_tri_bwd, diff_tri_fwd)

    assert os.path.dirname(volrt_torch.__file__).startswith(
        os.path.abspath(root)), volrt_torch.__file__
    dev = torch.device("cuda", 0)
    _build.load()
    lib = _build.library_path()
    res = {"root": root,
           "build": ptxas_report((lib.parent / "build.log").read_text()),
           "sass": sass_counts(str(lib))}
    med = lambda fn: float(np.median(time_cuda(fn, ITERS)))  # noqa: E731

    scene_a, view, target = diff_bench_scene(256, 1024, device=dev)
    noise = np.random.default_rng(NOISE_SEED).uniform(
        0.0, 1.0, (256, 256, 256)).astype(np.float32)
    scene_b = scene_from_arrays(noise, default_transfer_fn("cpu").numpy(),
                                scene_a.ray_step, device=dev)

    def round1_step(scene, view, target, blocked):
        params = [scene.density, scene.tf_base]

        def step():
            img = render_image_fused(scene, view, ray_threshold=2.0,
                                     blocked=blocked)
            loss = torch.mean((img - target) ** 2)
            return torch.autograd.grad(loss, params)
        return med(step)

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
            for label, need in NEEDS:
                t["l2_step" + label] = med(
                    lambda: l2_step(*args, tgt, **need, **kw))
                t["march_bwd" + label] = med(
                    lambda: march_bwd(*args, out, g, **need, **kw))
            t.update(_round1_times(diff_blocked_fwd, diff_blocked_bwd, args,
                                   kw, med))
        t["step onepass"] = med(lambda: diff_v3.l2_loss_grads_v3_onepass(
            scene, view, target, ray_threshold=2.0)[0])
        params = [scene.density, scene.tf_base]

        def two_kernel():
            img = diff_v3.render_image_v3(scene, view, ray_threshold=2.0)
            loss = torch.mean((img - target) ** 2)
            return torch.autograd.grad(loss, params)
        t["step two-kernel"] = med(two_kernel)
        if name == "a":
            t["step round-1 blocked=True"] = round1_step(scene, view, target,
                                                         True)
        leaves[name] = t

    # The diff_tri pair where chip_smoke.py runs it: the [96, 96, 128] crop.
    scene, view, target = crop_bench_scene(1024, device=dev)
    with torch.no_grad():
        args, kw = fwd_v3.ray_args(view, scene.density, scene.premult_tf(),
                                   scene.ray_step, 2.0, 0.0)
        leaves["crop"] = _round1_times(diff_tri_fwd, diff_tri_bwd, args, kw,
                                       med)
    leaves["crop"]["step round-1 blocked=False"] = round1_step(
        scene, view, target, False)
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
