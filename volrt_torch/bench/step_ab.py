"""Time the march kernels of two source trees on one card, in turns.

    python volrt_torch/bench/step_ab.py --roots OLD NEW NEW OLD

Each ``--roots`` entry is the root of a checkout of this repository (for
instance a ``git archive`` of an earlier commit unpacked into a directory
that ``.gitignore`` lists). Every entry runs in a process of its own that
imports ``volrt_torch`` from that root, builds its kernels and times, at
256^3 / 1024^2 on the benchmark pose, ERT off, unshaded:

- the ladder (scene ``ladder``): rung 4's ``march_blocked`` on the uint8
  volume, rung 3's ``march_tri`` and rung 2's ``march_tri`` nearest on the
  f32 copy, each with its wrapper; the frames of rungs 5, 4, 3 and 2
  (``bench_fwd_step``); and ``march_tri`` with its frame on the CLI's look
  without the leap (rung 3, diffuse kd 0.6, ERT 0.95, distance 3);
- scene ``a``, the benchmark's (``diff_bench_scene``), and scene ``b``, a
  uniform-noise f32 density of 256^3 from numpy (seed 5) under the same TF
  and pose, whose samples spread over the TF's rows;
- on each: ``l2_step`` whole, ``need_dtf=False`` and ``need_dvol=False``;
  ``march_bwd`` the same three ways (on ``a`` also whole with ERT at 0.95,
  the trainer's default threshold); ``march_fwd``; the one-launch step
  (``l2_loss_grads_v3_onepass``) and the two-kernel step (autograd through
  ``render_image_v3``), each timed as ``bench_diff_step`` times them;
- on scene ``a`` with the diffuse tap (kd 0.6): ``l2_step`` and
  ``march_bwd`` in their three ``need_*`` variants, ERT off and at 0.95;
- on scene ``a`` in phong mode (kd 0.6), where the root has it:
  ``march_fwd``, ``march_bwd`` and ``l2_step`` (whole), the one-launch
  and the two-kernel step, and rung 5's phong frame
  (``bench_fwd_step(shading="phong")``);
- where the root has ESL: on scene ``a`` the grid alone
  (``diff_v3.scene_esl``), ``march_fwd``, ``march_bwd`` and ``l2_step`` in
  ESL mode, unshaded and phong, and the one-launch and two-kernel steps
  with ``esl=True``; the frames of rungs 5 (unshaded and phong) to 2 with
  ``esl=True`` (rung 5's ESL mode, the leap kernel on rungs 2-4); the CLI
  look's frame with the leap and the leap kernel alone
  (``leap.esl_start``);
- where the root has them (``wide=``), the 64-bit voxel offsets'
  instances on the same volumes: ``march_blocked wide`` on the ladder's
  pose, ``diff_blocked_fwd``/``_bwd`` ``wide`` on scene ``a``;
- the round-1 routes beside them: ``diff_blocked_fwd`` and
  ``diff_blocked_bwd`` (whole, ``need_dtf=False``, ``need_dvol=False``) on
  both scenes, and the ``render_image_fused(blocked=True)`` step on scene
  ``a``; ``diff_tri_fwd``, ``diff_tri_bwd`` the same three ways and the
  ``blocked=False`` step on the ``[96, 96, 128]`` middle of the 128^3
  synthetic volume (scene ``crop``, ``chip_smoke.py`` phase 13's).

``--forwards-only`` times the forward kernels alone: the ladder, rung
5's frame, ``march_fwd`` (and in phong mode, with rung 5's phong frame)
and ``diff_blocked_fwd`` on scene ``a``, and ``diff_tri_fwd`` on the crop. Kernels are timed with their
wrapper and the gradients' zero-fill, median of 20 calls after a warm-up
(``harness.time_cuda``); the round-1 backwards take the round-1
forward's image and the cotangent of a mean square against a zero
target.

Each process also reports its build: the registers and spills that
``ptxas`` gave each variant of the six march kernels
(:func:`ptxas_report`), and from ``cuobjdump -sass`` (kept with
``--sass-dir``) the scatter opcodes, the opcode classes of each variant
and of its march loop, and a digest of each variant's instructions
(:func:`sass_counts`). The parent samples the SM clock with
``nvidia-smi`` while each process runs. It prints every process's JSON
line, then one table of times (each root in call order, and the ratio of
the second root's median over its runs to the first root's), then one of
the variants that :data:`VARIANT_ROWS` names, the forwards' and the
replays': registers, spills, loop instructions a sample by class, whether
the SASS is the first root's, the SM clock, and for the forwards the
issue-slot yardstick (:func:`issue_ms`) beside the time. A time that a
root has no mode for (phong in a tree from before it) reads "-". Needs a
CUDA card; the roots' order is the caller's.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
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
# The kernels whose build and SASS are reported: the forwards, then the
# backwards.
KERNELS = ("march_ladder_kernel", "march_fwd_kernel", "round1_fwd_kernel",
           "l2_step_kernel", "march_bwd_kernel", "round1_bwd_kernel",
           # The 64-bit voxel offsets' instances of rows 5, 8 and 9.
           "march_blocked_wide_kernel", "round1_fwd_wide_kernel",
           "round1_bwd_wide_kernel")
# The scatter's opcodes, counted per kernel over its variants.
SCATTER_OPS = ("ATOMS", "RED", "REDG", "ATOM", "ATOMG", "MATCH", "SHFL",
               "VOTE")
# Opcode classes of the march loop. Conversions run on a pipe that
# retires 16 results a clock on each SM, against 128 for FP32 and 64 for
# the integer ops; every class takes one issue slot a warp. What no class
# names (MOV, PRMT, FMNMX, FSETP, ...) counts as "other". NOP is padding
# and is not counted.
OPCODE_CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA"),
    "int": ("IADD3", "IMAD", "LOP3", "IMNMX", "ISETP", "SEL", "VIADD",
            "VIMNMX", "LEA", "SHF", "IADD", "IMUL"),
    "conv": ("F2I", "I2F", "FRND", "I2FP", "F2IP", "F2F"),
    "ldg": ("LDG",),
    "lds": ("LDS",),
    "mufu": ("MUFU",),
    "branch": ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "BRX", "JMP",
               "WARPSYNC"),
}
_CLASS_OF = {op: c for c, ops in OPCODE_CLASSES.items() for op in ops}
# A template argument in a mangled name: a voxel type, a bool, the
# kernels' shading mode (march_common.cuh:Shade, by its value: 0 none, 1
# the diffuse tap, 2 phong, so that the two modes that were a bool keep
# their names), their ESL mode (march_common.cuh:Esl) or their slab mode
# (march_common.cuh:Slab), and what the report calls it. ESL on reads
# "esl" and the slab mode "slab"; off, each is left out, so that a variant
# with either off keeps the name it had before the mode, and its SASS is
# compared with a tree from before it.
_ESL_ARG = r"L(?:N5volrt|NS\d*_)3EslE[01]E"
_SLAB_ARG = r"L(?:N5volrt|NS\d*_)4SlabE[01]E"
_MODE_ARGS = {_ESL_ARG: "esl", _SLAB_ARG: "slab"}
_TEMPLATE_ARG = (r"[hf]|Lb[01]E|L(?:N5volrt5ShadeE|S\d*_)[0-2]E|"
                 + _ESL_ARG + "|" + _SLAB_ARG)
_TEMPLATE_ARGS = {"h": "u8", "f": "f32"}


def _arg_name(arg: str) -> str | None:
    """What the report calls one template argument, None for a mode that
    is off."""
    for pattern, name in _MODE_ARGS.items():
        if re.fullmatch(pattern, arg):
            return name if arg[-2] == "1" else None
    return _TEMPLATE_ARGS.get(arg) or arg[-2]


def variant_name(mangled: str) -> str | None:
    """``march_ladder_kernel<u8,0,0,1>`` for a mangled kernel name of
    :data:`KERNELS` (template arguments in order: voxel type or shading
    mode, the ESL and slab modes where on, then the bools), None for any
    other function."""
    for kernel in KERNELS:
        m = re.search(kernel + f"(?:I((?:{_TEMPLATE_ARG})*)E)?", mangled)
        if m:
            args = re.findall(_TEMPLATE_ARG, m.group(1) or "")
            names = [n for n in map(_arg_name, args) if n is not None]
            return kernel + (f"<{','.join(names)}>" if names else "")
    return None


def ptxas_report(build_log: str) -> dict:
    """Registers and spill bytes that ptxas reported for each variant of
    :data:`KERNELS`, in the build log's order, with the variants' names
    (:func:`variant_name`)."""
    out = {}
    for chunk in build_log.split("Compiling entry function")[1:]:
        variant = variant_name(re.match(r"\s*'([^']+)'", chunk).group(1))
        if variant is None:
            continue
        regs = int(re.search(r"Used (\d+) registers", chunk).group(1))
        spill = int(re.search(r"(\d+) bytes spill stores", chunk).group(1))
        rep = out.setdefault(variant.split("<")[0], {
            "registers": [], "spill_bytes": [], "variants": []})
        rep["registers"].append(regs)
        rep["spill_bytes"].append(spill)
        rep["variants"].append(variant)
    return out


def cuobjdump_sass(lib: str) -> str:
    """``cuobjdump -sass`` of the library; empty where the toolkit has no
    ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return ""
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def parse_sass(sass: str) -> dict:
    """The instructions of each variant of :data:`KERNELS` in
    ``cuobjdump -sass`` text: ``{variant: [(address, opcode, branch
    target or None, text), ...]}``, NOP left out. A branch target is read
    as an address (``BRA 0x1a0``) or as a label (``BRA `(.L_x_3)``, with
    the label's line before its instruction). The text is the
    instruction's, predicate and operands, its labels written as the
    addresses they name (label numbers run over the whole file, so they
    move when another function changes)."""
    out, insts, labels, variant = {}, None, {}, None
    pending = []

    def close():
        if insts is None:
            return
        out[variant] = [
            (a, op, labels.get(t, t) if isinstance(t, str) else t,
             re.sub(r"\.L_x_\d+", lambda m: hex(labels.get(m.group(0), -1)),
                    text))
            for a, op, t, text in insts]

    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            variant = variant_name(m.group(1))
            insts = [] if variant else None
            labels, pending = {}, []
            continue
        if insts is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*))", line)
        if m is None:
            continue
        addr = int(m.group(1), 16)
        for label in pending:
            labels[label] = addr
        pending = []
        op = m.group(3).split(".")[0]
        if op == "NOP":
            continue
        target = None
        if op in ("BRA", "BRX", "JMP", "CALL"):
            t = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", m.group(4))
            if t:
                target = t.group(1) or int(t.group(2), 16)
        insts.append((addr, op, target, " ".join(m.group(2).split())))
    close()
    return out


def opcode_classes(ops) -> dict:
    """Counts of :data:`OPCODE_CLASSES` (and "other", and "total") over
    the opcodes ``ops``."""
    counts = dict.fromkeys((*OPCODE_CLASSES, "other"), 0)
    for op in ops:
        counts[_CLASS_OF.get(op, "other")] += 1
    counts["total"] = sum(counts.values())
    return counts


def march_loop(insts: list) -> list:
    """The instructions of a kernel's march loop: the longest span from a
    backward branch's target to the branch itself (static; forward
    branches inside it, the shade tap's, are counted as if taken never
    and always). Empty where the kernel has no loop."""
    best = (0, 0)
    for addr, _, target, _ in insts:
        if isinstance(target, int) and target <= addr and (
                addr - target > best[1] - best[0]):
            best = (target, addr)
    if best == (0, 0):
        return []
    return [i for i in insts if best[0] <= i[0] <= best[1]]


def sass_counts(sass: str) -> dict:
    """From ``cuobjdump -sass`` text: per kernel of :data:`KERNELS`, its
    scatter opcodes (:data:`SCATTER_OPS`) summed over its variants, and
    per variant the opcode classes of the whole kernel and of its march
    loop (:func:`march_loop`) and a digest of its instructions (address,
    opcode and operands; equal digests, equal SASS): ``{kernel: {"ATOMS":
    n, ..., "variants": {variant: {"kernel": classes, "loop": classes,
    "digest": hex}}}}``."""
    out = {}
    for variant, insts in parse_sass(sass).items():
        rep = out.setdefault(variant.split("<")[0], {"variants": {}})
        for _, op, _, _ in insts:
            if op in SCATTER_OPS:
                rep[op] = rep.get(op, 0) + 1
        text = "\n".join(f"{a:x} {t}" for a, _, _, t in insts)
        rep["variants"][variant] = {
            "kernel": opcode_classes(op for _, op, _, _ in insts),
            "loop": opcode_classes(i[1] for i in march_loop(insts)),
            "digest": hashlib.sha1(text.encode()).hexdigest()[:12]}
    return out


def _round1_times(fwd, bwd, args, kw, med, forwards_only: bool) -> dict:
    """A round-1 pair's forward, and unless ``forwards_only`` its backward
    whole and with either scatter left out, on one scene's ray
    arguments."""
    kw = {k: v for k, v in kw.items() if k != "shade"}
    out = fwd(*args, **kw)
    g = out * (2.0 / out.numel())
    t = {fwd.__name__: med(lambda: fwd(*args, **kw))}
    for label, need in () if forwards_only else NEEDS:
        t[bwd.__name__ + label] = med(
            lambda: bwd(*args, out, g, **need, **kw))
    return t


def _ladder_times(dev, med) -> tuple[dict, int]:
    """``(times, warp-steps)``: the ladder's march kernels with their
    wrappers on the benchmark pose (rung 4's ``march_blocked``, rung 3's
    ``march_tri``, rung 2's ``march_tri`` nearest), the frames of rungs
    5, 4, 3 and 2 (``bench_fwd_step``), and ``march_tri`` and its frame on
    the CLI's look without the leap (rung 3, diffuse kd 0.6, ERT 0.95, the
    camera at distance 3); and the pose's :func:`_warp_steps`."""
    import torch

    from volrt_torch.bench.harness import bench_fwd_step, bench_pose
    from volrt_torch.core.types import make_raycaster
    from volrt_torch.core.view import Camera
    from volrt_torch.renderers import trilinear
    from volrt_torch.renderers.cuda.march import march_blocked, march_tri

    t, warp_steps = {}, None
    with torch.no_grad():
        for name, fn, interp, volume in (
                ("march_blocked", march_blocked, "trilinear", None),
                ("march_tri", march_tri, "trilinear", torch.float32),
                ("march_tri nearest", march_tri, "nearest", torch.float32)):
            rc = bench_pose(256, 1024, dev, interp)
            args, kw = trilinear.ladder_args(
                rc, rc.volume.data if volume is None
                else rc.volume.data.to(volume))
            if fn is march_tri:
                kw["nearest"] = interp == "nearest"
            t[name] = med(lambda: fn(*args, **kw))
            if (fn is march_blocked
                    and "wide" in inspect.signature(fn).parameters):
                t[name + " wide"] = med(lambda: fn(*args, **kw, wide=True))
            if warp_steps is None:
                warp_steps = _warp_steps(args, kw, accumulate=True)
        for rung in (5, 4, 3, 2):
            t[f"frame rung {rung}"] = bench_fwd_step(
                256, 1024, iters=100, device=dev, renderer=rung)["ms"]
        if "shading" in inspect.signature(bench_fwd_step).parameters:
            t["frame rung 5 phong"] = bench_fwd_step(
                256, 1024, iters=100, device=dev, shading="phong")["ms"]
        if "esl" in inspect.signature(bench_fwd_step).parameters:
            # Rung 5 with its ESL mode, rungs 2-4 with the leap kernel.
            for rung in (5, 4, 3, 2):
                t[f"frame rung {rung} esl"] = bench_fwd_step(
                    256, 1024, iters=100, device=dev, renderer=rung,
                    esl=True)["ms"]
            t["frame rung 5 phong esl"] = bench_fwd_step(
                256, 1024, iters=100, device=dev, shading="phong",
                esl=True)["ms"]
        look = make_raycaster(bench_pose(256, 1024, dev).volume,
                              Camera(dims=(1024, 1024)).view(dev),
                              interpolation="trilinear").replace(esl=False)
        args, kw = trilinear.ladder_args(
            look, look.volume.data.to(torch.float32))
        t["march_tri cli look"] = med(
            lambda: march_tri(*args, nearest=False, **kw))
        t["frame rung 3 cli look"] = med(
            lambda: trilinear.render_float(look))
        if hasattr(look, "esl_dist"):
            from volrt_torch.renderers import batched
            from volrt_torch.renderers.cuda import leap

            lit = look.replace(esl=True)
            t["frame rung 3 cli look esl"] = med(
                lambda: trilinear.render_float(lit))
            rays = [r.contiguous() for r in batched.ray_bundle(lit)]
            grid = (lit.esl_dist, lit.volume.dims, lit.esl_block_dims,
                    lit.esl_block_size, lit.ray_step)
            t["esl_start cli look"] = med(lambda: leap.esl_start(*rays,
                                                                 *grid))
    return t, warp_steps


def _warp_steps(args, kw, accumulate: bool) -> int:
    """Samples a forward kernel steps through on these rays with ERT off,
    counted by warp (two image rows of 16 pixels, the kernel's 32 lanes):
    each warp takes as many steps as its longest ray. On the accumulating
    lattice of the ladder and round 1 (``accumulate``: ``k += step``, the
    first sample always taken, while the next ``k <= kfar``), or on rung
    5's ``k0 + i*step <= kfar``."""
    import torch

    from volrt_torch.renderers.cuda.march import max_steps

    _, _, k0, kfar, live = args[:5]
    n = torch.zeros(k0.shape, dtype=torch.int64, device=k0.device)
    k = k0
    lattice = torch.arange(max_steps(kw["ray_step"]), dtype=torch.float32,
                           device=k0.device) * kw["ray_step"]
    for i in range(lattice.numel()):
        if not accumulate:
            live = live & (k0 + lattice[i] <= kfar)
        n += live
        if accumulate:
            k = k + kw["ray_step"]
            live = live & (k <= kfar)
    width = kw["width"]
    per_warp = n.reshape(-1, 2, width // 16, 16).amax(dim=(1, 3))
    return int(per_warp.sum())


def child(root: str, sass_file: str | None = None,
          forwards_only: bool = False) -> dict:
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
    # Phong and ESL are modes of the v3 kernels from their trees' PRs on;
    # an older root has no times for them.
    has_phong = "phong" in inspect.signature(march_fwd).parameters
    has_esl = "esl" in inspect.signature(march_fwd).parameters
    has_wide = "wide" in inspect.signature(diff_blocked_fwd).parameters
    _build.load()
    lib = _build.library_path()
    sass = cuobjdump_sass(str(lib))
    if sass_file:
        with open(sass_file, "w") as f:
            f.write(sass)
    res = {"root": root,
           "build": ptxas_report((lib.parent / "build.log").read_text()),
           "sass": sass_counts(sass)}
    med = lambda fn: float(np.median(time_cuda(fn, ITERS)))  # noqa: E731
    ladder, steps = _ladder_times(dev, med)
    res["warp_steps"] = {"ladder": steps}
    leaves = {"ladder": ladder}
    res["ms"] = leaves

    scene_a, view, target = diff_bench_scene(256, 1024, device=dev)
    scenes = [("a", scene_a)]
    if not forwards_only:
        noise = np.random.default_rng(NOISE_SEED).uniform(
            0.0, 1.0, (256, 256, 256)).astype(np.float32)
        scenes.append(("b", scene_from_arrays(
            noise, default_transfer_fn("cpu").numpy(), scene_a.ray_step,
            device=dev)))

    def round1_step(scene, view, target, blocked):
        params = [scene.density, scene.tf_base]

        def step():
            img = render_image_fused(scene, view, ray_threshold=2.0,
                                     blocked=blocked)
            loss = torch.mean((img - target) ** 2)
            return torch.autograd.grad(loss, params)
        return med(step)

    for name, scene in scenes:
        t = {}
        with torch.no_grad():
            args, kw = fwd_v3.ray_args(
                view, scene.density, scene.premult_tf(), scene.ray_step,
                2.0, 0.0, loss_scale=2.0 / (1024 * 1024 * 4))
            if name == "a":
                res["warp_steps"]["a"] = _warp_steps(args, kw, False)
                res["warp_steps"]["a accumulating"] = _warp_steps(args, kw,
                                                                  True)
            tgt = target.reshape(-1, 4)
            out = march_fwd(*args, **kw)
            g = out * args[7][6]
            t["march_fwd"] = med(lambda: march_fwd(*args, **kw))
            if name == "a" and has_phong:
                p_args, p_kw = fwd_v3.ray_args(
                    view, scene.density, scene.premult_tf(), scene.ray_step,
                    2.0, 0.6, loss_scale=2.0 / (1024 * 1024 * 4), phong=True)
                p_out = march_fwd(*p_args, **p_kw)
                p_g = p_out * p_args[7][6]
                t["march_fwd phong"] = med(lambda: march_fwd(*p_args, **p_kw))
                if not forwards_only:
                    t["l2_step phong"] = med(
                        lambda: l2_step(*p_args, tgt, **p_kw))
                    t["march_bwd phong"] = med(
                        lambda: march_bwd(*p_args, p_out, p_g, **p_kw))
            if name == "a" and not forwards_only:
                # The diffuse tap's step kernels, in every need_* variant,
                # ERT off and at 0.95.
                for thr in (2.0, 0.95):
                    d_args, d_kw = fwd_v3.ray_args(
                        view, scene.density, scene.premult_tf(),
                        scene.ray_step, thr, 0.6,
                        loss_scale=2.0 / (1024 * 1024 * 4))
                    d_out = march_fwd(*d_args, **d_kw)
                    d_g = d_out * d_args[7][6]
                    ert = " ERT 0.95" if thr < 1 else ""
                    for label, need in NEEDS:
                        t["l2_step diffuse" + ert + label] = med(
                            lambda: l2_step(*d_args, tgt, **need, **d_kw))
                        t["march_bwd diffuse" + ert + label] = med(
                            lambda: march_bwd(*d_args, d_out, d_g, **need,
                                              **d_kw))
            for label, need in () if forwards_only else NEEDS:
                t["l2_step" + label] = med(
                    lambda: l2_step(*args, tgt, **need, **kw))
                t["march_bwd" + label] = med(
                    lambda: march_bwd(*args, out, g, **need, **kw))
            if name == "a" and has_esl:
                # The ESL mode on the grid of the scene's TF, unshaded and
                # phong, and the grid alone.
                t["scene_esl"] = med(lambda: diff_v3.scene_esl(scene))
                esl = diff_v3.scene_esl(scene)
                for mode, kd, phong in (("", 0.0, False),
                                        (" phong", 0.6, True)):
                    s_args, s_kw = fwd_v3.ray_args(
                        view, scene.density, scene.premult_tf(),
                        scene.ray_step, 2.0, kd,
                        loss_scale=2.0 / (1024 * 1024 * 4), phong=phong,
                        esl=esl)
                    s_out = march_fwd(*s_args, **s_kw)
                    s_g = s_out * s_args[7][6]
                    t["march_fwd" + mode + " esl"] = med(
                        lambda: march_fwd(*s_args, **s_kw))
                    if not forwards_only:
                        t["l2_step" + mode + " esl"] = med(
                            lambda: l2_step(*s_args, tgt, **s_kw))
                        t["march_bwd" + mode + " esl"] = med(
                            lambda: march_bwd(*s_args, s_out, s_g, **s_kw))
            if name == "a" and not forwards_only:
                e_args, e_kw = fwd_v3.ray_args(
                    view, scene.density, scene.premult_tf(), scene.ray_step,
                    0.95, 0.0, loss_scale=2.0 / (1024 * 1024 * 4))
                e_out = march_fwd(*e_args, **e_kw)
                e_g = e_out * e_args[7][6]
                t["l2_step ERT 0.95"] = med(
                    lambda: l2_step(*e_args, tgt, **e_kw))
                t["march_bwd ERT 0.95"] = med(
                    lambda: march_bwd(*e_args, e_out, e_g, **e_kw))
            t.update(_round1_times(diff_blocked_fwd, diff_blocked_bwd, args,
                                   kw, med, forwards_only))
            if name == "a" and has_wide:
                # The 64-bit voxel offsets' instances on the same scene.
                wide = _round1_times(diff_blocked_fwd, diff_blocked_bwd,
                                     args, dict(kw, wide=True), med,
                                     forwards_only)
                t.update({k + " wide": v for k, v in wide.items()})
        leaves[name] = t
        if forwards_only:
            continue
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
        if name == "a" and has_phong:
            phong = dict(ray_threshold=2.0, light_kd=0.6, phong=True)
            t["step onepass phong"] = med(
                lambda: diff_v3.l2_loss_grads_v3_onepass(
                    scene, view, target, **phong)[0])

            def two_kernel_phong():
                img = diff_v3.render_image_v3(scene, view, **phong)
                loss = torch.mean((img - target) ** 2)
                return torch.autograd.grad(loss, params)
            t["step two-kernel phong"] = med(two_kernel_phong)
        if name == "a" and has_esl:
            for mode, kw_e in (("", {}), (" phong", dict(light_kd=0.6,
                                                           phong=True))):
                t["step onepass" + mode + " esl"] = med(
                    lambda: diff_v3.l2_loss_grads_v3_onepass(
                        scene, view, target, ray_threshold=2.0, esl=True,
                        **kw_e)[0])

                def two_kernel_esl():
                    img = diff_v3.render_image_v3(
                        scene, view, ray_threshold=2.0, esl=True, **kw_e)
                    loss = torch.mean((img - target) ** 2)
                    return torch.autograd.grad(loss, params)
                t["step two-kernel" + mode + " esl"] = med(two_kernel_esl)

    # The diff_tri pair where chip_smoke.py runs it: the [96, 96, 128] crop.
    scene, view, target = crop_bench_scene(1024, device=dev)
    with torch.no_grad():
        args, kw = fwd_v3.ray_args(view, scene.density, scene.premult_tf(),
                                   scene.ray_step, 2.0, 0.0)
        res["warp_steps"]["crop accumulating"] = _warp_steps(args, kw, True)
        leaves["crop"] = _round1_times(diff_tri_fwd, diff_tri_bwd, args, kw,
                                       med, forwards_only)
    if not forwards_only:
        leaves["crop"]["step round-1 blocked=False"] = round1_step(
            scene, view, target, False)
    return res


class ClockSampler:
    """``nvidia-smi``'s SM clock and utilisation, sampled every 200 ms
    while the ``with`` block runs; :meth:`summary` keeps the samples taken
    while the card was busy (utilisation 50 % or more)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        self.out, _ = self.proc.communicate(timeout=60)

    def summary(self) -> dict:
        busy = []
        for line in self.out.splitlines():
            try:
                clock, util = (float(v) for v in line.split(","))
            except ValueError:
                continue
            if util >= 50:
                busy.append(clock)
        return {"sm_clock_mhz": float(np.median(busy)) if busy else None,
                "sm_clock_mhz_min": min(busy, default=None),
                "busy_samples": len(busy)}


# The variants the report's rows run on the benchmark pose (unshaded
# unless named phong, which has kd 0.6; ERT off unless named; ESL mode
# where named esl; the backwards whole): (scene, time key, variant, the key in
# the child's ``warp_steps`` of the lattice its warps step on). The
# forwards' loop holds one sample an iteration, so their loop
# instructions are a sample's and the issue-slot yardstick reads them;
# a replay's loop also holds its scatter's branches and shuffle rounds,
# and has no yardstick (None).
VARIANT_ROWS = (
    ("ladder", "march_blocked", "march_ladder_kernel<u8,0,0,1>", "ladder"),
    ("ladder", "march_tri", "march_ladder_kernel<f32,0,0,1>", "ladder"),
    ("ladder", "march_tri nearest", "march_ladder_kernel<f32,1,0,1>",
     "ladder"),
    ("a", "march_fwd", "march_fwd_kernel<0,1>", "a"),
    ("a", "diff_blocked_fwd", "round1_fwd_kernel<1>", "a accumulating"),
    ("crop", "diff_tri_fwd", "round1_fwd_kernel<1>", "crop accumulating"),
    ("a", "march_fwd phong", "march_fwd_kernel<2,1>", "a"),
    ("a", "march_fwd esl", "march_fwd_kernel<0,esl,1>", "a"),
    ("a", "march_fwd phong esl", "march_fwd_kernel<2,esl,1>", "a"),
    ("a", "march_bwd", "march_bwd_kernel<0,1,1,1>", None),
    ("a", "l2_step", "l2_step_kernel<0,1,1,1>", None),
    ("a", "march_bwd phong", "march_bwd_kernel<2,1,1,1>", None),
    ("a", "l2_step phong", "l2_step_kernel<2,1,1,1>", None),
    ("a", "march_bwd esl", "march_bwd_kernel<0,esl,1,1,1>", None),
    ("a", "l2_step esl", "l2_step_kernel<0,esl,1,1,1>", None),
    ("a", "march_bwd phong esl", "march_bwd_kernel<2,esl,1,1,1>", None),
    ("a", "l2_step phong esl", "l2_step_kernel<2,esl,1,1,1>", None),
    ("a", "march_bwd ERT 0.95", "march_bwd_kernel<0,0,1,1>", None),
    ("a", "l2_step ERT 0.95", "l2_step_kernel<0,0,1,1>", None),
    ("a", "diff_blocked_bwd", "round1_bwd_kernel<1,1,1>", None),
    ("crop", "diff_tri_bwd", "round1_bwd_kernel<1,1,1>", None),
    ("ladder", "march_blocked wide", "march_blocked_wide_kernel<0,1>",
     "ladder"),
    ("a", "diff_blocked_fwd wide", "round1_fwd_wide_kernel<1>",
     "a accumulating"),
    ("a", "diff_blocked_bwd wide", "round1_bwd_wide_kernel<1,1,1>", None),
)
# Issue slots of one H100: 132 SMs of four schedulers, one warp
# instruction a clock each.
ISSUE_SLOTS = 132 * 4


def issue_ms(instructions: int, warp_steps: int, clock_mhz: float) -> float:
    """The issue-slot yardstick: the time the card takes to issue
    ``instructions`` a warp-step for ``warp_steps`` warp-steps at
    ``clock_mhz``, with every scheduler issuing every clock."""
    return instructions * warp_steps / (ISSUE_SLOTS * clock_mhz * 1e3)


def _variant(run: dict, variant: str) -> tuple:
    """``(registers, spill bytes, SASS report)`` of one variant in a
    child's run (None where the build or the SASS lacks it)."""
    kernel = variant.split("<")[0]
    build = run["build"].get(kernel, {})
    regs = dict(zip(build.get("variants", ()),
                    zip(build.get("registers", ()),
                        build.get("spill_bytes", ()))))
    sass = run["sass"].get(kernel, {}).get("variants", {}).get(variant, {})
    return (*regs.get(variant, (None, None)), sass)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--roots", nargs="+", required=True,
                   help="source trees, timed in this order")
    p.add_argument("--sass-dir", default=None,
                   help="write each root's cuobjdump -sass here, as "
                        "<call index>.sass")
    p.add_argument("--forwards-only", action="store_true",
                   help="time the forward kernels and frames only")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--sass-file", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.roots[0], args.sass_file,
                               args.forwards_only)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.sass_dir:
        os.makedirs(args.sass_dir, exist_ok=True)
    runs = []
    for i, root in enumerate(args.roots):
        cmd = [sys.executable, os.path.abspath(__file__), "--child",
               "--roots", root] + ["--forwards-only"] * args.forwards_only
        if args.sass_dir:
            cmd += ["--sass-file", os.path.join(args.sass_dir, f"{i}.sass")]
        with ClockSampler() as clock:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 check=False, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["clock"] = clock.summary()
        print(json.dumps(run), flush=True)
        runs.append(run)
    # The ratio of the second distinct root's median to the first's.
    first, second = list(dict.fromkeys(args.roots))[:2] + [None] * (
        len(set(args.roots)) < 2)
    print(f"| scene | time (ms) | {' | '.join(args.roots)} | "
          f"{second} / {first} |")
    print(f"| --- | --- |{' --- |' * len(args.roots)} --- |")
    scenes = {}
    for run in runs:
        for scene, times in run["ms"].items():
            scenes.setdefault(scene, dict.fromkeys(times)).update(
                dict.fromkeys(times))
    for scene, keys in scenes.items():
        for key in keys:
            row = [r["ms"].get(scene, {}).get(key) for r in runs]
            by = {root: float(np.median([v for v, r in zip(row, args.roots)
                                         if r == root and v is not None]
                                        or [np.nan]))
                  for root in (first, second) if root is not None}
            ratio = (f"{by[second] / by[first]:.3f}"
                     if second and not np.isnan(by[first] + by[second])
                     else "-")
            print(f"| {scene} | {key} | "
                  + " | ".join("-" if v is None else f"{v:.4f}" for v in row)
                  + f" | {ratio} |")
    # The rows' variants: build, SASS of the march loop by opcode class,
    # whether the SASS is the first root's, and the issue-slot yardstick
    # beside the time.
    print("| root | call | variant | registers | spill bytes | loop "
          "instructions (" + ", ".join((*OPCODE_CLASSES, "other")) + ") | "
          "SASS as first root's | SM MHz | issue ms | ms |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for root, run in zip(args.roots, runs):
        clock = run["clock"]["sm_clock_mhz"]
        for scene, name, variant, lattice in VARIANT_ROWS:
            if name not in run["ms"].get(scene, {}):
                continue
            r, spill, sass = _variant(run, variant)
            loop = sass.get("loop")
            same = sass.get("digest") == _variant(runs[0], variant)[2].get(
                "digest")
            yard = (f"{issue_ms(loop['total'], run['warp_steps'][lattice],
                                clock):.4f}"
                    if loop and clock and lattice else "-")
            classes = (f"{loop['total']} (" + ", ".join(
                str(loop[c]) for c in (*OPCODE_CLASSES, "other")) + ")"
                if loop else "-")
            print(f"| {root} | {name} | `{variant}` | {r} | {spill} | "
                  f"{classes} | {'yes' if same else 'no'} | {clock} | "
                  f"{yard} | {run['ms'][scene][name]:.4f} |")
    # Every variant of every kernel: how many keep the first root's SASS.
    print("| kernel | " + " | ".join(args.roots) + " |")
    print("| --- |" + " --- |" * len(args.roots))
    for kernel in KERNELS:
        base = runs[0]["sass"].get(kernel, {}).get("variants", {})
        cells = []
        for run in runs:
            mine = run["sass"].get(kernel, {}).get("variants", {})
            same = sum(v.get("digest") == base.get(k, {}).get("digest")
                       for k, v in mine.items())
            cells.append(f"{same} of {len(mine)} as the first root's")
        print(f"| {kernel} | " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
