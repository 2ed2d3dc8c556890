"""Benchmarks of the port (the counterpart of ``volrt/bench/harness.py``).

The scripted suite (``cli bench``): :func:`default_suite`'s configurations,
each rendered by every rung of the ladder that applies on eight camera
poses (four orientations, orthographic and perspective; reference:
VolR.cpp:225-321) through :class:`~volrt_torch.utils.profiler.Profiler`
(avg, max and samples tables and the nominal roofline), and the
differentiable suite :func:`run_diff_suite`. Then the headline's two
timers, :func:`bench_fwd_step` and :func:`bench_diff_step`
(``python -m volrt_torch.bench``), on CUDA events.

Not ported: ``volrt``'s scoped-VMEM window fallback (``_is_vmem_oom``) and
its one-hot matrix-unit MFU and roofline (``_nominal_roofline``), which
have no role on the card, and ``bench_sharded_render`` (with ``dist/``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from volrt_torch.core.device import resolve_device
from volrt_torch.core.tf import default_transfer_fn
from volrt_torch.core.types import (
    Raycaster, Volume, default_ray_step, make_raycaster)
from volrt_torch.core.view import Camera
from volrt_torch.diff import fused as fused_mod
from volrt_torch.diff.render import render_diff_image, scene_from_volume
from volrt_torch.renderers import diff_v3, get_renderer, renderer_name
from volrt_torch.utils import profiler as prof_mod
from volrt_torch.utils.logger import get_logger

MAX_BENCH_SAMPLE_MS = 7500.0  # reference: VolR.cpp:26

# 4 poses x {ortho, persp} (reference: VolR.cpp:233-248).
BENCH_ANGLES = [
    (0.0, 0.0, 0.0),
    (-90.0, 0.0, 0.0),
    (0.0, -90.0, 0.0),
    (45.0, 45.0, 0.0),
]


@dataclasses.dataclass
class BenchConfig:
    name: str
    volume_size: int = 64
    viewport: int = 256
    esl: bool = True
    ert: bool = True
    ray_step_factor: float = 1.0
    interpolation: str = "trilinear"
    light_kd: float = 0.6
    shading: str = "diffuse"  # "diffuse" (reference one-tap) | "phong"
    file: str | None = None  # PVM/RAW dataset (reference: VolR.cpp:255-268)


def synthetic_volume(n: int, seed: int = 0) -> np.ndarray:
    """Deterministic procedural volume: soft shell + central blob."""
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2.0
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / c
    shell = np.exp(-((r - 0.7) ** 2) / 0.02) * 200
    blob = np.exp(-(r ** 2) / 0.08) * 255
    rng = np.random.default_rng(seed)
    noise = rng.uniform(0, 20, size=(n, n, n))
    return np.clip(shell + blob + noise, 0, 255).astype(np.uint8)


def default_suite(small: bool = False,
                  files: list[str] | None = None) -> list[BenchConfig]:
    """The benchmark sweep, ``volrt``'s configurations under its names
    (``volrt/bench/harness.py:62-106``), mirroring the reference's
    24-config structure (reference: VolR.cpp:34-38,270-321) with synthetic
    datasets, plus a configuration for each PVM/RAW file in ``files``
    (the reference loads seven named PVM files, VolR.cpp:255-268)."""
    cfgs: list[BenchConfig] = []
    for path in files or []:
        cfgs.append(BenchConfig(
            os.path.splitext(os.path.basename(path))[0], file=path))
    # Dataset sweep (reference configs 1-7: seven PVM datasets).
    sizes = [32, 64, 128] if small else [32, 64, 128, 256]
    for n in sizes:
        cfgs.append(BenchConfig(f"synthetic_{n}", volume_size=n))
    # Nearest-neighbour config, so that rung 2 runs in the default sweep.
    cfgs.append(BenchConfig(
        "nearest_64", volume_size=64, interpolation="nearest"))
    # Unshaded config: the flagship rung 5 and rungs 3-4 with no shade tap.
    cfgs.append(BenchConfig(
        "noshade_128" if not small else "noshade_64",
        volume_size=64 if small else 128, light_kd=0.0))
    # BASELINE config 4: gradient Blinn-Phong + ESL (rung 5's phong path).
    cfgs.append(BenchConfig(
        "phong_esl_64" if small else "phong_esl_256",
        volume_size=64 if small else 256,
        viewport=256 if small else 512, shading="phong"))
    # Optimisation toggles on one dataset (reference configs 8-10).
    base = 64 if small else 128
    cfgs.append(BenchConfig("no_optim", base, esl=False, ert=False))
    cfgs.append(BenchConfig("ert_only", base, esl=False, ert=True))
    cfgs.append(BenchConfig("ert_esl", base, esl=True, ert=True))
    # Viewport scale sweep (reference configs 11-17).
    for s in ([0.9, 0.5] if small else [0.9, 0.7, 0.5, 0.3]):
        cfgs.append(
            BenchConfig(f"viewport_{s}", base, viewport=int(512 * s))
        )
    # Ray-step factor sweep (reference configs 18-24).
    for f in ([1.1, 1.7] if small else [1.1, 1.3, 1.5, 1.7]):
        cfgs.append(BenchConfig(f"ray_step_{f}", base, ray_step_factor=f))
    return cfgs


def make_raycaster_for(cfg: BenchConfig, volume: Volume | None = None,
                       camera: Camera | None = None,
                       device: torch.device | str | None = None
                       ) -> Raycaster:
    """The render state of ``cfg`` on ``device`` (the card when ``None``),
    from ``volume`` (the synthetic volume of ``cfg.volume_size`` when
    ``None``) under ``camera``, as ``volrt``'s ``make_raycaster_for``."""
    device = resolve_device(device)
    if volume is None:
        volume = Volume.from_numpy(synthetic_volume(cfg.volume_size), device)
    if camera is None:
        camera = Camera(dims=(cfg.viewport, cfg.viewport))
    step = default_ray_step(volume.dims) * cfg.ray_step_factor
    return make_raycaster(
        volume,
        view=camera.view(device),
        ray_step=step,
        ray_threshold=0.95 if cfg.ert else 1.1,
        esl=cfg.esl,
        light_kd=cfg.light_kd,
        interpolation=cfg.interpolation,
        shading=cfg.shading,
    )


def _image(out) -> torch.Tensor:
    return out[0] if isinstance(out, tuple) else out


def renderer_fns(rc: Raycaster, renderers) -> list[tuple]:
    """``(id, name, fn)`` for each requested rung of the ladder that applies
    to ``rc``, ``fn()`` rendering the image: rung 2 in nearest mode only,
    rungs 3-5 in trilinear mode only, phong on rung 5 only, as ``volrt``'s
    suite picks them (``volrt/bench/harness.py:131-173``)."""
    out = []
    for rid in renderers:
        if rid == 2 and rc.interpolation != "nearest":
            continue
        if rid in (3, 4, 5) and rc.interpolation != "trilinear":
            continue
        if rid != 5 and rc.shading == "phong":
            continue
        mod = get_renderer(rid)
        out.append((rid, renderer_name(rid),
                    lambda rc=rc, mod=mod: _image(mod.render_float(rc))))
    return out


def _flops_per_sample(rid: int, interpolation: str) -> int:
    """A sample's f32 operations in the roofline's nominal march: the
    unshaded counts of ``utils/profiler.py`` (the shade taps' operations
    left out, so the bound stays a least time)."""
    if interpolation == "nearest":
        return prof_mod.FLOPS_NEAREST
    return prof_mod.FLOPS_FWD if rid == 5 else prof_mod.FLOPS_TRI


def _trace(trace_dir: str | None, name: str):
    """A ``torch.profiler`` context that writes a Chrome trace of the
    timed frames to ``trace_dir/<name>.json`` (nothing without a
    directory)."""
    if not trace_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    def write(prof):
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))

    return profile(activities=activities, on_trace_ready=write)


def run_suite(
    configs: list[BenchConfig] | None = None,
    renderers=(0, 1, 2, 3, 4, 5),
    frames: int = 8,
    warmup: int = 1,
    profiler: prof_mod.Profiler | None = None,
    logger=None,
    trace_dir: str | None = None,
    device: torch.device | str | None = None,
) -> prof_mod.Profiler:
    """Run the benchmark sweep on ``device`` (the card when ``None``);
    returns the filled profiler.

    Each (config, renderer) renders ``frames`` frames over ``volrt``'s
    eight camera poses after ``warmup`` frames of each projection; a frame
    that takes more than the reference's 7.5 s ends that renderer's run
    of the config (reference: VolR.cpp:237), and the golden rung 0 runs
    only on light configs (reference: VolR.cpp:228-230). A file config
    loads its volume through ``io/pvm.py``. Each cell gets a
    ``roofline_x`` note (:meth:`Profiler.print_roofline`). ``trace_dir``
    keeps a ``torch.profiler`` trace of each cell's timed frames.
    """
    device = resolve_device(device)
    log = (logger or get_logger()).log
    prof = profiler or prof_mod.Profiler()
    configs = configs if configs is not None else default_suite()

    for cfg in configs:
        if cfg.file:
            from volrt_torch.io.pvm import load_volume

            data, _ = load_volume(cfg.file)
        else:
            data = synthetic_volume(cfg.volume_size)
        volume = Volume.from_numpy(data, device)
        camera = Camera(dims=(cfg.viewport, cfg.viewport))
        poses = []
        for angles in BENCH_ANGLES:
            for persp in (False, True):
                camera.perspective = persp
                camera.toggle_perspective(update_mode=True)
                camera.set_camera_position(angles)
                poses.append(camera.view(device))

        for rid in renderers:
            if rid == 0 and (cfg.volume_size > 64 or cfg.viewport > 256
                             or cfg.file):
                continue
            rc0 = make_raycaster_for(cfg, volume, camera, device)
            fns = renderer_fns(rc0, [rid])
            if not fns:
                continue
            name = fns[0][1]
            # Warm both projections; a failure (out of memory, a mode the
            # rung refuses) skips the renderer for this config.
            try:
                for _ in range(warmup):
                    for wview in poses[:2]:
                        renderer_fns(rc0.replace(view=wview), [rid])[0][2]()
            except Exception as e:  # noqa: BLE001
                log(f"bench {cfg.name}/{name}: skipped ({e})")
                continue
            frame_fns = [renderer_fns(rc0.replace(view=poses[f % len(poses)]),
                                      [rid])[0][2] for f in range(frames)]
            with _trace(trace_dir, f"{cfg.name}_{name}"):
                for fn in frame_fns:
                    prof.start(cfg.name, name)
                    fn()
                    if prof.stop() > MAX_BENCH_SAMPLE_MS:
                        break
            avg_ms = prof.stats[cfg.name][name].avg_ms
            n_rays = cfg.viewport * cfg.viewport
            bound_ms = prof_mod.nominal_bound_ms(
                n_rays, int(2.0 / rc0.ray_step), volume.data.numel(),
                _flops_per_sample(rid, cfg.interpolation))
            if avg_ms > 0.0:
                prof.note(cfg.name, name, roofline_x=bound_ms / avg_ms)
        log(f"bench config {cfg.name} done")
    return prof


def run_diff_suite(
    configs: list[tuple[int, int]] | None = None,
    frames: int = 4,
    profiler: prof_mod.Profiler | None = None,
    logger=None,
    fused: bool = True,
    device: torch.device | str | None = None,
) -> prof_mod.Profiler:
    """The differentiable forward+backward sweep (no reference analog):
    one row per ``(volume_size, viewport)`` config, each frame a whole
    loss-and-gradients step of the synthetic scene under the zoomed
    orthographic view against a zero target, timed through the profiler
    like the forward suite. ``fused=True`` times the two-kernel route
    (``fused-v3``: ``march_fwd`` and ``march_bwd`` under autograd) and the
    one-launch ``l2_step`` (``fused-onepass``), whose cell gets a
    ``roofline_x`` note; ``fused=False`` autograd through the plain torch
    march (``plain-diff``)."""
    device = resolve_device(device)
    log = (logger or get_logger()).log
    prof = profiler or prof_mod.Profiler()
    if configs is None:
        configs = [(64, 256), (128, 512), (256, 1024)]
    for n, viewport in configs:
        cfg = f"diff_{n}_{viewport}"
        scene, view, target = diff_bench_scene(n, viewport, device=device)
        leaves = [scene.density, scene.tf_base]

        def autograd_step(loss_fn):
            def step():
                loss = loss_fn(scene, view, target)
                return loss, torch.autograd.grad(loss, leaves)
            return step

        if fused:
            variants = [
                ("fused-v3", autograd_step(fused_mod.l2_loss_fused)),
                ("fused-onepass", lambda: diff_v3.l2_loss_grads_v3_onepass(
                    scene, view, target))]
        else:
            variants = [("plain-diff", autograd_step(
                lambda s, v, t: torch.mean((render_diff_image(s, v) - t)
                                           ** 2)))]
        for vname, step in variants:
            try:
                step()
            except Exception as e:  # noqa: BLE001
                log(f"bench {cfg}/{vname}: skipped ({e})")
                continue
            for _ in range(frames):
                prof.start(cfg, vname)
                step()
                if prof.stop() > MAX_BENCH_SAMPLE_MS:
                    break
        if fused and "fused-onepass" in prof.stats.get(cfg, {}):
            avg_ms = prof.stats[cfg]["fused-onepass"].avg_ms
            numel = scene.density.numel()
            bound_ms = prof_mod.nominal_bound_ms(
                viewport * viewport, int(2.0 / scene.ray_step), numel * 4,
                prof_mod.FLOPS_FWD + prof_mod.FLOPS_BWD,
                grad_bytes=numel * 4)
            if avg_ms > 0.0:
                prof.note(cfg, "fused-onepass", roofline_x=bound_ms / avg_ms)
        log(f"bench config {cfg} done")
    return prof


def bench_pose(volume_size: int, viewport: int,
               device: torch.device | str | None = None,
               interpolation: str = "trilinear"):
    """The benchmark's render state: the synthetic volume under the
    orthographic camera zoomed until the cube fills the viewport, ERT off
    (threshold 2.0), unshaded (kd 0) and without ESL, as ``volrt``'s
    ``bench_fwd_step`` sets it up (``harness.py:661-694``)."""
    vol = Volume.from_numpy(synthetic_volume(volume_size), device)
    cam = Camera(dims=(viewport, viewport))
    cam.zoom(-1.0)
    return make_raycaster(vol, cam.view(device), ray_threshold=2.0,
                          esl=False, light_kd=0.0,
                          interpolation=interpolation)


def time_cuda(fn, iters: int) -> list[float]:
    """Device time in ms of each of ``iters`` calls of ``fn``, after one
    warm-up call. Each call sits between its own pair of CUDA events on the
    current stream; the host synchronises only at the end."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def bench_fwd_step(volume_size: int = 256, viewport: int = 1024,
                   iters: int = 100,
                   device: torch.device | str | None = None,
                   renderer: int = 5, shading: str | None = None,
                   esl: bool = False) -> dict:
    """Time one forward render on the card, of rung 5 or, with
    ``renderer``, of another rung of the ladder on the same pose (rung 2 in
    nearest mode, the others trilinear). ``shading`` is ``None``
    (unshaded, the default), ``"diffuse"`` or ``"phong"`` (BASELINE config
    4's shading, rung 5 only: rungs 2-4 refuse it), with ``light_kd`` 0.6
    when shaded, as ``volrt``'s ``bench_fwd_step`` sets it. ``esl=True``
    skips empty space (rung 5: the kernel's ESL mode; rungs 2-4: the
    leading leap), on the grid that the render state holds; with
    ``shading="phong"`` it is BASELINE config 4's forward
    (``volrt/bench/harness.py:636-650``).

    Times the rung's ``render_float`` whole (ray setup, the volume's
    conversion to what the kernel reads, and the march) with CUDA events,
    call by call, over
    ``iters`` calls after one warm-up call, which also builds the kernel.
    ``ms`` is the median, ``ms_p90`` the 90th percentile (meaningful from
    100 calls on). The accounting is ``volrt``'s:
    ``ray_steps_per_s = n_rays * int(2 / ray_step) / t`` at the median.
    There is no ``mfu``: ``volrt``'s counts one-hot matrix-unit FLOPs of
    the TPU kernel, which this kernel does not do.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("bench_fwd_step times a CUDA device")
    if shading not in (None, "diffuse", "phong"):
        raise ValueError(f"unknown shading: {shading!r}")
    rc = bench_pose(volume_size, viewport, device,
                    "nearest" if renderer == 2 else "trilinear")
    if shading:
        rc = rc.replace(light_kd=0.6, shading=shading)
    rc = rc.replace(esl=esl)
    render_float = get_renderer(renderer).render_float
    times = time_cuda(lambda: render_float(rc), iters)
    ms = float(np.median(times))
    n_rays = viewport * viewport
    n_steps = int(2.0 / rc.ray_step)
    return {
        "ms": ms,
        "ms_p90": float(np.percentile(times, 90)),
        "iters": iters,
        "rays_per_s": n_rays / (ms * 1e-3),
        "ray_steps_per_s": n_rays * n_steps / (ms * 1e-3),
        "device": torch.cuda.get_device_name(device),
        "precision": "f32",
    }


def diff_bench_scene(volume_size: int, viewport: int,
                     ray_step: float | None = None,
                     device: torch.device | str | None = None):
    """The step benchmark's ``(scene, view, target)``: the synthetic
    volume as a float scene under the default TF, the orthographic camera
    zoomed until the cube fills the viewport, and a zero target, all on
    ``device``, as ``volrt``'s ``bench_diff_step`` sets them up
    (``harness.py:501-516``)."""
    device = resolve_device(device)
    if ray_step is None:
        ray_step = default_ray_step((volume_size,) * 3)
    scene = scene_from_volume(synthetic_volume(volume_size),
                              default_transfer_fn(device), ray_step,
                              device=device)
    cam = Camera(dims=(viewport, viewport))
    cam.zoom(-1.0)  # distance 2.0: the ortho view spans [-1, 1]
    target = torch.zeros((viewport, viewport, 4), dtype=torch.float32,
                         device=device)
    return scene, cam.view(device), target


def crop_bench_scene(viewport: int,
                     device: torch.device | str | None = None):
    """The ``diff_tri`` route's step scene ``(scene, view, target)``: the
    middle ``[96, 96, 128]`` of the 128^3 synthetic volume, the largest
    that ``volrt`` gives that route by itself (``Dpad * Hpad <= 96 * 96``,
    ``W <= 128``), under :func:`diff_bench_scene`'s TF, camera and zero
    target."""
    device = resolve_device(device)
    crop = synthetic_volume(128)[16:112, 16:112, :]
    scene = scene_from_volume(crop, default_transfer_fn(device),
                              default_ray_step(crop.shape), device=device)
    cam = Camera(dims=(viewport, viewport))
    cam.zoom(-1.0)
    target = torch.zeros((viewport, viewport, 4), dtype=torch.float32,
                         device=device)
    return scene, cam.view(device), target


def bench_diff_step(volume_size: int = 256, viewport: int = 1024,
                    ray_step: float | None = None, iters: int = 20,
                    fused: bool = True, onepass: bool = False,
                    device: torch.device | str | None = None) -> dict:
    """Time one differentiable forward+backward step (loss and gradients
    of both leaves) on the card: the repo's headline metric, rays*steps/s
    for forward plus backward.

    ``fused=True, onepass=True`` is the one-launch L2 step
    (``diff_v3.l2_loss_grads_v3_onepass``); ``fused=True, onepass=False``
    autograd through the forward and the backward kernel
    (``diff_v3.render_image_v3``); ``fused=False`` autograd through the
    plain torch march (``render_diff_image``). The scene is
    :func:`diff_bench_scene`'s, kept on the card, with ERT off (threshold
    2.0) so that every ray takes its full march. The whole step is timed
    with CUDA events, call by call (ray setup, the gradients' zero-fill,
    the kernels, the loss), over ``iters`` calls after one warm-up call,
    which also builds the kernels. ``ms`` is the median; the accounting is ``volrt``'s:
    ``ray_steps_per_s = n_rays * int(2 / ray_step) / t``. There is no
    ``mfu`` and no ``model_flops``: ``volrt``'s count one-hot matrix-unit
    FLOPs of the TPU kernels, which these kernels do not do.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("bench_diff_step times a CUDA device")
    scene, view, target = diff_bench_scene(volume_size, viewport, ray_step,
                                           device)
    leaves = [scene.density, scene.tf_base]

    if fused and onepass:
        def step():
            return diff_v3.l2_loss_grads_v3_onepass(
                scene, view, target, ray_threshold=2.0)
    else:
        render = diff_v3.render_image_v3 if fused else render_diff_image

        def step():
            img = render(scene, view, ray_threshold=2.0)
            loss = torch.mean((img - target) ** 2)
            return loss, torch.autograd.grad(loss, leaves)

    last = []
    times = time_cuda(lambda: last.append(step()[0].detach()), iters)
    ms = float(np.median(times))
    n_rays = viewport * viewport
    # In-cube steps per ray (full march).
    n_steps = int(2.0 / scene.ray_step)
    return {
        "ms": ms,
        "ms_p90": float(np.percentile(times, 90)),
        "iters": iters,
        "rays_per_s": n_rays / (ms * 1e-3),
        "ray_steps_per_s": n_rays * n_steps / (ms * 1e-3),
        "loss": float(last[-1]),
        "device": torch.cuda.get_device_name(device),
        "precision": "f32",
    }


def _sharded_times(mesh, volume_size: int, viewport: int, iters: int,
                   renderer: str) -> dict:
    """:func:`bench_sharded_render`'s measurement on one rank of ``mesh``:
    the frame alone on this rank (a mesh of one) and over the mesh, each
    the median host time over ``iters`` frames that end in a barrier of
    the mesh and a synchronise."""
    from volrt_torch.dist.mesh import Mesh
    from volrt_torch.dist.render import render_float_sharded

    dev = mesh.device
    volume = Volume.from_numpy(synthetic_volume(volume_size), dev)
    cam = Camera(dims=(viewport, viewport))
    rc = make_raycaster_for(BenchConfig("sharded", volume_size, viewport),
                            volume, cam, dev)
    out = {}
    for label, m in (("1", Mesh(None, 0, 1, dev)), ("n", mesh)):
        times = []
        for i in range(iters + 1):
            mesh.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            render_float_sharded(rc, m, renderer=renderer)
            torch.cuda.synchronize(dev)
            m.barrier()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        out[label] = float(np.median(times))
    cards = mesh.all_gather(torch.tensor([dev.index or 0], device=dev))
    n = mesh.size
    return {
        "devices": n,
        "cards": len(set(cards.flatten().tolist())),
        "ms_1dev": out["1"],
        "ms_ndev": out["n"],
        "scaling_efficiency": out["1"] / (out["n"] * n),
        "device": torch.cuda.get_device_name(dev),
    }


def _sharded_rank(rank: int, size: int, volume_size: int, viewport: int,
                  iters: int, renderer: str, device: str, out: str) -> None:
    from volrt_torch.dist.mesh import make_mesh

    m = _sharded_times(make_mesh(device), volume_size, viewport, iters,
                       renderer)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(m, f)


def bench_sharded_render(volume_size: int = 64, viewport: int = 512,
                         iters: int = 10, renderer: str = "pallas-v3",
                         ranks: int = 2, backend: str = "gloo",
                         device: torch.device | str | None = None) -> dict:
    """The sharded render over a mesh of ranks against one rank
    (``volrt/bench/harness.py:720``): ``render_float_sharded`` (image rows
    split over the ranks) on ``renderer``, each frame's median host time
    ending in a barrier and a synchronise, alone on one rank and over the
    mesh; ``scaling_efficiency = ms_1dev / (ms_ndev * devices)``.

    Runs on the process group that is up (``torchrun``), or spawns
    ``ranks`` local ranks on ``backend`` (``"gloo"`` lets them share one
    card). ``cards`` counts the cards the ranks ran on: where it is less
    than ``devices`` the ranks shared a card, and the efficiency measures
    how the card takes their turns, not scaling. Times CUDA devices only.
    """
    import tempfile

    import torch.distributed as dist

    from volrt_torch.dist.mesh import make_mesh, spawn

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("bench_sharded_render times CUDA devices")
    if dist.is_initialized():
        return _sharded_times(make_mesh(device), volume_size, viewport,
                              iters, renderer)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sharded.json")
        spawn(_sharded_rank, ranks, volume_size, viewport, iters, renderer,
              str(dev), out, backend=backend)
        with open(out) as f:
            return json.load(f)
