"""Benchmark helpers of the port (the counterparts of
``volrt/bench/harness.py:50-59, 472-633, 636-717``)."""
from __future__ import annotations

import numpy as np
import torch

from volrt_torch.core.device import resolve_device
from volrt_torch.core.tf import default_transfer_fn
from volrt_torch.core.types import Volume, default_ray_step, make_raycaster
from volrt_torch.core.view import Camera
from volrt_torch.diff.render import render_diff_image, scene_from_volume
from volrt_torch.renderers import diff_v3, get_renderer


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
                   renderer: int = 5, shading: str | None = None) -> dict:
    """Time one forward render on the card, of rung 5 or, with
    ``renderer``, of another rung of the ladder on the same pose (rung 2 in
    nearest mode, the others trilinear). ``shading`` is ``None``
    (unshaded, the default), ``"diffuse"`` or ``"phong"`` (BASELINE config
    4's shading, rung 5 only: rungs 2-4 refuse it), with ``light_kd`` 0.6
    when shaded, as ``volrt``'s ``bench_fwd_step`` sets it.

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
