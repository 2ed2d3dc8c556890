"""Benchmark helpers of the port (the counterparts of
``volrt/bench/harness.py:50-59, 636-717``)."""
from __future__ import annotations

import numpy as np
import torch

from volrt_torch.core.types import Volume, make_raycaster
from volrt_torch.core.view import Camera
from volrt_torch.renderers import fwd_v3


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


def bench_pose(volume_size: int, viewport: int, device: torch.device | str):
    """The benchmark's render state: the synthetic volume under the
    orthographic camera zoomed until the cube fills the viewport, ERT off
    (threshold 2.0) and unshaded (kd 0), as ``volrt``'s ``bench_fwd_step``
    sets it up (``harness.py:661-694``)."""
    vol = Volume.from_numpy(synthetic_volume(volume_size), device)
    cam = Camera(dims=(viewport, viewport))
    cam.zoom(-1.0)
    return make_raycaster(vol, cam.view(device), ray_threshold=2.0,
                          esl=False, light_kd=0.0)


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
                   device: torch.device | str = "cuda") -> dict:
    """Time one rung-5 forward render on the card.

    Times ``fwd_v3.render_float`` whole (ray setup, the uint8-to-f32
    volume conversion and the march) with CUDA events, call by call, over
    ``iters`` calls after one warm-up call, which also builds the kernel.
    ``ms`` is the median, ``ms_p90`` the 90th percentile (meaningful from
    100 calls on). The accounting is ``volrt``'s:
    ``ray_steps_per_s = n_rays * int(2 / ray_step) / t`` at the median.
    There is no ``mfu``: ``volrt``'s counts one-hot matrix-unit FLOPs of
    the TPU kernel, which this kernel does not do.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("bench_fwd_step times a CUDA device")
    rc = bench_pose(volume_size, viewport, device)
    times = time_cuda(lambda: fwd_v3.render_float(rc), iters)
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
