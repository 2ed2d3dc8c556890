"""How the step kernels' adds collide: counts, not times.

    python -m volrt_torch.bench.scatter_stats --device cpu

Replays the backward's lattice (``k0 + i*step``, ERT off) for the rays of
``--warps`` random warps of the benchmark pose (a warp is two 16-pixel rows
of a kernel's 16x16 block) and counts, on scene ``a`` (the benchmark's
synthetic volume) and scene ``b`` (a uniform-noise f32 density, seed 5, as
``step_ab.py`` makes it):

- ``run``: samples per run of one TF row pair ``(lo, hi)`` along a ray;
- ``rows``: distinct TF rows ``lo`` among a warp-step's live lanes, and
  ``busiest``: lanes on the most shared one (the depth of the dTF adds'
  serialisation with one add per lane);
- ``voxels``: distinct voxels among a tap's adds in a warp-step, over the
  lanes whose sample has a TF slope (the v3 in-range rule), and ``lanes``
  their number;
- ``sloped``: the share of samples with a TF slope, which are the samples
  that add to dVol.

Prints one JSON object per scene. Every number is a count over this run's
rays, on whatever device the tensors are on.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from volrt_torch.bench.harness import diff_bench_scene
from volrt_torch.core import sampling
from volrt_torch.core.device import resolve_device
from volrt_torch.core.tf import default_transfer_fn
from volrt_torch.diff.render import scene_from_arrays
from volrt_torch.renderers import fwd_v3
from volrt_torch.renderers.cuda.march import max_steps

TF_SIZE = 128
NOISE_SEED = 5


def _axis(p: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The clamped tap indices along one axis, as march_common.cuh's."""
    i = torch.floor((p + 1.0) * 0.5 * n - 0.5).clamp(-1, n).long()
    return i.clamp(0, n - 1), (i + 1).clamp(0, n - 1)


def warp_stats(scene, view, warps: int, seed: int) -> dict:
    args, kw = fwd_v3.ray_args(view, scene.density.detach(),
                               scene.premult_tf().detach(), scene.ray_step,
                               2.0, 0.0)
    o, d, k0, kfar, alive, density, tf = args[:7]
    width = kw["width"]
    rng = np.random.default_rng(seed)
    blocks = (width // 16, o.shape[0] // width // 16)
    rays = []
    for _ in range(warps):
        bx, by = (rng.integers(b // 8, b - b // 8) for b in blocks)
        y = by * 16 + 2 * rng.integers(0, 8)
        rays += [(y + dy) * width + bx * 16 + x
                 for dy in (0, 1) for x in range(16)]
    idx = torch.tensor(rays, device=o.device)
    steps = max_steps(kw["ray_step"])
    k = k0[idx, None] + torch.arange(steps, device=o.device) * kw["ray_step"]
    live = (k <= kfar[idx, None]) & alive[idx, None]   # [rays, steps]
    pts = o[idx, None] + d[idx, None] * k[..., None]
    s = sampling.sample_trilinear_f(density, pts.reshape(-1, 3)).reshape(
        k.shape)
    tc = s * TF_SIZE - 0.5
    j = torch.floor(tc).clamp(-1, TF_SIZE).long()
    lo, hi = j.clamp(0, TF_SIZE - 1), (j + 1).clamp(0, TF_SIZE - 1)
    slope = (torch.cat([tf[1:] - tf[:-1], torch.zeros_like(tf[:1])])[lo]
             .abs().sum(-1) > 0)
    sloped = (slope & (tc > 0) & (tc < TF_SIZE - 1.0) & (s > 0) & (s < 1)
              & live)

    # Runs of one (lo, hi) pair along each ray.
    new_run = torch.ones_like(live)
    new_run[:, 1:] = (lo[:, 1:] != lo[:, :-1]) | (hi[:, 1:] != hi[:, :-1])
    n_samples = int(live.sum())
    n_runs = int((new_run & live).sum())

    taps = [_axis(pts[..., a], n) for a, n in
            ((2, density.shape[0]), (1, density.shape[1]),
             (0, density.shape[2]))]
    h, w = density.shape[1:]
    rows, busiest, voxels, lanes = [], [], [], []
    for wi in range(warps):
        sl = slice(32 * wi, 32 * wi + 32)
        for i in range(steps):
            m = live[sl, i]
            if m.any():
                _, counts = torch.unique(lo[sl, i][m], return_counts=True)
                rows.append(len(counts))
                busiest.append(int(counts.max()))
            m = sloped[sl, i]
            if not m.any():
                continue
            for z in taps[0]:
                for y in taps[1]:
                    for x in taps[2]:
                        addr = ((z[sl, i] * h + y[sl, i]) * w + x[sl, i])[m]
                        voxels.append(len(torch.unique(addr)))
                        lanes.append(int(m.sum()))
    return {"rays": len(rays), "samples": n_samples,
            "run": n_samples / n_runs, "rows": float(np.mean(rows)),
            "busiest": float(np.mean(busiest)),
            "voxels": float(np.mean(voxels)), "lanes": float(np.mean(lanes)),
            "sloped": int(sloped.sum()) / n_samples}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--viewport", type=int, default=1024)
    p.add_argument("--warps", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="where the replay runs (default: the card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    scene_a, view, _ = diff_bench_scene(args.size, args.viewport,
                                        device=device)
    noise = np.random.default_rng(NOISE_SEED).uniform(
        0.0, 1.0, (args.size,) * 3).astype(np.float32)
    scene_b = scene_from_arrays(noise, default_transfer_fn("cpu").numpy(),
                                scene_a.ray_step, device=device)
    for name, scene in (("a", scene_a), ("b", scene_b)):
        with torch.no_grad():
            out = warp_stats(scene, view, args.warps, args.seed)
        print(json.dumps({"scene": name, "size": args.size,
                          "viewport": args.viewport, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
