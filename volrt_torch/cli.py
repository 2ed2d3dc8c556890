"""Command-line interface of the port: ``render``, ``fit``, ``bench`` and
``info``.

    python -m volrt_torch.cli render -f volume.pvm -s 512 512 -o out.png
    python -m volrt_torch.cli render -r 5 --synthetic 256 -s 1024 1024 \\
        -o out.png
    python -m volrt_torch.cli render --orbit 8 --background 0.25 -o orb.png
    python -m volrt_torch.cli fit --fused --train both --synthetic 256 \\
        -s 1024 1024 --steps 100 --checkpoint fit.npz --resume
    python -m volrt_torch.cli bench --small -f volume.pvm -o report.csv
    python -m volrt_torch.cli info -f volume.pvm

Everything runs on the card unless ``--device cpu`` is given. The flags are
``volrt``'s (``volrt/cli.py``) that the port supports; ``render`` takes
renderer 3 with the leading empty-space leap by default, as ``volrt``'s
does. ``--shading phong`` renders on renderers 0-1 (torch ops) and 5 (the
kernel's phong mode), refuses renderers 2-4, and trains with or without
``--fused``. ``render --orbit N`` writes N frames ``<base>_%04d.png`` round
the volume (360/N degrees a frame), ``--background`` composites over a
grey as the reference's display does, ``--nosafe`` carries an orbit on past
a frame that fails; a frame that runs out of the card's memory is
rendered again in row bands. ``fit`` takes ``render``'s arguments, so it
fits a PVM or RAW file (``-f``) or the synthetic volume; ``--checkpoint``
(a ``.npz`` file that ``volrt`` reads too), ``--checkpoint-every`` and
``--resume`` save and resume; ``--esl`` trains with empty-space skipping.
``bench`` is ``volrt``'s suite (``default_suite``'s configs, every rung,
eight poses; ``--diff`` adds the training steps, in ``volrt``'s fast mode
with ``--fast``; ``-o`` writes the tables as CSV); the one-line headline
is ``python -m volrt_torch.bench``. ``fit --fused`` trains in ``volrt``'s
fast mode (the density stored as bf16 for the kernels), as ``volrt``'s
does.
``--log FILE`` writes the session to ``FILE`` and echoes it to stdout
(``volrt``'s default is ``volrt.log``; the port writes no file unless
asked). Not ported: ``bench --sharded``, ``fit --dist`` (both with
``dist/``), and ``--window``, ``--strict-overflow`` and ``--grad-chunks``
(TPU windows and memory budgets).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-f", "--file", help="PVM or RAW volume file "
                   "(default: the built-in synthetic volume)")
    p.add_argument("--synthetic", type=int, default=64,
                   help="synthetic volume size if no file is given")
    p.add_argument("-r", "--renderer", type=int, default=3,
                   help="renderer id 0-5 (reference: -r flag; 5 = pallas-v3, "
                   "the flagship)")
    p.add_argument("-s", "--size", type=int, nargs=2, default=(512, 512),
                   metavar=("W", "H"), help="viewport size")
    p.add_argument("--scale", type=float, default=1.0,
                   help="viewport scale factor (reference GLUI slider)")
    p.add_argument("--ray-step", type=float, default=None)
    p.add_argument("--ray-threshold", type=float, default=0.95)
    p.add_argument("--no-esl", action="store_true",
                   help="march every sample: no leap over leading empty "
                   "space (renderers 0-4), no skipping of empty samples "
                   "(renderer 5)")
    p.add_argument("--no-ert", action="store_true")
    p.add_argument("--light-kd", type=float, default=0.6)
    p.add_argument("--shading", choices=("diffuse", "phong"),
                   default="diffuse",
                   help="diffuse = reference one-tap shading; phong = "
                   "gradient Blinn-Phong (renderers 0, 1 and 5)")
    p.add_argument("--interpolation", choices=("nearest", "trilinear"),
                   default=None,
                   help="default: nearest for renderers 0-2, trilinear 3-5")
    p.add_argument("--angles", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   help="camera orbit angles (deg)")
    p.add_argument("--distance", type=float, default=3.0)
    p.add_argument("--perspective", action="store_true")
    p.add_argument("--tf", default=None,
                   help=".npy transfer-function LUT (128x4 RGBA)")
    p.add_argument("--raw-dims", type=int, nargs=3, default=None,
                   metavar=("W", "H", "D"),
                   help="dimensions for headerless .raw volumes")
    p.add_argument("--raw-components", type=int, default=1,
                   help=".raw voxel components (2 = 16-bit, quantized)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda or cpu)")


def _load_volume(args) -> np.ndarray:
    if args.file:
        from volrt_torch.io.pvm import load_volume

        data, _ = load_volume(
            args.file,
            raw_dims=tuple(args.raw_dims) if args.raw_dims else None,
            raw_components=args.raw_components)
        return data
    from volrt_torch.bench.harness import synthetic_volume

    return synthetic_volume(args.synthetic)


def _make_rc(args):
    from volrt_torch.core.tf import load_tf
    from volrt_torch.core.types import Volume, make_raycaster
    from volrt_torch.core.view import Camera

    device = torch.device(args.device)
    base_tf = load_tf(args.tf, device) if args.tf else None
    volume = Volume.from_numpy(_load_volume(args), device)
    w, h = args.size
    cam = Camera(dims=(int(w * args.scale), int(h * args.scale)),
                 perspective=args.perspective)
    cam.toggle_perspective(update_mode=True)
    cam.set_camera_position(tuple(args.angles), args.distance)
    interp = args.interpolation
    if interp is None:
        interp = "trilinear" if args.renderer >= 3 else "nearest"
    return make_raycaster(
        volume,
        view=cam.view(device),
        base_transfer_fn=base_tf,
        ray_step=args.ray_step,
        ray_threshold=1.1 if args.no_ert else args.ray_threshold,
        esl=not args.no_esl,
        light_kd=args.light_kd,
        interpolation=interp,
        shading=args.shading,
    )


def _logger(path):
    """``volrt``'s session logger on ``path`` (echoed to stdout), or a
    silent one that writes nowhere when no ``--log`` is given."""
    from volrt_torch.utils.logger import Logger

    return Logger(path) if path else Logger(path=None, quiet=True)


def _render_frame(mod, rc, log) -> np.ndarray:
    """One frame as a ``uint8[H, W, 4]`` y-up buffer; a frame that runs out
    of the card's memory is rendered again in row bands, on the same card
    with the same kernel (``utils/errors.py``)."""
    from volrt_torch.core import sampling
    from volrt_torch.utils.errors import render_with_oom_fallback

    def one(sub_rc):
        out = mod.render_float(sub_rc)
        return out if isinstance(out, tuple) else (out, 0.0)

    fimg, _ = render_with_oom_fallback(one, rc, log=log)
    return sampling.write_color(fimg).cpu().numpy()


def _composite_bg(img: np.ndarray, bg: float) -> np.ndarray:
    """Composite the premultiplied uint8 frame over a grey background as
    the reference's display blends it (GL_SRC_ALPHA / ONE_MINUS_SRC_ALPHA
    over glClearColor(bg, bg, bg); reference: UI.cpp:122-128, 431-433) ->
    ``(H, W, 3)`` uint8. ``volrt/cli.py:_composite_bg``, op for op."""
    f = img.astype(np.float32) / 255.0
    a = f[..., 3:4]
    rgb = f[..., :3] * a + bg * (1.0 - a)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def cmd_render(args) -> int:
    from volrt_torch.core.view import Camera
    from volrt_torch.renderers import get_renderer, renderer_name
    from volrt_torch.utils.errors import safe_call
    from volrt_torch.viz import write_png

    log = _logger(args.log)
    mod = get_renderer(args.renderer)
    rc = _make_rc(args)
    log.log_time("rendering with %s ...", renderer_name(args.renderer))
    if args.orbit <= 1:
        t0 = time.perf_counter()
        img = _render_frame(mod, rc, log)
        dt = time.perf_counter() - t0
        if args.background is not None:
            img = _composite_bg(img, args.background)
        write_png(args.output, img[::-1])  # y-up buffer -> top-down PNG
        log.log_time("wrote %s (%dx%d)", args.output, img.shape[1],
                     img.shape[0])
        print(f"rendered {img.shape[1]}x{img.shape[0]} with {mod.NAME} on "
              f"{rc.device} in {dt * 1e3:.1f} ms (first call) "
              f"-> {args.output}", file=sys.stderr)
        return 0

    # The orbit: the offline counterpart of the reference's auto-rotate
    # (reference: UI.cpp:132-139), a new camera per frame.
    base, ext = (args.output.rsplit(".", 1) + ["png"])[:2]
    step_deg = 360.0 / args.orbit
    cam = Camera(dims=rc.view.dims, perspective=args.perspective)
    cam.toggle_perspective(update_mode=True)
    cam.set_camera_position(tuple(args.angles), args.distance)
    for i in range(args.orbit):
        frame_rc = rc.replace(view=cam.view(rc.device))
        # --nosafe carries on past a frame that fails (reference:
        # VolR.cpp:404-406, cuda_utils.h:28-29).
        img, err = safe_call(_render_frame, mod, frame_rc, log, log=log,
                             nosafe=args.nosafe, what=f"orbit frame {i}")
        if err is None:
            path = f"{base}_{i:04d}.{ext}"
            if args.background is not None:
                img = _composite_bg(img, args.background)
            write_png(path, img[::-1])
            log.log_time("frame %d/%d -> %s", i + 1, args.orbit, path)
        cam.rotate((0.0, step_deg, 0.0))
    print(f"rendered {args.orbit} orbit frames with {mod.NAME} on "
          f"{rc.device} -> {base}_*.{ext}", file=sys.stderr)
    return 0


def _fit_rank(rank: int, size: int, args) -> None:
    """One spawned rank of ``fit --dist ... --ranks N``."""
    cmd_fit(args)


def _fit_mesh(args, device: torch.device):
    """The mesh of ``fit --dist rays|volume``: the process group that is up
    (``torchrun``'s, read from its environment, or a spawned rank's), else a
    mesh of one rank."""
    import torch.distributed as dist

    from volrt_torch.dist.mesh import init_distributed, make_mesh

    if not dist.is_initialized() and "RANK" in os.environ:
        init_distributed(args.backend)
    # A bare "cuda" is the rank's card (make_mesh: cuda:LOCAL_RANK).
    return make_mesh(None if device == torch.device("cuda") else device)


def cmd_fit(args) -> int:
    """Inverse rendering demo: recover a density volume, a TF or both from
    four rendered views of the volume (``volrt/cli.py:305``).

    ``--dist rays|volume`` trains over a mesh (``train/fit.py``): under
    ``torchrun`` one rank a process; otherwise ``--ranks N`` local ranks
    spawned here on ``--backend`` (``gloo`` by default, which also lets
    several ranks share one card). Rank 0 logs and writes the
    checkpoint."""
    import torch.distributed as dist

    from volrt_torch.core.tf import default_transfer_fn
    from volrt_torch.core.types import default_ray_step
    from volrt_torch.core.view import Camera
    from volrt_torch.diff.render import (
        DiffScene, render_diff_image, scene_from_volume)
    from volrt_torch.train.fit import fit

    if (args.dist != "none" and args.ranks > 1 and not dist.is_initialized()
            and "RANK" not in os.environ):
        from volrt_torch.dist.mesh import spawn

        spawn(_fit_rank, args.ranks, args, backend=args.backend)
        return 0
    device = torch.device(args.device)
    mesh = None if args.dist == "none" else _fit_mesh(args, device)
    if mesh is not None:
        device = mesh.device
    lead = mesh is None or mesh.rank == 0
    log = _logger(args.log if lead else None)
    data = _load_volume(args)
    step = args.ray_step or default_ray_step(data.shape)
    tf_base = default_transfer_fn(device)
    # The ground-truth scene renders the targets.
    gt = scene_from_volume(data, tf_base, step, device=device)
    shading = args.shading
    t0 = time.perf_counter()
    targets = []
    for ax, ay in [(0, 0), (0, 90), (90, 0), (45, 45)]:
        cam = Camera(dims=tuple(args.size))
        cam.set_camera_position((ax, ay, 0.0))
        view = cam.view(device)
        with torch.no_grad():
            targets.append((view, render_diff_image(
                gt, view, light_kd=args.light_kd if shading else 0.0,
                shaded=shading == "diffuse", phong=shading == "phong")))
    if lead:
        print(f"rendered {len(targets)} target views in "
              f"{time.perf_counter() - t0:.2f} s", file=sys.stderr)
    if mesh is not None:
        log.log("dist=%s over %d ranks", args.dist, mesh.size)

    # Init per training target: density fits start from a constant (zero
    # density has a vanishing TF-lerp gradient); TF fits keep the true
    # density and start from a flat half-intensity LUT.
    train = args.train
    density = (gt.density.detach().clone() if train == "tf"
               else torch.full_like(gt.density, 0.3))
    init_tf = (torch.full_like(tf_base, 0.5) if train in ("tf", "both")
               else tf_base)
    scene = DiffScene(density, init_tf, step)
    t0 = time.perf_counter()
    scene, losses = fit(
        scene, targets, steps=args.steps, lr=args.lr,
        train_density=train in ("density", "both"),
        train_tf=train in ("tf", "both"),
        log_every=max(1, args.steps // 10) if lead else 0,
        logger=log if (args.log and lead) else None,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        fused=args.fused, shading=shading, light_kd=args.light_kd,
        esl=args.esl, mesh=mesh, volume_sharded=args.dist == "volume")
    if losses:
        log.log_time("final loss %.6f", losses[-1])
        if lead:
            print(f"final loss {losses[-1]:.6f} after {len(losses)} steps "
                  f"in {time.perf_counter() - t0:.2f} s on {device}",
                  file=sys.stderr)
    else:
        log.log("nothing to do: checkpoint already at %d steps", args.steps)
    return 0


def cmd_bench(args) -> int:
    """``volrt``'s benchmark suite (``volrt/cli.py:262-302``): the forward
    sweep over ``default_suite``'s configs and the chosen rungs, with
    ``--diff`` the training steps, then the avg, max, samples and roofline
    tables, on stdout and, with ``-o``, as CSV."""
    from volrt_torch.bench.harness import (
        default_suite, run_diff_suite, run_suite)

    if args.sharded and torch.device(args.device).type != "cuda":
        raise ValueError("bench --sharded times CUDA devices (its ranks run "
                         "render_float_sharded on the card)")
    log = _logger(args.log)
    prof = run_suite(
        configs=default_suite(small=args.small, files=args.files),
        renderers=tuple(args.renderers), frames=args.frames, logger=log,
        trace_dir=args.trace_dir, device=args.device)
    if args.diff:
        diff_cfgs = [(64, 256), (128, 512)] if args.small else None
        run_diff_suite(configs=diff_cfgs, frames=max(2, args.frames // 2),
                       profiler=prof, logger=log, device=args.device,
                       fast=args.fast)
    if args.sharded:
        from volrt_torch.bench.harness import bench_sharded_render

        m = bench_sharded_render(
            volume_size=64 if args.small else 128,
            viewport=256 if args.small else 512,
            iters=max(2, args.frames // 2), ranks=args.ranks,
            device=args.device)
        shared = (f" (the {m['devices']} ranks share {m['cards']} card(s): "
                  f"the efficiency is how the card takes their turns, not "
                  f"scaling)" if m["cards"] < m["devices"] else "")
        (log.log if args.log else print)(
            f"sharded render over {m['devices']} ranks: {m['ms_ndev']:.2f} "
            f"ms (1 rank {m['ms_1dev']:.2f} ms), scaling efficiency "
            f"{m['scaling_efficiency']:.3f}{shared}")
    tables = [prof.print_avg(), prof.print_max(), prof.print_samples(),
              prof.print_roofline()]
    for table in tables:
        (log.log if args.log else print)(table)
    if args.output:
        with open(args.output, "w") as f:
            f.write("\n\n".join(tables) + "\n")
    return 0


def cmd_info(args) -> int:
    """Device and volume report (reference: VolR.cpp:175-193)."""
    cuda = torch.cuda.is_available()
    info = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if cuda else []),
        "numpy_version": np.__version__,
    }
    if args.file:
        from volrt_torch.io.pvm import load_volume

        vol, meta = load_volume(args.file)
        info["volume"] = {
            "shape_zyx": list(vol.shape),
            "dtype": str(vol.dtype),
            **{k: (list(v) if isinstance(v, tuple) else v)
               for k, v in meta.items()},
        }
    print(json.dumps(info, indent=2, default=str))
    return 0


def parser() -> argparse.ArgumentParser:
    """The CLI's argument parser: ``parser().parse_args(["render", ...])``
    gives a command's arguments with their defaults."""
    parser = argparse.ArgumentParser(
        prog="volrt_torch",
        description="volume raycaster on PyTorch and CUDA (port of volrt)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render one frame to PNG")
    _add_render_args(p)
    p.add_argument("--orbit", type=int, default=1,
                   help="render N orbit frames (auto-rotate analog)")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--log", default=None,
                   help="write the session to this file too (volrt's "
                   "default is volrt.log; none unless given)")
    p.add_argument("--background", type=float, default=None,
                   metavar="GRAY",
                   help="composite over a grayscale background in [0, 1] "
                        "(the reference UI's Background slider, default "
                        "0.25 there); omit to keep straight RGBA")
    p.add_argument("--nosafe", action="store_true",
                   help="continue past per-frame render errors in orbit "
                   "sequences (reference: -nosafe, cuda_utils.h:28-29)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("fit", help="inverse-rendering fit demo")
    _add_render_args(p)
    # Fits are unshaded unless --shading is given explicitly (render's
    # default of diffuse would change the targets without a word).
    p.set_defaults(shading=None)
    p.add_argument("--train", choices=["density", "tf", "both"],
                   default="density",
                   help="which scene parameters to optimise (the kernel "
                   "skips the scatter of a frozen one)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--checkpoint", default=None,
                   help="TrainState checkpoint path (.npz, the format "
                   "volrt reads and writes)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save the checkpoint every N steps (0 = only at "
                   "the end)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--fused", action="store_true",
                   help="train through the one-launch L2 step kernel, in "
                   "volrt's fast mode (bf16 density, f32 gradients)")
    p.add_argument("--esl", action="store_true",
                   help="skip TF-empty space during training (the "
                   "kernel's sample skipping with --fused, the leading "
                   "leap without; the TF gets no gradient from skipped "
                   "samples)")
    p.add_argument("--dist", choices=["none", "rays", "volume"],
                   default="none",
                   help="train over a mesh of ranks: rays = ray-row data "
                   "parallelism (volume replicated, gradients summed); "
                   "volume = Z-slab volume sharding (a slab a rank). Under "
                   "torchrun one rank a process, else --ranks local ranks")
    p.add_argument("--ranks", type=int, default=1,
                   help="with --dist and no torchrun: local ranks to spawn "
                   "(several may share one card on gloo)")
    p.add_argument("--backend", choices=["gloo", "nccl"], default="gloo",
                   help="torch.distributed backend of --dist (nccl: one "
                   "card a rank)")
    p.add_argument("--log", default=None,
                   help="write the session to this file too (volrt's "
                   "default is volrt.log; none unless given)")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser(
        "bench", help="run the benchmark suite (the one-line headline is "
        "python -m volrt_torch.bench)")
    p.add_argument("-f", "--files", nargs="*", default=None,
                   help="PVM/RAW dataset files to bench, a config each")
    p.add_argument("--renderers", type=int, nargs="+",
                   default=[0, 1, 2, 3, 4, 5],
                   help="ladder rungs to sweep (the golden rung 0 skips "
                   "heavy configs)")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--small", action="store_true")
    p.add_argument("--trace-dir", default=None,
                   help="keep a torch.profiler trace of each cell's timed "
                   "frames here")
    p.add_argument("--diff", action="store_true",
                   help="append the training steps' rows (the two-kernel "
                   "and the one-launch L2 step)")
    p.add_argument("--fast", action="store_true",
                   help="run --diff's steps in volrt's fast mode (bf16 "
                   "density), as volrt's suite does; f32 without")
    p.add_argument("--sharded", action="store_true",
                   help="the sharded render over --ranks ranks against one "
                   "(under torchrun, its ranks)")
    p.add_argument("--ranks", type=int, default=2,
                   help="local ranks that --sharded spawns on gloo")
    p.add_argument("-o", "--output", default=None, help="CSV report path")
    p.add_argument("--log", default=None,
                   help="write the session to this file too")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("info", help="device and volume info")
    p.add_argument("-f", "--file", default=None)
    p.set_defaults(fn=cmd_info)

    return parser


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
