"""Command-line interface of the port: ``render``, ``fit``, ``bench`` and
``info``.

    python -m volrt_torch.cli render -f volume.pvm -s 512 512 -o out.png
    python -m volrt_torch.cli render -r 5 --synthetic 256 -s 1024 1024 \\
        -o out.png
    python -m volrt_torch.cli fit --fused --train both --synthetic 256 \\
        -s 1024 1024 --steps 100
    python -m volrt_torch.cli bench
    python -m volrt_torch.cli info -f volume.pvm

Everything runs on the card unless ``--device cpu`` is given. The flags are
those of ``volrt``'s (``volrt/cli.py:18-51, 509-550``) that the port
supports; ``render`` takes renderer 3 with the leading empty-space leap by
default, as ``volrt``'s does. ``--shading phong`` renders on renderers 0-1
(torch ops) and 5 (the kernel's phong mode), refuses renderers 2-4, and
trains with or without ``--fused``. ``fit`` takes ``render``'s arguments, so
it fits a PVM or RAW file (``-f``) or the synthetic volume; its
``--checkpoint``, ``--checkpoint-every`` and ``--resume`` reach ``fit()``,
which refuses them until checkpoints are ported; its ``--esl`` trains
with empty-space skipping (the one-launch step's ESL mode with
``--fused``, the oracle's leading leap without). ``render`` leaps or
skips empty space unless ``--no-esl`` is given (the leading leap on
renderers 0-4, the kernel's sample skipping on renderer 5). Still to come:
``--orbit`` and ``--background`` of ``render``; ``--dist`` and
``--grad-chunks`` of ``fit``.
"""
from __future__ import annotations

import argparse
import json
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


def cmd_render(args) -> int:
    from volrt_torch.core import sampling
    from volrt_torch.renderers import get_renderer
    from volrt_torch.viz import write_png

    mod = get_renderer(args.renderer)
    rc = _make_rc(args)
    t0 = time.perf_counter()
    fimg = mod.render_float(rc)
    if isinstance(fimg, tuple):  # rungs 3-5 also return an overflow count
        fimg = fimg[0]
    img = sampling.write_color(fimg).cpu().numpy()
    dt = time.perf_counter() - t0
    write_png(args.output, img[::-1])  # y-up buffer -> top-down PNG
    print(f"rendered {img.shape[1]}x{img.shape[0]} with {mod.NAME} on "
          f"{rc.device} in {dt * 1e3:.1f} ms (first call) "
          f"-> {args.output}", file=sys.stderr)
    return 0


def cmd_fit(args) -> int:
    """Inverse rendering demo: recover a density volume, a TF or both from
    four rendered views of the volume (``volrt/cli.py:305``)."""
    from volrt_torch.core.tf import default_transfer_fn
    from volrt_torch.core.types import default_ray_step
    from volrt_torch.core.view import Camera
    from volrt_torch.diff.render import (
        DiffScene, render_diff_image, scene_from_volume)
    from volrt_torch.train.fit import fit

    device = torch.device(args.device)
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
    print(f"rendered {len(targets)} target views in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr)

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
        log_every=max(1, args.steps // 10),
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        fused=args.fused, shading=shading, light_kd=args.light_kd,
        esl=args.esl)
    if losses:
        print(f"final loss {losses[-1]:.6f} after {len(losses)} steps in "
              f"{time.perf_counter() - t0:.2f} s on {device}",
              file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    """The headline line: the one-launch L2 step and the forward render at
    256^3 / 1024^2, under the key names of ``volrt``'s root ``bench.py``
    (no ``mfu`` and no ``vs_baseline``: both are defined against a TPU)."""
    from volrt_torch.bench.harness import bench_diff_step, bench_fwd_step

    m = bench_diff_step(args.synthetic, args.size, iters=args.iters,
                        fused=True, onepass=True, device=args.device)
    f = bench_fwd_step(args.synthetic, args.size, iters=args.iters,
                       device=args.device)
    print(json.dumps({
        "metric": "diff_fwd_bwd_ray_steps_per_s",
        "value": m["ray_steps_per_s"],
        "unit": "rays*steps/s",
        "ms": m["ms"],
        "ms_p90": m["ms_p90"],
        "loss": m["loss"],
        "fwd_ms": f["ms"],
        "fwd_ray_steps_per_s": f["ray_steps_per_s"],
        "iters": args.iters,
        "device": m["device"],
        "precision": m["precision"],
    }))
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="volrt_torch",
        description="volume raycaster on PyTorch and CUDA (port of volrt)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render one frame to PNG")
    _add_render_args(p)
    p.add_argument("-o", "--output", default="out.png")
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
                   help="TrainState checkpoint path (not ported yet)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save the checkpoint every N steps (not ported yet)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint (not ported yet)")
    p.add_argument("--fused", action="store_true",
                   help="train through the one-launch L2 step kernel")
    p.add_argument("--esl", action="store_true",
                   help="skip TF-empty space during training (the "
                   "kernel's sample skipping with --fused, the leading "
                   "leap without; the TF gets no gradient from skipped "
                   "samples)")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser(
        "bench", help="time the L2 step and the forward render; prints "
        "one JSON line")
    p.add_argument("--synthetic", type=int, default=256,
                   help="synthetic volume size")
    p.add_argument("-s", "--size", type=int, default=1024,
                   help="viewport edge")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="a CUDA device; the bench refuses the CPU")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("info", help="device and volume info")
    p.add_argument("-f", "--file", default=None)
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
