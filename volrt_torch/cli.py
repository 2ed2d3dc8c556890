"""Command-line interface of the port: ``render`` and ``info``.

    python -m volrt_torch.cli render -r 5 --synthetic 256 -s 1024 1024 \\
        --device cuda -o out.png
    python -m volrt_torch.cli info

The render flags are those of ``volrt``'s (``volrt/cli.py:18-51``) that the
port supports. Volume files (``-f``) need a jax-free copy of the PVM
loader and are still to come.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--synthetic", type=int, default=64,
                   help="synthetic volume size")
    p.add_argument("-r", "--renderer", type=int, default=5,
                   help="renderer id; only 5 (pallas-v3) is ported")
    p.add_argument("-s", "--size", type=int, nargs=2, default=(512, 512),
                   metavar=("W", "H"), help="viewport size")
    p.add_argument("--scale", type=float, default=1.0,
                   help="viewport scale factor (reference GLUI slider)")
    p.add_argument("--ray-step", type=float, default=None)
    p.add_argument("--ray-threshold", type=float, default=0.95)
    p.add_argument("--no-esl", action="store_true")
    p.add_argument("--no-ert", action="store_true")
    p.add_argument("--light-kd", type=float, default=0.6)
    p.add_argument("--shading", choices=("diffuse", "phong"),
                   default="diffuse",
                   help="diffuse = reference one-tap shading; phong is not "
                   "ported yet")
    p.add_argument("--angles", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   help="camera orbit angles (deg)")
    p.add_argument("--distance", type=float, default=3.0)
    p.add_argument("--perspective", action="store_true")
    p.add_argument("--tf", default=None,
                   help=".npy transfer-function LUT (128x4 RGBA)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda or cpu)")


def _make_rc(args):
    from volrt_torch.bench.harness import synthetic_volume
    from volrt_torch.core.tf import load_tf
    from volrt_torch.core.types import Volume, make_raycaster
    from volrt_torch.core.view import Camera

    device = torch.device(args.device)
    base_tf = load_tf(args.tf, device) if args.tf else None
    volume = Volume.from_numpy(synthetic_volume(args.synthetic), device)
    w, h = args.size
    cam = Camera(dims=(int(w * args.scale), int(h * args.scale)),
                 perspective=args.perspective)
    cam.toggle_perspective(update_mode=True)
    cam.set_camera_position(tuple(args.angles), args.distance)
    return make_raycaster(
        volume,
        view=cam.view(device),
        base_transfer_fn=base_tf,
        ray_step=args.ray_step,
        ray_threshold=1.1 if args.no_ert else args.ray_threshold,
        esl=not args.no_esl,
        light_kd=args.light_kd,
        shading=args.shading,
    )


def cmd_render(args) -> int:
    from volrt_torch.core import sampling
    from volrt_torch.renderers import get_renderer
    from volrt_torch.viz import write_png

    mod = get_renderer(args.renderer)
    rc = _make_rc(args)
    t0 = time.perf_counter()
    fimg, _ = mod.render_float(rc)
    img = sampling.write_color(fimg).cpu().numpy()
    dt = time.perf_counter() - t0
    write_png(args.output, img[::-1])  # y-up buffer -> top-down PNG
    print(f"rendered {img.shape[1]}x{img.shape[0]} with {mod.NAME} on "
          f"{rc.device} in {dt * 1e3:.1f} ms (first call) "
          f"-> {args.output}", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    """Device report (reference: VolR.cpp:175-193)."""
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
    print(json.dumps(info, indent=2))
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

    p = sub.add_parser("info", help="device info")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
