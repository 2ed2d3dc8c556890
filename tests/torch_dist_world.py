"""What the ranks of ``tests/test_torch_dist.py``'s world run.

One ``gloo`` world of four CPU ranks (``volrt_torch.dist.mesh``'s rank
entry) runs every check of the port's ``dist/`` and writes what it found
to ``.npz`` files, one a case, which the tests read and hold against
``volrt``, computed in the test's own process. This module imports only
numpy, torch and ``volrt_torch``: the ranks are new processes and must not
load JAX.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from volrt_torch import cli, graft
from volrt_torch.core.types import Volume, make_raycaster
from volrt_torch.core.view import Camera
from volrt_torch.diff.render import render_diff_image, scene_from_volume
from volrt_torch.dist import volume_sharded as vs
from volrt_torch.dist.mesh import make_mesh, sub_mesh
from volrt_torch.dist.render import (
    l2_loss_grads_v3_sharded, render_float_sharded)
from volrt_torch.renderers import diff_v3, get_renderer
from volrt_torch.train.fit import fit

CPU = "cpu"
DIMS = (16, 16)
POSE = (25.0, 10.0, 0.0)
# (name, ranks, backend, shading, pose, ray_threshold, esl, volume)
SHARDED = [
    ("2-xla", 2, "xla", None, POSE, 0.6, False, "synthetic"),
    ("2-pallas", 2, "pallas", None, POSE, 0.6, False, "synthetic"),
    ("4-xla", 4, "xla", None, POSE, 0.6, False, "synthetic"),
    ("4-pallas", 4, "pallas", None, POSE, 0.6, False, "synthetic"),
    ("4-pallas-diffuse", 4, "pallas", "diffuse", POSE, 0.95, False,
     "synthetic"),
    ("4-xla-phong", 4, "xla", "phong", POSE, 0.95, False, "synthetic"),
    ("4-pallas-esl", 4, "pallas", None, POSE, 0.6, True, "synthetic"),
    ("boundary-2", 2, "pallas", None, (0.0, 0.0, 0.0), 2.0, False,
     "uniform"),
    ("boundary-4", 4, "pallas", None, (0.0, 0.0, 0.0), 2.0, False,
     "uniform"),
]
# render_float_sharded: (renderer, interpolation, ranks, viewport (W, H)).
ROWS = [
    ("pallas-trilinear", "trilinear", 2, (16, 16)),
    ("pallas-trilinear", "nearest", 4, (24, 18)),
    ("pallas-blocked", "trilinear", 2, (16, 16)),
    ("pallas-blocked", "trilinear", 4, (24, 18)),
    ("pallas-v3", "trilinear", 2, (16, 16)),
    ("pallas-v3", "trilinear", 4, (24, 18)),
]
# l2_loss_grads_v3_sharded: (name, ranks, viewport, shading, esl, fast);
# the first is held to volrt's f32 autodiff too, the fast one to volrt's
# fast one-launch step.
STEPS = [
    ("2", 2, (16, 16), None, False, False),
    ("4-uneven", 4, (24, 18), None, False, False),
    ("2-diffuse", 2, (16, 16), "diffuse", False, False),
    ("4-esl", 4, (16, 16), None, True, False),
    ("2-fast", 2, (16, 16), None, False, True),
]
FIT_STEPS = 3
FIT_LR = 0.02


def view_of(pose, dims=DIMS):
    cam = Camera(dims=dims)
    cam.set_camera_position(pose)
    return cam.view(CPU)


def target_of(dims) -> np.ndarray:
    """The step cases' target image ``f32[H, W, 4]``, from a seed."""
    return (np.random.default_rng(7).random((dims[1], dims[0], 4))
            * 0.5).astype(np.float32)


def _scene(data, which):
    return scene_from_volume(data[which], data["tf"], data["steps"][which],
                             device=CPU)


def _save(out, name, **arrays):
    np.savez(os.path.join(out, name + ".npz"), **{
        k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
        for k, v in arrays.items()})


def _collectives(mesh, out):
    r = mesh.rank
    every = mesh.all_gather(torch.full((2, 3), float(r)))
    total = mesh.all_reduce(torch.full((3,), float(r + 1)))
    top = mesh.all_reduce(torch.tensor([r, -r], dtype=torch.int32), op="max")
    pair = sub_mesh(mesh, [1, 2])
    sub = None if pair is None else pair.all_gather(torch.tensor([float(r)]))
    found = mesh.all_gather(torch.tensor(
        [float(pair.rank if pair else -1),
         float(sub.flatten().sum() if sub is not None else -1)]))
    if r == 0:
        _save(out, "collectives", every=every, total=total, top=top,
              sub=found, size=mesh.size)


def _sharded(mesh, meshes, data, out):
    for name, n, backend, shading, pose, thr, esl, which in SHARDED:
        m = meshes[n]
        if m is None:
            continue
        scene = _scene(data, which)
        img = vs.render_volume_sharded(
            scene, view_of(pose), m, ray_threshold=thr, backend=backend,
            shading=shading, light_kd=0.6, esl=esl)
        (img ** 2).mean().backward()
        sd = scene.density.shape[0] // n
        own = scene.density.grad[m.rank * sd:(m.rank + 1) * sd]
        rest = scene.density.grad.clone()
        rest[m.rank * sd:(m.rank + 1) * sd] = 0.0
        dens = m.all_gather(own).reshape(scene.density.shape)
        leak = m.all_reduce(rest.abs().max().reshape(1))
        tfs = m.all_gather(scene.tf_base.grad)
        imgs = m.all_gather(img.detach())
        if m.rank == 0:
            _save(out, "sharded-" + name, img=img, d_density=dens,
                  d_tf=tfs[0], tf_spread=(tfs - tfs[0]).abs().max(),
                  img_spread=(imgs - imgs[0]).abs().max(), leak=leak)
    mesh.barrier()


def _slabs(mesh, data, out):
    """The host split and the halo exchange against ``shard_slabs``."""
    density = torch.from_numpy(data["synthetic"]).float() / 255.0
    for halo in (1, 3):
        want = vs.shard_slabs(density, mesh.size, halo)[mesh.rank]
        host = vs.shard_slabs_to_devices(density.numpy(), mesh, halo)
        sd = density.shape[0] // mesh.size
        own = density[mesh.rank * sd:(mesh.rank + 1) * sd]
        ref = vs.refresh_halos(own, mesh, halo, density.shape[0])
        ok = mesh.all_gather(torch.tensor([
            float(torch.equal(host.slab, want)),
            float(torch.equal(ref.slab, want)),
            float(host.z_start == ref.z_start == mesh.rank * sd)]))
        if mesh.rank == 0:
            _save(out, f"slabs-{halo}", ok=ok)


def _rows(mesh, meshes, data, out):
    for renderer, interp, n, dims in ROWS:
        m = meshes[n]
        if m is None:
            continue
        vol = Volume.from_numpy(data["synthetic"], CPU)
        rc = make_raycaster(vol, view_of(POSE, dims), ray_threshold=0.95,
                            light_kd=0.6, interpolation=interp)
        img, ovf = render_float_sharded(rc, m, renderer=renderer)
        rung = {"pallas-trilinear": 2 if interp == "nearest" else 3,
                "pallas-blocked": 4, "pallas-v3": 5}[renderer]
        whole = get_renderer(rung).render_float(rc)
        whole = whole[0] if isinstance(whole, tuple) else whole
        same = m.all_gather(torch.tensor([float(torch.equal(img, whole)),
                                          float(ovf)]))
        if m.rank == 0:
            _save(out, f"rows-{renderer}-{interp}-{n}", img=img, same=same)
    mesh.barrier()


def _steps(mesh, meshes, data, out):
    for name, n, dims, shading, esl, fast in STEPS:
        m = meshes[n]
        if m is None:
            continue
        scene = _scene(data, "synthetic")
        view = view_of(POSE, dims)
        target = torch.from_numpy(target_of(dims))
        loss, g = l2_loss_grads_v3_sharded(scene, view, target, m,
                                           shading=shading, esl=esl,
                                           fast=fast)
        one, g1 = diff_v3.l2_loss_grads_v3_onepass(
            scene, view, target, esl=esl, shaded=shading == "diffuse",
            fast=fast)
        if m.rank == 0:
            _save(out, "step-" + name, loss=loss, d_density=g["density"],
                  d_tf=g["tf_base"], loss1=one, d_density1=g1["density"],
                  d_tf1=g1["tf_base"], target=target)
    mesh.barrier()


def fit_target(data) -> np.ndarray:
    """The fit cases' target: the oracle's image of the synthetic scene on
    the rotated pose."""
    with torch.no_grad():
        return render_diff_image(_scene(data, "synthetic"),
                                 view_of(POSE)).numpy()


def _fits(mesh, meshes, data, out):
    view = view_of(POSE)
    target = torch.from_numpy(fit_target(data))
    for name, n, kw in (("rays-2", 2, {}), ("rays-4-fused", 4,
                                            dict(fused=True)),
                        ("volume-2", 2, dict(volume_sharded=True)),
                        ("volume-4", 4, dict(volume_sharded=True))):
        m = meshes[n]
        if m is None:
            continue
        scene = _scene(data, "fit")
        ckpt = os.path.join(out, f"fit-{name}.ckpt.npz")
        scene, losses = fit(scene, [(view, target)], steps=FIT_STEPS,
                            lr=FIT_LR, mesh=m, checkpoint_path=ckpt, **kw)
        dens = m.all_gather(scene.density.detach())
        if m.rank == 0:
            _save(out, "fit-" + name, losses=np.asarray(losses),
                  density=dens[0], spread=(dens - dens[0]).abs().max())
    if mesh.rank == 0:
        # The fused fit on one rank, a second reference of the fast mode.
        _, losses = fit(_scene(data, "fit"), [(view, target)],
                        steps=FIT_STEPS, lr=FIT_LR, fused=True)
        _save(out, "fit-1-fused", losses=np.asarray(losses))
    mesh.barrier()


def _cli(mesh, out):
    for dist_mode in ("rays", "volume"):
        ckpt = os.path.join(out, f"cli-{dist_mode}.npz")
        code = cli.main(["fit", "--dist", dist_mode, "--synthetic", "16",
                         "-s", "16", "16", "--steps", "2", "--device", CPU,
                         "--checkpoint", ckpt])
        codes = mesh.all_gather(torch.tensor([float(code)]))
        if mesh.rank == 0:
            _save(out, "cli-" + dist_mode, codes=codes)


def run(rank: int, size: int, data: dict, out: str) -> None:
    """Every check, on rank ``rank`` of a world of ``size`` (4). One thread
    a rank: the ranks run beside the test session's other workers."""
    torch.set_num_threads(1)
    torch.manual_seed(0)
    mesh = make_mesh(CPU)
    meshes = {4: mesh, 2: sub_mesh(mesh, [0, 1]), 1: None}
    _collectives(mesh, out)
    _slabs(mesh, data, out)
    _sharded(mesh, meshes, data, out)
    _rows(mesh, meshes, data, out)
    _steps(mesh, meshes, data, out)
    _fits(mesh, meshes, data, out)
    _cli(mesh, out)
    graft.dryrun_multichip(size, device=CPU)
    mesh.barrier()
    if rank == 0:
        _save(out, "done", ok=1)
