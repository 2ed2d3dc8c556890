"""Entry points that check the port from outside: a forward step to run on
one card and a dry run of the sharded paths (the counterparts of
``__graft_entry__.py``'s ``entry`` and ``dryrun_multichip``).

    python -c "import volrt_torch.graft as g; g.dryrun_multichip(4, device='cpu')"
"""
from __future__ import annotations

import math

import torch


def entry(device=None):
    """``(fn, example_args)``: the differentiable render of a 32^3
    synthetic volume at 64^2 (``render_diff_image``), on ``device`` (the
    card when ``None``)."""
    from volrt_torch.bench.harness import synthetic_volume
    from volrt_torch.core.device import resolve_device
    from volrt_torch.core.tf import default_transfer_fn
    from volrt_torch.core.types import default_ray_step
    from volrt_torch.core.view import Camera
    from volrt_torch.diff.render import render_diff_image, scene_from_volume

    dev = resolve_device(device)
    n = 32
    scene = scene_from_volume(synthetic_volume(n), default_transfer_fn(dev),
                              default_ray_step((n, n, n)), device=dev)
    view = Camera(dims=(64, 64)).view(dev)
    return render_diff_image, (scene, view)


def _dryrun(mesh) -> None:
    """The dry run on this rank of ``mesh``: one data-parallel training
    step through the oracle, the row-split forward on rungs 4 and 5, the
    row-split one-launch step (phong, then ESL) and the volume-sharded
    render's gradient through the kernels' slab mode."""
    from volrt_torch.bench.harness import synthetic_volume
    from volrt_torch.core.tf import default_transfer_fn
    from volrt_torch.core.types import Volume, default_ray_step, make_raycaster
    from volrt_torch.core.view import Camera
    from volrt_torch.diff.render import scene_from_volume
    from volrt_torch.dist.render import (
        l2_loss_grads_v3_sharded, render_float_sharded)
    from volrt_torch.dist.volume_sharded import render_volume_sharded
    from volrt_torch.train.fit import (
        init_state, make_optimizer, make_train_step)

    dev, n_dev = mesh.device, mesh.size
    n, hw = 16, 32

    def scene():
        return scene_from_volume(synthetic_volume(n), default_transfer_fn(dev),
                                 default_ray_step((n, n, n)), device=dev)

    sc = scene()
    view = Camera(dims=(hw, hw)).view(dev)
    target = torch.zeros((hw, hw, 4), dtype=torch.float32, device=dev)
    state = init_state(sc, make_optimizer(sc, 1e-2))
    state, loss = make_train_step(mesh=mesh)(state, view, target)
    assert math.isfinite(float(loss)), "non-finite loss in the dry run"

    for renderer in ("pallas-blocked", "pallas-v3"):
        rc = make_raycaster(Volume.from_numpy(synthetic_volume(n), dev),
                            view=view, interpolation="trilinear")
        img, _ = render_float_sharded(rc, mesh, renderer=renderer)
        assert torch.isfinite(img).all()

    sc = scene()
    view2 = Camera(dims=(32, 16 * n_dev)).view(dev)
    tgt2 = torch.zeros((16 * n_dev, 32, 4), dtype=torch.float32, device=dev)
    for kw in (dict(shading="phong"), dict(esl=True)):
        loss2, g2 = l2_loss_grads_v3_sharded(sc, view2, tgt2, mesh, **kw)
        assert math.isfinite(float(loss2))
        assert torch.isfinite(g2["density"]).all()

    cam3 = Camera(dims=(16, 16))
    cam3.set_camera_position((25.0, 10.0, 0.0))
    img = render_volume_sharded(sc, cam3.view(dev), mesh, ray_threshold=2.0,
                                backend="pallas")
    (img ** 2).mean().backward()
    grad = sc.density.grad
    assert torch.isfinite(grad).all() and float(grad.norm()) > 0


def _dryrun_rank(rank: int, size: int, device: str | None) -> None:
    from volrt_torch.dist.mesh import make_mesh

    _dryrun(make_mesh(device))


def dryrun_multichip(n_devices: int, device=None,
                     backend: str = "gloo") -> None:
    """Run the sharded paths once over ``n_devices`` ranks (one sharded
    training step among them) on tiny shapes and check that what comes
    out is finite: in the process group that is up when it has
    ``n_devices`` ranks, else on ``n_devices`` local ranks spawned on
    ``backend`` (``gloo``: several may share one card, or run on the CPU
    with ``device="cpu"``). ``device`` is each rank's, the card when
    ``None`` (``cuda:LOCAL_RANK`` on NCCL)."""
    import torch.distributed as dist

    from volrt_torch.dist.mesh import make_mesh, spawn

    if dist.is_initialized():
        mesh = make_mesh(device)
        assert mesh.size == n_devices, (
            f"need {n_devices} ranks, the group has {mesh.size}")
        _dryrun(mesh)
        return
    # A rank that fails fails the call (spawn raises).
    spawn(_dryrun_rank, n_devices, None if device is None else str(device),
          backend=backend)
