"""Gradient-descent fitting of a DiffScene to target images (the
counterpart of ``volrt/train/fit.py`` on one card).

The ``fit`` training loop: render the scene differentiably, L2-compare
against target images over one or more camera poses, and optimise the
voxel density grid and/or the transfer-function LUT with Adam. PyTorch
updates parameters in place, so the scene handed to :func:`fit` is the
scene it returns, trained. Under a mesh (``dist/mesh.py``) each rank is one
process of the run: ray-row data parallelism (each rank a band of the
image rows, the gradients summed) or, with ``volume_sharded``, Z-slab
volume sharding (each rank trains its own slab of the density).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from volrt_torch.core import rays as rays_mod
from volrt_torch.core.types import View
from volrt_torch.diff import fused as fused_mod
from volrt_torch.diff.render import DiffScene, render_diff, render_diff_image
from volrt_torch.dist.mesh import Mesh
from volrt_torch.dist.render import band_rows
from volrt_torch.renderers.diff_v3 import l2_loss_grads_v3_onepass
from volrt_torch.utils import trace


@dataclasses.dataclass
class TrainState:
    scene: DiffScene
    optimizer: torch.optim.Optimizer
    step: int = 0


def l2_loss(scene: DiffScene, view: View, target: torch.Tensor
            ) -> torch.Tensor:
    img = render_diff_image(scene, view)
    return torch.mean((img - target) ** 2)


def l2_loss_fused(scene: DiffScene, view: View, target: torch.Tensor
                  ) -> torch.Tensor:
    """L2 loss through the march kernels under autograd: one forward and
    one backward launch, in ``volrt``'s fast mode (the density stored as
    bf16, its gradient f32), as ``volrt``'s ``l2_loss_fused`` takes it."""
    return fused_mod.l2_loss_fused(scene, view, target, fast=True)


def make_optimizer(scene: DiffScene, lr: float = 1e-2
                   ) -> torch.optim.Optimizer:
    """Adam as ``optax.adam(lr)`` has it: betas (0.9, 0.999), eps 1e-8
    added outside the square root, no weight decay."""
    return torch.optim.Adam([scene.density, scene.tf_base], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def init_state(scene: DiffScene, optimizer: torch.optim.Optimizer
               ) -> TrainState:
    return TrainState(scene, optimizer, 0)


def l2_loss_grads_sharded(scene: DiffScene, view: View,
                          target: torch.Tensor, mesh: Mesh,
                          ray_threshold: float = 0.95, esl: bool = False,
                          light_kd: float = 0.0, shaded: bool = False,
                          phong: bool = False) -> tuple[torch.Tensor, dict]:
    """The mean-square loss of :func:`render_diff_image` and its gradients
    with the image rows split over ``mesh`` -> ``(loss, {"density",
    "tf_base"})``, the same on every rank: each rank renders its band
    (``dist/render.py:band_rows``) through the oracle, differentiates its
    share of the whole image's mean, and one ``all_reduce`` sums the loss
    and both gradients (a frozen leaf's is zero). The counterpart of
    ``volrt``'s ``make_train_step(mesh=)``, whose target rows are sharded
    over the mesh."""
    w, h = view.dims
    first, rows = band_rows(h, mesh)
    last = min(first + rows, h)
    leaves = [scene.density, scene.tf_base]
    grads = [torch.zeros_like(p) for p in leaves]
    sq = torch.zeros((), dtype=torch.float32, device=scene.density.device)
    if last > first:
        origins, directions = rays_mod.get_rays(view)
        img = render_diff(
            scene, origins[first:last], directions[first:last],
            ray_threshold, esl=esl, light_kd=light_kd,
            light_pos=view.light_pos if (shaded or phong) else None,
            phong=phong)
        diff = img - target[first:last].to(torch.float32)
        sq = (diff * diff).sum() / (float(h) * float(w) * 4.0)
        wanted = [i for i, p in enumerate(leaves) if p.requires_grad]
        if wanted:
            got = torch.autograd.grad(sq, [leaves[i] for i in wanted])
            for i, g in zip(wanted, got):
                grads[i] = g
    total = mesh.all_reduce(torch.cat([sq.detach().reshape(1)]
                                      + [g.reshape(-1) for g in grads]))
    n_vol = grads[0].numel()
    return total[0], {"density": total[1:1 + n_vol].reshape(grads[0].shape),
                      "tf_base": total[1 + n_vol:].reshape(grads[1].shape)}


def make_train_step(loss_fn: Callable = l2_loss, train_density: bool = True,
                    train_tf: bool = True,
                    loss_grads_fn: Callable | None = None,
                    mesh: Mesh | None = None) -> Callable:
    """Build a train step ``(state, view, target) -> (state, loss)``.

    ``loss_fn(scene, view, target)`` is differentiated by autograd, unless
    ``loss_grads_fn(scene, view, target) -> (loss, {"density", "tf_base"})``
    is given and supplies the gradients itself (the one-launch step). With
    ``mesh`` and no ``loss_grads_fn`` the step is :func:`l2_loss`'s with
    the image rows split over the mesh (:func:`l2_loss_grads_sharded`). A
    frozen leaf gets no gradient and so no update; after the update both
    leaves, a frozen one too, are clamped to [0, 1] in place, as
    ``volrt`` clips them.
    """
    if mesh is not None and loss_grads_fn is None:
        def loss_grads_fn(scene, view, target):
            return l2_loss_grads_sharded(scene, view, target, mesh)

    def step(state: TrainState, view: View, target: torch.Tensor):
        w, h = view.dims
        with trace.span("train_step", rays=w * h):
            scene = state.scene
            scene.density.requires_grad_(train_density)
            scene.tf_base.requires_grad_(train_tf)
            if loss_grads_fn is not None:
                loss, grads = loss_grads_fn(scene, view, target)
                scene.density.grad = (grads["density"] if train_density
                                      else None)
                scene.tf_base.grad = grads["tf_base"] if train_tf else None
            else:
                state.optimizer.zero_grad(set_to_none=True)
                loss = loss_fn(scene, view, target)
                if train_density or train_tf:
                    loss.backward()
            with trace.span("optimizer", device=scene.density.device,
                            parameters=(scene.density.numel()
                                        + scene.tf_base.numel())):
                state.optimizer.step()
                with torch.no_grad():
                    scene.density.clamp_(0.0, 1.0)
                    scene.tf_base.clamp_(0.0, 1.0)
            state.step += 1
            return state, loss.detach()

    return step


def fit(
    scene: DiffScene,
    views_and_targets: list[tuple[View, torch.Tensor]],
    steps: int = 200,
    lr: float = 1e-2,
    train_density: bool = True,
    train_tf: bool = True,
    mesh=None,
    log_every: int = 0,
    logger=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    fused: bool = False,
    grad_chunks: int = 0,
    volume_sharded: bool = False,
    shading: str | None = None,
    light_kd: float = 0.6,
    esl: bool = False,
    esl_refresh_every: int = 0,
) -> tuple[DiffScene, list[float]]:
    """Fit the scene to targets; returns ``(scene, per-step losses)``.

    The views and targets live on the scene's device. ``fused=True``
    trains through the one-launch L2 step kernel
    (``l2_loss_grads_v3_onepass``), which skips the scatter of a frozen
    leaf, in ``volrt``'s fast mode (the density stored as bf16 for the
    march, its gradient and the update f32), as ``volrt``'s single-chip
    fused fit does; ``fused=False`` through autograd of the plain torch
    march (``render_diff_image``), f32.
    ``shading`` is ``None``, ``"diffuse"`` or ``"phong"`` (gradient
    Blinn-Phong: ``volrt``'s v3 form in the kernel, the oracle's form
    through autograd).

    ``esl=True`` skips empty space in every step: the one-launch step's
    ESL mode with ``fused=True`` (the grid re-derived from the live TF
    each step), the oracle's leading leap without. A TF entry whose
    density range the running TF maps to zero opacity then gets no
    gradient from the skipped samples, so the TF can never open it;
    ``esl_refresh_every=N`` runs every Nth step (steps 0, N, 2N, ...) as
    a full march, which gives every entry its gradient
    (``volrt/train/fit.py:408-447``). Without ``esl`` it changes nothing.

    ``checkpoint_path`` (a ``.npz`` file, ``train/checkpoint.py``'s format,
    which ``volrt`` reads and writes too) is written every
    ``checkpoint_every`` steps and once at the end; with ``resume`` and an
    existing file the run starts from it, at its step: ``steps`` counts
    every step, the resumed ones included, as ``volrt``'s
    (``volrt/train/fit.py:412-465``).

    ``mesh`` (a :class:`dist.mesh.Mesh`; every rank calls ``fit`` with the
    same scene, views and targets) trains over its ranks. Without
    ``volume_sharded``, ray-row data parallelism: each rank takes a band of
    the image rows, through ``dist.render.l2_loss_grads_v3_sharded`` (the
    one-launch step, fast as above) with ``fused=True`` and through the
    oracle
    (:func:`l2_loss_grads_sharded`) without; the gradients are summed, so
    every rank makes the same update. With ``volume_sharded=True`` each
    rank keeps and updates only its Z-slab of the density (Adam on the
    slab, the TF on every rank alike), its halo rows refreshed from the
    neighbours each step, and renders through
    ``dist.volume_sharded.render_volume_sharded``: its kernel backend
    (``"pallas"``; ESL there) unshaded and diffuse, its torch backend for
    phong; ``fused`` changes nothing there. At the end every rank's scene
    holds the whole trained density. Checkpoints go to one ``.npz`` in
    ``volrt``'s format, written by rank 0 (the density and its moments
    gathered on the host in volume-sharded mode); every rank resumes from
    it. ``volume_sharded`` without a mesh raises ``ValueError``, a mesh of
    another type ``TypeError``.

    ``grad_chunks`` is not ported (ROADMAP.md, "Do not port"): a value
    above 1 raises ``NotImplementedError``.
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a volrt_torch.dist.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if volume_sharded and mesh is None:
        raise ValueError("volume_sharded=True requires a mesh")
    if grad_chunks and grad_chunks > 1:
        raise NotImplementedError(
            'fit(grad_chunks) is not ported (ROADMAP.md, "Do not port": '
            'loss_grads_v3_chunked)')
    from volrt_torch.train import checkpoint as ckpt

    if checkpoint_path is not None:
        ckpt.check_path(checkpoint_path)
    if shading not in (None, "diffuse", "phong"):
        raise ValueError(f"unknown shading mode: {shading!r}")
    shaded, phong = shading == "diffuse", shading == "phong"
    kd = light_kd if shading else 0.0

    slabs = None
    if volume_sharded:
        from volrt_torch.dist import volume_sharded as vs

        full_d = scene.density.shape[0]
        halo = vs.shading_halo(full_d, shading)
        sd, z0 = vs.slab_geometry(full_d, mesh, halo)
        slabs = DiffScene(scene.density.detach()[z0:z0 + sd].clone(),
                          scene.tf_base.detach().clone(), scene.ray_step)
        backend = "xla" if phong else "pallas"

    def build_step(esl: bool) -> Callable:
        loss_grads_fn = None
        if volume_sharded:
            def loss_fn(s, view, target):
                img = vs.render_volume_sharded(
                    s, view, mesh,
                    slabs=vs.refresh_halos(s.density, mesh, halo, full_d),
                    backend=backend, shading=shading, light_kd=light_kd,
                    esl=esl)
                return torch.mean((img - target) ** 2)

            return make_train_step(loss_fn, train_density, train_tf)
        if fused and mesh is not None:
            from volrt_torch.dist.render import l2_loss_grads_v3_sharded

            def loss_grads_fn(scene, view, target):
                return l2_loss_grads_v3_sharded(
                    scene, view, target, mesh, fast=True, shading=shading,
                    light_kd=light_kd, esl=esl, need_dtf=train_tf,
                    need_dvol=train_density)
        elif fused:
            def loss_grads_fn(scene, view, target):
                return l2_loss_grads_v3_onepass(
                    scene, view, target, fast=True, need_dtf=train_tf,
                    need_dvol=train_density, esl=esl, shaded=shaded,
                    phong=phong, light_kd=light_kd)
        elif mesh is not None:
            def loss_grads_fn(scene, view, target):
                return l2_loss_grads_sharded(
                    scene, view, target, mesh, esl=esl, light_kd=kd,
                    shaded=shaded, phong=phong)

        def loss_fn(scene, view, target):
            img = render_diff_image(scene, view, esl=esl, light_kd=kd,
                                    shaded=shaded, phong=phong)
            return torch.mean((img - target) ** 2)

        return make_train_step(loss_fn, train_density, train_tf,
                               loss_grads_fn)

    train_step = build_step(esl)
    refresh_step = (build_step(False) if esl and esl_refresh_every
                    else None)
    trained = scene if slabs is None else slabs
    state = init_state(trained, make_optimizer(trained, lr))
    # Volume-sharded checkpoints hold the whole density: gathered from the
    # slabs to write, cut to this rank's rows to resume.
    gather, rows = None, slice(None)
    if slabs is not None:
        def gather(t):
            return vs.gather_density(t, mesh)

        rows = slice(z0, z0 + sd)
    writes = mesh is None or mesh.rank == 0

    def save():
        ckpt.save(checkpoint_path, state, gather=gather, write=writes)

    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        ckpt.restore(checkpoint_path, state, rows=rows)
        if logger:
            logger.log(f"resumed from {checkpoint_path} at step {state.step}")
    losses = []
    for i in range(state.step, steps):
        view, target = views_and_targets[i % len(views_and_targets)]
        step_fn = train_step
        if refresh_step is not None and i % esl_refresh_every == 0:
            step_fn = refresh_step
        state, loss = step_fn(state, view, target)
        losses.append(float(loss))
        if log_every and (i % log_every == 0):
            msg = f"fit step {i}: loss {losses[-1]:.6f}"
            (logger.log if logger else print)(msg)
        if (checkpoint_path and checkpoint_every
                and (i + 1) % checkpoint_every == 0):
            save()
            if logger:
                logger.log(f"checkpoint at step {i + 1} -> "
                           f"{checkpoint_path}")
    if checkpoint_path:
        save()
    if slabs is not None:
        with torch.no_grad():
            scene.density.copy_(torch.from_numpy(gather(slabs.density)))
            scene.tf_base.copy_(slabs.tf_base)
    # The step freezes a leaf by turning its requires_grad off.
    scene.density.requires_grad_(True)
    scene.tf_base.requires_grad_(True)
    return scene, losses
