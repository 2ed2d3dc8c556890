"""Gradient-descent fitting of a DiffScene to target images (the
counterpart of ``volrt/train/fit.py`` on one card).

The ``fit`` training loop: render the scene differentiably, L2-compare
against target images over one or more camera poses, and optimise the
voxel density grid and/or the transfer-function LUT with Adam. PyTorch
updates parameters in place, so the scene handed to :func:`fit` is the
scene it returns, trained.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from volrt_torch.core.types import View
from volrt_torch.diff import fused as fused_mod
from volrt_torch.diff.render import DiffScene, render_diff_image
from volrt_torch.renderers.diff_v3 import l2_loss_grads_v3_onepass


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
    one backward launch (f32; ``volrt``'s runs its kernels with bf16
    storage, which is not ported yet)."""
    return fused_mod.l2_loss_fused(scene, view, target)


def make_optimizer(scene: DiffScene, lr: float = 1e-2
                   ) -> torch.optim.Optimizer:
    """Adam as ``optax.adam(lr)`` has it: betas (0.9, 0.999), eps 1e-8
    added outside the square root, no weight decay."""
    return torch.optim.Adam([scene.density, scene.tf_base], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def init_state(scene: DiffScene, optimizer: torch.optim.Optimizer
               ) -> TrainState:
    return TrainState(scene, optimizer, 0)


def make_train_step(loss_fn: Callable = l2_loss, train_density: bool = True,
                    train_tf: bool = True,
                    loss_grads_fn: Callable | None = None) -> Callable:
    """Build a train step ``(state, view, target) -> (state, loss)``.

    ``loss_fn(scene, view, target)`` is differentiated by autograd, unless
    ``loss_grads_fn(scene, view, target) -> (loss, {"density", "tf_base"})``
    is given and supplies the gradients itself (the one-launch step). A
    frozen leaf gets no gradient and so no update; after the update both
    leaves, a frozen one too, are clamped to [0, 1] in place, as
    ``volrt`` clips them.
    """

    def step(state: TrainState, view: View, target: torch.Tensor):
        scene = state.scene
        scene.density.requires_grad_(train_density)
        scene.tf_base.requires_grad_(train_tf)
        if loss_grads_fn is not None:
            loss, grads = loss_grads_fn(scene, view, target)
            scene.density.grad = grads["density"] if train_density else None
            scene.tf_base.grad = grads["tf_base"] if train_tf else None
        else:
            state.optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(scene, view, target)
            if train_density or train_tf:
                loss.backward()
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
    leaf, as ``volrt``'s single-chip fused fit does; ``fused=False``
    through autograd of the plain torch march (``render_diff_image``).
    ``shading`` is ``None``, ``"diffuse"`` or ``"phong"`` (gradient
    Blinn-Phong: ``volrt``'s v3 form in the kernel, the oracle's form
    through autograd).

    Not ported yet, each raising ``NotImplementedError`` when given
    another value than its default: ``mesh`` and ``volume_sharded``
    (ROADMAP.md, queue 1: ``dist/``), ``grad_chunks`` (ROADMAP.md, "Do not
    port"), ``esl`` and ``esl_refresh_every`` (queue 1: ESL),
    ``checkpoint_path``, ``checkpoint_every`` and ``resume`` (queue 1:
    ``train/checkpoint.py``).
    """
    for name, given, item in (
            ("mesh", mesh is not None, "queue 1: dist/"),
            ("volume_sharded", volume_sharded, "queue 1: dist/"),
            ("grad_chunks", grad_chunks and grad_chunks > 1,
             '"Do not port": loss_grads_v3_chunked'),
            ("esl", esl, "queue 1: ESL"),
            ("esl_refresh_every", esl_refresh_every, "queue 1: ESL"),
            ("checkpoint_path", checkpoint_path is not None,
             "queue 1: train/checkpoint.py"),
            ("checkpoint_every", checkpoint_every,
             "queue 1: train/checkpoint.py"),
            ("resume", resume, "queue 1: train/checkpoint.py")):
        if given:
            raise NotImplementedError(
                f"fit({name}) is not ported yet (ROADMAP.md, {item})")
    if shading not in (None, "diffuse", "phong"):
        raise ValueError(f"unknown shading mode: {shading!r}")
    shaded, phong = shading == "diffuse", shading == "phong"
    kd = light_kd if shading else 0.0

    loss_grads_fn = None
    if fused:
        def loss_grads_fn(scene, view, target):
            return l2_loss_grads_v3_onepass(
                scene, view, target, need_dtf=train_tf,
                need_dvol=train_density, shaded=shaded, phong=phong,
                light_kd=light_kd)

    def loss_fn(scene, view, target):
        img = render_diff_image(scene, view, light_kd=kd, shaded=shaded,
                                phong=phong)
        return torch.mean((img - target) ** 2)

    train_step = make_train_step(loss_fn, train_density, train_tf,
                                 loss_grads_fn)
    state = init_state(scene, make_optimizer(scene, lr))
    losses = []
    for i in range(steps):
        view, target = views_and_targets[i % len(views_and_targets)]
        state, loss = train_step(state, view, target)
        losses.append(float(loss))
        if log_every and (i % log_every == 0):
            msg = f"fit step {i}: loss {losses[-1]:.6f}"
            (logger.log if logger else print)(msg)
    # The step freezes a leaf by turning its requires_grad off.
    scene.density.requires_grad_(True)
    scene.tf_base.requires_grad_(True)
    return state.scene, losses
