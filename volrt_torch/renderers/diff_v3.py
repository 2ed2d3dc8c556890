"""The differentiable rung-5 render on the card's kernels: the counterpart
of the scene-level API of ``volrt/renderers/pallas/diff_v3.py``
(``render_view_v3``, ``render_image_v3``, ``render_image_v3_with_ovf``,
``l2_loss_grads_v3_onepass``, and ``render_slab_v3``, the volume-sharded
mode's march of one Z-slab).

The ray setup is the forward render's (``fwd_v3.ray_args``). The march
runs under autograd through :class:`MarchFunction` (forward kernel, then
backward kernel), or, for the L2 step, through the one-launch
:func:`l2_step`. None of the TPU kernels' planning arguments (``window``,
``flush``, ``plan``) exist here: a per-ray kernel has no windows to plan.
``fast=True`` is ``volrt``'s fast mode everywhere it takes it: the density
stored as bf16 (``diff_v3.py:_phase_volumes``) and sampled as its fast
kernels sample it, by the kernels' bf16 instances; the gradient comes back
to the f32 density in f32, and the ESL grid is the f32 density's.
"""
from __future__ import annotations

import torch

from volrt_torch.constants import SHADE_KD_GATE
from volrt_torch.core import esl as esl_mod
from volrt_torch.core import rays as rays_mod
from volrt_torch.core import tf as tf_mod
from volrt_torch.core.types import View
from volrt_torch.diff.render import DiffScene, scene_empty_grid
from volrt_torch.renderers import fwd_v3
from volrt_torch.renderers.cuda.march import MarchFunction, l2_step
from volrt_torch.utils import trace


def check_modes(shaded: bool = False, phong: bool = False) -> None:
    """Refuse ``shaded`` with ``phong``, which no kernel composes
    (``diff_v3.py:2608-2609``)."""
    if shaded and phong:
        raise ValueError("shaded and phong are mutually exclusive")


def scene_esl(scene: DiffScene) -> tuple[torch.Tensor, int]:
    """The kernels' ESL grid ``(words, block)`` of ``scene`` under its live
    TF, derived anew on each call as ``volrt`` derives it
    (``diff_v3.py:2638-2646``): the TF trains, and with it the empty
    set."""
    empty, block, _ = scene_empty_grid(scene)
    return esl_mod.pack_words(empty), block


def render_view_v3(density: torch.Tensor, premult_tf: torch.Tensor,
                   ray_step: float, view: View, ray_threshold: float = 0.95,
                   light_kd: float = 0.0, shaded: bool = False,
                   phong: bool = False, esl=None, fast: bool = False
                   ) -> tuple[torch.Tensor, float]:
    """Premult-level render -> ``(f32[H, W, 4], overflow count)``,
    differentiable with respect to ``density`` ``f32[D, H, W]`` and
    ``premult_tf`` ``f32[TF_SIZE, 4]``. ``shaded`` takes the diffuse tap,
    ``phong`` gradient Blinn-Phong, each with ``light_kd``. ``esl`` is
    ``None`` or the ESL grid ``(words, block)`` (:func:`scene_esl`):
    the kernels skip the samples whose cell lies in empty blocks, in the
    forward and the backward alike. ``fast``: the kernels' bf16 instances
    on a bf16 copy of ``density`` made inside the autograd function, whose
    gradient reaches ``density`` in f32. The overflow count is 0: the
    kernels have no windows (see ``fwd_v3.render_float``)."""
    check_modes(shaded, phong)
    args, kw = fwd_v3.ray_args(
        view, density, premult_tf, ray_step, ray_threshold,
        light_kd if (shaded or phong) else 0.0, phong=phong, esl=esl)
    o, d, knear, kfar, alive, density, premult_tf, scal = args
    colors = MarchFunction.apply(
        density, premult_tf, o, d, knear, kfar, alive, scal,
        kw["ray_step"], kw["shade"], kw["no_ert"], kw["width"],
        kw.get("phong", False), esl, None, None, fast)
    w, h = view.dims
    return colors.reshape(h, w, 4), 0.0


def render_image_v3_with_ovf(scene: DiffScene, view: View,
                             ray_threshold: float = 0.95, fast: bool = False,
                             esl: bool = False, light_kd: float = 0.0,
                             shaded: bool = False, phong: bool = False
                             ) -> tuple[torch.Tensor, float]:
    """As :func:`render_image_v3` but also returns the overflow count."""
    return render_view_v3(scene.density, scene.premult_tf(), scene.ray_step,
                          view, ray_threshold, light_kd, shaded, phong,
                          scene_esl(scene) if esl else None, fast)


def render_image_v3(scene: DiffScene, view: View,
                    ray_threshold: float = 0.95, fast: bool = False,
                    esl: bool = False, light_kd: float = 0.0,
                    shaded: bool = False, phong: bool = False
                    ) -> torch.Tensor:
    """Differentiable render -> ``f32[H, W, 4]`` through the march kernels.

    Semantics match ``diff.render.render_diff_image`` (with the ``shaded``
    diffuse light tap); gradients flow to ``scene.density`` and, through
    the premultiply, to the un-premultiplied ``scene.tf_base``. A leaf
    with ``requires_grad`` off skips its scatter in the backward kernel.
    ``phong=True`` shades with ``volrt``'s v3 gradient Blinn-Phong, whose
    normal taps lie one clipped voxel to either side (the oracle's move
    the world point by 2/n: the two differ at the volume's faces).
    ``esl=True`` skips the samples whose trilinear cell lies in ESL blocks
    that the live TF leaves empty (:func:`scene_esl`), where ``volrt``
    drops whole groups of them: the port skips those and more. The TF
    gradient that those samples would give the zero-opacity rows they
    read is dropped too (see ``diff.render.scene_empty_grid``). ``shaded`` with
    ``phong`` raises ``ValueError``. ``fast=True`` renders ``volrt``'s fast
    mode (the density as bf16, each (z, y) tap weight product rounded to
    bf16; see the module docstring), that of ``volrt``'s trainer and bench.
    """
    return render_image_v3_with_ovf(scene, view, ray_threshold, fast, esl,
                                    light_kd, shaded, phong)[0]


def l2_loss_grads_v3_onepass(scene: DiffScene, view: View,
                             target: torch.Tensor,
                             ray_threshold: float = 0.95, fast: bool = False,
                             need_dtf: bool = True, need_dvol: bool = True,
                             esl: bool = False, shaded: bool = False,
                             phong: bool = False, light_kd: float = 0.6
                             ) -> tuple[torch.Tensor, dict]:
    """Full-image MSE loss and scene gradients in one kernel launch
    -> ``(loss, {"density": ..., "tf_base": ...})``.

    The same numbers as autograd of ``mean((render_image_v3(scene, view)
    - target) ** 2)``, but the forward march, each ray's cotangent and the
    backward run in one launch (:func:`l2_step`); nothing is recorded for
    autograd. ``target`` is ``f32[H, W, 4]`` on the scene's device.
    ``need_dtf=False`` / ``need_dvol=False`` skip that leaf's scatter and
    return zeros for it. ``shaded`` takes the diffuse tap, ``phong``
    gradient Blinn-Phong (not both), each with ``light_kd``. ``esl=True``
    skips as :func:`render_image_v3` does, on the grid of the live TF.
    ``fast=True`` steps on the density's bf16 copy (the kernel's bf16
    instance; ``d_density`` stays f32), as ``volrt``'s trainer does. The
    TF gradient is chained from the premultiplied LUT's to ``tf_base``
    here, as ``volrt``'s does it in XLA.
    """
    check_modes(shaded, phong)
    w, h = view.dims
    scale = 2.0 / (float(h) * float(w) * 4.0)
    with torch.no_grad():
        base = scene.tf_base
        density = scene.density
        if fast:
            with trace.span("volume_copy", device=density.device,
                            voxels=density.numel()):
                density = density.to(torch.bfloat16)
        args, kw = fwd_v3.ray_args(
            view, density, tf_mod.premultiply(base), scene.ray_step,
            ray_threshold, light_kd if (shaded or phong) else 0.0,
            loss_scale=scale, phong=phong,
            esl=scene_esl(scene) if esl else None)
        tgt = target.to(torch.float32).reshape(-1, 4).contiguous()
        out, d_density, d_premult = l2_step(
            *args, tgt, need_dtf=need_dtf, need_dvol=need_dvol, **kw)
        with trace.span("loss", rays=w * h):
            diff = out - tgt
            loss = (diff * diff).sum() * (scale * 0.5)
            # premult = (rgb * a, a): d_base.rgb = d_premult.rgb * a,
            # d_base.a = d_premult.a + sum(d_premult.rgb * rgb).
            d_rgb = d_premult[:, :3] * base[:, 3:4]
            d_a = d_premult[:, 3:4] + (d_premult[:, :3] * base[:, :3]).sum(
                -1, keepdim=True)
            d_base = torch.cat([d_rgb, d_a], dim=-1)
    return loss, {"density": d_density, "tf_base": d_base}


def slab_rays(view: View, z_start: int, slab_d: int, full_d: int,
              ray_step: float, device: torch.device
              ) -> tuple[torch.Tensor, ...]:
    """The rays of one Z-slab, rows ``z_start .. z_start + slab_d - 1`` of a
    volume ``full_d`` deep -> ``(o, d, k0, kfar, alive)`` for the march
    kernels, in raster order on ``device``.

    Samples stay on each ray's lattice ``knear + j*ray_step`` of the whole
    volume (``volrt``'s ``render_slab_v3``, ``diff_v3.py:3341-3353``), and
    every index ``j`` is marched by exactly one slab: the slab takes ``j``
    in ``[J_in, J_out)``, ``J = ceil(max(k - knear, 0) / ray_step)`` of the
    ray's parameters ``k`` at the slab's two z planes, so that one plane
    gives the ``J_out`` of one slab and the ``J_in`` of the next, computed
    alike; the ray's exit ``kfar`` bounds it too, and alone bounds the slab
    that holds the volume's far face in the ray's direction, whose samples
    run up to ``k <= kfar`` as the whole march's do (a sample on the far
    face included). ``volrt`` keeps the samples ``k <= k_out`` in one slab
    and starts the next at ``ceil``, so a sample that lies on a plane is
    taken by both (``ROADMAP.md``, queue 3). The range goes to the kernels
    as ``k0 = knear + J_in*ray_step`` and ``kfar = min(kfar, k0 + (J_out -
    J_in - 1)*ray_step)``, the last sample's parameter in the kernels' own
    rounding, so the kernels' test ``k <= kfar`` stops at the count and
    compares no two floats at a plane."""
    origins, directions = rays_mod.get_rays(view)
    o = origins.reshape(-1, 3).contiguous()
    d = directions.reshape(-1, 3).contiguous()
    knear, kfar, hit = rays_mod.intersect_aabb(o, d)
    f32 = dict(dtype=torch.float32, device=device)
    # Divisors as tensors: torch divides a CUDA tensor by a Python number
    # as a product with its reciprocal (core/sampling.py).
    step = torch.full((), ray_step, **f32)
    depth = torch.full((), float(full_d), **f32)
    planes = [-1.0 + (2.0 * torch.full((), float(z), **f32)) / depth
              for z in (z_start, z_start + slab_d)]
    dz = torch.where(d[:, 2] == 0.0, 1e-5, d[:, 2])
    ka, kb = ((p - o[:, 2]) / dz for p in planes)
    k_in = torch.maximum(torch.minimum(ka, kb), knear)
    k_out = torch.maximum(ka, kb)
    j_in, j_out = (torch.ceil((k - knear).clamp(min=0.0) / step)
                   for k in (k_in, k_out))
    count = j_out - j_in
    k0 = knear + j_in * step
    # The slab that holds the far face: z = +1 for a ray going up z, z = -1
    # going down (a zero dz counts as 1e-5, as above).
    far = torch.zeros_like(hit)
    if z_start + slab_d == full_d:
        far = far | (dz > 0.0)
    if z_start == 0:
        far = far | (dz < 0.0)
    kend = torch.where(far, kfar,
                       torch.minimum(kfar, k0 + (count - 1.0) * step))
    alive = hit & (knear <= kfar) & (far | (count > 0.0)) & (k0 <= kend)
    return o, d, k0.contiguous(), kend.contiguous(), alive


def render_slab_v3(slab_density: torch.Tensor, premult_tf: torch.Tensor,
                   ray_step: float, view: View, z_start: int, full_d: int,
                   ray_threshold: float = 0.95,
                   acc0: torch.Tensor | None = None, window=None,
                   fast: bool = False, esl_grid=None, halo: int = 1,
                   shaded: bool = False, light_kd: float = 0.0
                   ) -> tuple[torch.Tensor, float]:
    """March one Z-slab's samples of the whole volume's lattice through the
    march kernels in their slab mode -> ``(f32[H, W, 4], overflow 0)``.

    ``slab_density (sd + 2*halo, H, W)`` holds rows ``z_start - halo ..
    z_start + sd + halo - 1`` of a volume ``full_d`` deep (edge rows
    clamp-padded: ``dist/volume_sharded.py:shard_slabs``). ``acc0 (H, W)``,
    or zeros, seeds each ray's opacity, the opacity in front of the slab;
    the returned alpha includes it. The slab's samples are
    :func:`slab_rays`': each lattice index of the whole volume in exactly
    one slab. ``shaded`` takes the diffuse tap with ``light_kd`` and the
    view's light, whose reach the halo must cover
    (``volume_sharded.shading_halo``). ``esl_grid = (empty bool[32, 32,
    32], block)``, the whole volume's ESL grid, skips the samples whose
    whole-volume cell lies in empty blocks. Differentiable with respect to
    ``slab_density``, ``premult_tf`` and ``acc0`` (:class:`MarchFunction`:
    the backward kernel gives the seed's cotangent). ``window`` has no role
    (the kernels plan none). ``fast=True`` marches the slab's bf16 copy
    (the kernels' bf16 instances, the slab's z coordinate clipped as
    ``volrt``'s ``_geometry`` clips it). The counterpart of ``volrt``'s
    ``render_slab_v3`` (``diff_v3.py:3292``), but for the partition of the
    samples (:func:`slab_rays`)."""
    del window
    check_modes(shaded)
    sdl, h, w = slab_density.shape
    dev = slab_density.device
    o, d, k0, kend, alive = slab_rays(view, z_start, sdl - 2 * halo, full_d,
                                      ray_step, dev)
    wv, hv = view.dims
    if acc0 is None:
        acc0 = torch.zeros(hv * wv, dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    kd = light_kd if shaded else 0.0
    scal = torch.cat([torch.full((1,), ray_threshold, **f32),
                      torch.full((1,), kd, **f32),
                      view.light_pos.to(torch.float32),
                      torch.full((1,), float(z_start - halo), **f32),
                      torch.zeros(2, **f32)])
    esl = None
    if esl_grid is not None:
        esl = (esl_mod.pack_words(esl_grid[0]), esl_grid[1])
    colors = MarchFunction.apply(
        slab_density, premult_tf.contiguous(), o, d, k0, kend, alive, scal,
        ray_step, kd > SHADE_KD_GATE, ray_threshold >= 1.0, wv, False, esl,
        acc0.reshape(-1).contiguous(), full_d, fast)
    return colors.reshape(hv, wv, 4), 0.0
