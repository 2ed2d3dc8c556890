"""Ray-row data parallelism: each rank renders a band of whole image rows
(the counterpart of ``volrt/dist/render.py``).

``volrt`` shard_maps its Pallas kernels over the tile axis of its 16x16 ray
tiles, volume and TF replicated. The port's kernels take rays in raster
order with a ``width``, so the counterpart of a band of ray tiles is a band
of image rows: the rows are cut into ``mesh.size`` bands of equal height,
the last padded with dead rows (``volrt``'s ``_pad_tiles``), each rank
marches its band and one ``all_gather`` lays the bands end to end. A ray's
result depends on its own inputs only, so the frame equals the unsharded
one to the bit. The ray setup (and the leading leap of rungs 2-4) runs on
the whole image on every rank, then the band is cut from it: a few torch
kernels against the march.

The training step (:func:`l2_loss_grads_v3_sharded`) runs the one-launch
``l2_step`` kernel on each band with the whole image's mean, then sums
the loss and both gradients with ``all_reduce``.
"""
from __future__ import annotations

import torch

from volrt_torch.core import sampling
from volrt_torch.core import tf as tf_mod
from volrt_torch.core.types import Raycaster, View
from volrt_torch.diff.render import DiffScene
from volrt_torch.dist.mesh import Mesh
from volrt_torch.renderers import diff_v3, fwd_v3, trilinear
from volrt_torch.renderers.cuda.march import (
    l2_step, march_blocked, march_fwd, march_tri)

RENDERERS = ("pallas-trilinear", "pallas-blocked", "pallas-v3")


def band_rows(h: int, mesh: Mesh) -> tuple[int, int]:
    """``(first row, rows)`` of this rank's band of an image ``h`` rows
    high: ``ceil(h / size)`` rows a band, the last band's tail past ``h``
    dead."""
    rows = -(-h // mesh.size)
    return mesh.rank * rows, rows


def band_args(args: tuple, width: int, h: int, mesh: Mesh) -> tuple:
    """The march wrappers' arguments ``(o, d, k0, kfar, alive, ...)`` of a
    whole image cut to this rank's band, padded to the band's height with
    dead rays (``alive`` false)."""
    first, rows = band_rows(h, mesh)
    lo, hi = first * width, min(first + rows, h) * width
    pad = rows * width - max(hi - lo, 0)
    out = []
    for t in args[:5]:
        part = t[lo:hi]
        if pad:
            part = torch.cat([part, part.new_zeros((pad, *t.shape[1:]))])
        out.append(part.contiguous())
    return (*out, *args[5:])


def gather_bands(band: torch.Tensor, width: int, h: int, mesh: Mesh
                 ) -> torch.Tensor:
    """The ranks' bands ``f32[rows * width, C]`` laid end to end ->
    ``f32[h, width, C]`` (one ``all_gather``)."""
    every = mesh.all_gather(band)
    return every.reshape(-1, band.shape[-1])[:h * width].reshape(
        h, width, band.shape[-1])


def render_float_sharded(rc: Raycaster, mesh: Mesh,
                         renderer: str = "pallas-blocked",
                         window=None, shade: bool = True
                         ) -> tuple[torch.Tensor, float]:
    """Render with image rows split over ``mesh`` -> ``(f32[H, W, 4],
    overflow 0)`` on every rank. ``renderer``: ``"pallas-trilinear"``
    (``march_tri``, nearest where ``rc.interpolation`` is), ``"pallas-
    blocked"`` (``march_blocked``, the uint8 volume) or ``"pallas-v3"``
    (``march_fwd``, rung 5, with ``rc.shading`` and ``rc.esl``), each with
    the ray setup of its unsharded rung. ``window`` has no role (the kernels
    plan none) and ``shade`` is ignored, as ``volrt`` ignores it: the rung
    takes the diffuse tap where ``rc.light_kd`` passes its gate."""
    del window, shade
    w, h = rc.view.dims
    if renderer == "pallas-v3":
        if rc.interpolation != "trilinear":
            raise ValueError("pallas-v3 renders trilinear mode only")
        fwd_v3.check_modes(rc, phong=True)
        args, kw = fwd_v3.march_args(rc)
        kernel = march_fwd
    elif renderer == "pallas-trilinear":
        args, kw = trilinear.ladder_args(rc,
                                         rc.volume.data.to(torch.float32))
        kw["nearest"] = rc.interpolation == "nearest"
        kernel = march_tri
    elif renderer == "pallas-blocked":
        if rc.interpolation != "trilinear":
            raise ValueError("pallas-blocked renders trilinear mode only")
        args, kw = trilinear.ladder_args(rc, rc.volume.data)
        kernel = march_blocked
    else:
        raise ValueError(f"unknown sharded renderer: {renderer} (one of "
                         f"{RENDERERS})")
    band = kernel(*band_args(args, w, h, mesh), **kw)
    return gather_bands(band, w, h, mesh), 0.0


def render_sharded(rc: Raycaster, mesh: Mesh, **kw) -> torch.Tensor:
    """:func:`render_float_sharded` as ``uint8[H, W, 4]``."""
    img, _ = render_float_sharded(rc, mesh, **kw)
    return sampling.write_color(img)


def l2_loss_grads_v3_sharded(scene: DiffScene, view: View,
                             target: torch.Tensor, mesh: Mesh,
                             ray_threshold: float = 0.95, fast: bool = False,
                             window=None, flush=None,
                             shading: str | None = None,
                             light_kd: float = 0.6, plan=None,
                             esl: bool = False, need_dtf: bool = True,
                             need_dvol: bool = True
                             ) -> tuple[torch.Tensor, dict]:
    """Mean-square loss and scene gradients with image rows split over
    ``mesh`` -> ``(loss, {"density": ..., "tf_base": ...})``, the same on
    every rank.

    Each rank runs the one-launch ``l2_step`` on its band, scaled by the
    whole image's ``H * W * 4``, volume and TF replicated; then the loss,
    ``d_density`` and ``d_tf`` are summed over the ranks (``all_reduce``):
    the numbers of :func:`diff_v3.l2_loss_grads_v3_onepass` on the whole
    image, up to the order of the sums. ``shading`` is None,
    ``"diffuse"`` or ``"phong"``; ``esl=True`` skips empty space on the
    live TF's grid. ``fast=True`` (bf16) raises ``NotImplementedError``;
    ``window``, ``flush`` and ``plan`` have no role (the kernels plan
    nothing)."""
    del window, flush, plan
    shaded, phong = shading == "diffuse", shading == "phong"
    diff_v3.check_modes(fast, shaded, phong)
    w, h = view.dims
    scale = 2.0 / (float(h) * float(w) * 4.0)
    with torch.no_grad():
        base = scene.tf_base
        args, kw = fwd_v3.ray_args(
            view, scene.density, tf_mod.premultiply(base), scene.ray_step,
            ray_threshold, light_kd if (shaded or phong) else 0.0,
            loss_scale=scale, phong=phong,
            esl=diff_v3.scene_esl(scene) if esl else None)
        tgt = target.to(torch.float32).reshape(-1, 4)
        first, rows = band_rows(h, mesh)
        t_band = tgt[first * w:min(first + rows, h) * w]
        t_band = torch.cat([t_band, t_band.new_zeros(
            (rows * w - t_band.shape[0], 4))]).contiguous()
        band = band_args(args, w, h, mesh)
        out, d_density, d_premult = l2_step(
            *band, t_band, need_dtf=need_dtf, need_dvol=need_dvol, **kw)
        # The padded rows are dead with a zero target: they add nothing.
        diff = out - t_band
        sq = (diff * diff).sum()
        total = mesh.all_reduce(torch.cat([sq.reshape(1), d_premult.reshape(
            -1), d_density.reshape(-1)]))
        loss = total[0] * (scale * 0.5)
        n_tf = d_premult.numel()
        d_premult = total[1:1 + n_tf].reshape(d_premult.shape)
        d_density = total[1 + n_tf:].reshape(d_density.shape)
        d_rgb = d_premult[:, :3] * base[:, 3:4]
        d_a = d_premult[:, 3:4] + (d_premult[:, :3] * base[:, :3]).sum(
            -1, keepdim=True)
    return loss, {"density": d_density,
                  "tf_base": torch.cat([d_rgb, d_a], dim=-1)}
