"""Volume-sharded rendering: Z-slab partitioning with a transmittance-scan
composite of the slabs' segments (the counterpart of
``volrt/dist/volume_sharded.py``).

When the volume is larger than one card holds, each rank holds one Z-slab
(plus a halo of rows for the trilinear and shading taps) and marches every
ray only through its own slab:

1. **Prepass**: each rank marches its slab unseeded with ERT off, for the
   slab's opacity ``A_i`` of every ray.
2. **Exclusive scan** of the opacity composite ``a + b (1 - a)`` in march
   order: one ``all_gather`` of the ``(H, W)`` planes, then the scan
   locally (:class:`OpacityScan`), for the opacity ``p_i`` in front of
   slab ``i``. ``volrt``'s ``log2(n)`` rounds of ``ppermute`` are the TPU's
   interconnect's schedule and are not carried over.
3. **Seeded march**: the slab again, its accumulator seeded at ``p_i``, so
   every contribution carries its global transmittance and ERT at the
   caller's threshold runs across slabs as in the whole march.
4. **Sum**: the segments ``acc - (0, 0, 0, p_i)`` add up to the image, one
   ``all_reduce``.

Every lattice index of a ray is marched by exactly one slab
(``renderers/diff_v3.py:slab_rays``), so the composed image is the unsharded
render's up to the rounding of the opacity prefix. ``volrt``'s split takes a
sample that lies exactly on a slab plane twice (``ROADMAP.md``, queue 3); the
port holds to ``volrt``'s unsharded render there, not to its sharded one.

Gradients: the slab's own rows get the density gradient; rows held as halo
go back to their owners through one ``all_gather`` (:class:`FoldHalo`); the
TF gradient is summed over the ranks (:class:`ReplicatedGrad`); the seeds'
cotangents flow back through the scan into the upstream slabs' prepasses.
The slabs' own rows' gradients, laid end to end, are the unsharded
gradient.

Spans (``utils/trace.py``, while a profiler records): ``halo_refresh``
(the halo'd slab's copy in :func:`refresh_halos`) and ``halo_fold`` (the
gradient's copy and the folded planes in :class:`FoldHalo`), device stages
whose work is the slab's voxels; ``slab_march``, each call of the march
kernels' slab mode, whose work is the rays and whose tag the pass
(``prepass`` or ``seeded``). The collectives are the mesh's (``collective``)
and lie outside the halo spans.

Two backends, under ``volrt``'s names: ``"xla"``, the slab march as torch
ops under autograd (:func:`_slab_march`: unshaded, diffuse, phong), and
``"pallas"``, the march kernels in their slab mode (rows 1-2:
``render_slab_v3``; unshaded and diffuse, ESL).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from volrt_torch.constants import (
    ESL_VOLUME_DIMS,
    PHONG_KA,
    PHONG_KS,
    PHONG_SHININESS,
    SHADE_ALPHA_GATE,
    SHADE_KD_GATE,
    SHADE_LIGHT_OFFSET,
)
from volrt_torch.core import esl as esl_mod
from volrt_torch.core import rays as rays_mod
from volrt_torch.core import sampling
from volrt_torch.core import tf as tf_mod
from volrt_torch.core.types import View, default_esl_block_dims
from volrt_torch.diff.render import CHECKPOINT_CHUNK, DiffScene
from volrt_torch.dist.mesh import Mesh
from volrt_torch.renderers.cuda.march import max_steps, slab_cell
from volrt_torch.renderers.diff_v3 import render_slab_v3, slab_rays
from volrt_torch.utils import trace

BACKENDS = ("xla", "pallas")


def shard_slabs(density: torch.Tensor, n: int, halo: int = 1
                ) -> torch.Tensor:
    """Split ``f32[D, H, W]`` into ``n`` Z-slabs with ``halo`` rows of halo
    -> ``f32[n, D/n + 2*halo, H, W]``, the edge slabs clamp-padded. Holds
    the whole volume in one process: for the tests, and as the plain
    version of what the ranks build between them."""
    d = density.shape[0]
    if d % n:
        raise ValueError(f"volume depth {d} not divisible by {n} slabs")
    sd = d // n
    rows = torch.arange(-halo, sd + halo, device=density.device)
    return torch.stack([density[(rows + k * sd).clamp(0, d - 1)]
                        for k in range(n)])


def shading_halo(full_d: int, shading: str | None) -> int:
    """Slab halo (rows) that keeps every shading tap inside the halo'd slab:
    the diffuse light tap samples ``SHADE_LIGHT_OFFSET`` world units away
    (``0.01 * full_d / 2`` rows in z) and phong's central differences reach
    one row; one more for the trilinear neighbour."""
    if shading == "diffuse":
        return int(math.ceil(0.01 * 0.5 * full_d)) + 2
    if shading == "phong":
        return 2
    return 1


@dataclasses.dataclass
class Slab:
    """One rank's slab: ``slab (sd + 2*halo, H, W)`` holds the whole
    volume's rows ``z_start - halo .. z_start + sd + halo - 1`` (clamped to
    the volume) of a volume ``full_d`` deep."""

    slab: torch.Tensor
    z_start: int
    full_d: int
    halo: int

    @property
    def depth(self) -> int:
        """The slab's own rows, ``sd``."""
        return self.slab.shape[0] - 2 * self.halo


def slab_geometry(full_d: int, mesh: Mesh, halo: int) -> tuple[int, int]:
    """``(rows a slab, this rank's first row)`` of a volume ``full_d`` deep
    split over ``mesh``; refuses a depth that does not split and a halo
    deeper than a slab (the halos come from the neighbours only)."""
    if full_d % mesh.size:
        raise ValueError(f"volume depth {full_d} not divisible by "
                         f"{mesh.size} slabs")
    sd = full_d // mesh.size
    if halo > sd:
        raise ValueError(f"a halo of {halo} rows exceeds the slab's {sd}: "
                         f"use fewer ranks")
    return sd, mesh.rank * sd


def shard_slabs_to_devices(density, mesh: Mesh, halo: int = 1) -> Slab:
    """This rank's :class:`Slab` of a host volume ``density`` (numpy or a
    CPU tensor, ``[D, H, W]``), copied onto ``mesh.device``: only the
    rank's ``(D/n + 2*halo, H, W)`` rows go to the card, never the whole
    volume (the host copy is the remaining limit)."""
    d = int(density.shape[0])
    sd, z0 = slab_geometry(d, mesh, halo)
    rows = np.clip(np.arange(z0 - halo, z0 + sd + halo), 0, d - 1)
    host = torch.as_tensor(np.ascontiguousarray(np.asarray(density)[rows]),
                           dtype=torch.float32)
    return Slab(host.to(mesh.device), z0, d, halo)


def refresh_halos(own: torch.Tensor, mesh: Mesh, halo: int, full_d: int
                  ) -> Slab:
    """This rank's :class:`Slab` around its own rows ``own (sd, H, W)``:
    the halo rows from the neighbours' edges (one ``all_gather`` of each
    rank's first and last ``halo`` rows), the volume's edge rows repeated
    at its two ends. The own rows stay in autograd; the halo rows are
    copies, whose gradient :class:`FoldHalo` sends to their owners."""
    sd, z0 = slab_geometry(full_d, mesh, halo)
    if own.shape[0] != sd:
        raise ValueError(f"rank {mesh.rank} holds {own.shape[0]} rows, "
                         f"not {sd}")
    edges = mesh.all_gather(torch.cat([own[:halo], own[sd - halo:]]))
    r, n = mesh.rank, mesh.size
    with trace.span("halo_refresh", device=own.device,
                    voxels=(sd + 2 * halo) * own[0].numel()):
        below = (edges[r - 1, halo:] if r > 0
                 else own[:1].detach().expand(halo, -1, -1))
        above = (edges[r + 1, :halo] if r < n - 1
                 else own[sd - 1:].detach().expand(halo, -1, -1))
        slab = torch.cat([below, own, above]).contiguous()
    return Slab(slab, z0, full_d, halo)


class FoldHalo(torch.autograd.Function):
    """The identity on a rank's halo'd slab, whose backward sends the
    gradient of each halo row to the rank that owns the row: one
    ``all_gather`` of every rank's ``2*halo`` halo planes, each added to
    the owner's row (a clamped edge row to the volume's edge row, the
    rank's own); the halo rows' gradient is then 0. After it a slab's own
    rows hold the whole gradient of the rows it owns.

    ``FoldHalo.apply(slab, z_start, full_d, halo, mesh)``."""

    @staticmethod
    def forward(ctx, slab, z_start, full_d, halo, mesh):
        ctx.geom = (z_start, full_d, halo, mesh)
        return slab.view_as(slab)

    @staticmethod
    def backward(ctx, g):
        z0, full_d, halo, mesh = ctx.geom
        sd = g.shape[0] - 2 * halo
        planes = mesh.all_gather(torch.cat([g[:halo], g[halo + sd:]]))
        with trace.span("halo_fold", device=g.device, voxels=g.numel()):
            out = g.clone()
            out[:halo] = 0.0
            out[halo + sd:] = 0.0
            for k in range(mesh.size):
                zk = k * sd
                rows = list(range(zk - halo, zk)) + list(
                    range(zk + sd, zk + sd + halo))
                for j, row in enumerate(rows):
                    row = min(max(row, 0), full_d - 1)
                    if z0 <= row < z0 + sd:
                        out[halo + row - z0] += planes[k, j]
        return out, None, None, None, None


class ReplicatedGrad(torch.autograd.Function):
    """The identity on a tensor every rank holds alike (the TF), whose
    backward sums the ranks' gradients with one ``all_reduce``:
    ``ReplicatedGrad.apply(t, mesh)``."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g), None


class SumSegments(torch.autograd.Function):
    """The sum of the ranks' segments (one ``all_reduce``), whose backward
    hands each rank the image's cotangent as it is: every rank takes the
    same loss of the same image. ``SumSegments.apply(seg, mesh)``."""

    @staticmethod
    def forward(ctx, seg, mesh):
        return mesh.all_reduce(seg)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _exclusive_scan(alpha: torch.Tensor, reverse) -> torch.Tensor:
    """``alpha (n, ...)`` in slab order -> the opacity in front of each
    slab in march order (first slab 0, or slab n-1 where ``reverse``):
    the exclusive scan of ``a + b (1 - a)``. ``reverse`` is a bool for
    every ray, or a bool tensor of ``alpha``'s trailing shape, each ray's
    own order."""
    def scan(order):
        out = [None] * alpha.shape[0]
        p = alpha[0] * 0.0  # a function of alpha, for the backward's grad
        for k in order:
            out[k] = p
            p = p + alpha[k] * (1.0 - p)
        return torch.stack(out)

    down = range(alpha.shape[0] - 1, -1, -1)
    if isinstance(reverse, bool):
        return scan(down if reverse else range(alpha.shape[0]))
    return torch.where(reverse, scan(down), scan(range(alpha.shape[0])))


class OpacityScan(torch.autograd.Function):
    """The opacity in front of this rank's slab, from the ranks' slab
    opacities: one ``all_gather`` of the ``(H, W)`` planes, the exclusive
    scan locally. The backward all-gathers the cotangents of every rank's
    upstream opacity and forms this rank's ``dA`` through the scan.
    ``OpacityScan.apply(alpha, mesh, reverse)``, ``reverse`` as
    :func:`_exclusive_scan` takes it."""

    @staticmethod
    def forward(ctx, alpha, mesh, reverse):
        ctx.mesh, ctx.reverse = mesh, reverse
        every = mesh.all_gather(alpha)
        ctx.save_for_backward(every)
        return _exclusive_scan(every, reverse)[mesh.rank]

    @staticmethod
    def backward(ctx, g):
        (every,) = ctx.saved_tensors
        mesh = ctx.mesh
        dp = mesh.all_gather(g)
        with torch.enable_grad():
            a = every.detach().requires_grad_(True)
            (da,) = torch.autograd.grad(_exclusive_scan(a, ctx.reverse), a,
                                        dp)
        return da[mesh.rank], None, None


def _sample_slab(slab: torch.Tensor, z_start: int, full_d: int,
                 pos: torch.Tensor, halo: int = 1) -> torch.Tensor:
    """Trilinear sample of one halo'd slab at world positions ``pos (N,
    3)``, on the whole volume's lattice (``volrt``'s ``_sample_slab``)."""
    return sampling.cell_sample(
        slab, slab_cell(slab.shape, (z_start - halo, full_d), pos))


def _safe_normalize(v: torch.Tensor) -> torch.Tensor:
    n2 = (v * v).sum(-1, keepdim=True)
    return v * torch.rsqrt(n2.clamp(min=1e-24))


def _slab_march(slab, z_start, full_d, tf_base, ray_step, view,
                ray_threshold, acc0_alpha=None, alpha_only=False, halo=1,
                shading=None, light_kd=0.0, rays=None) -> torch.Tensor:
    """March one slab's samples as torch ops under autograd -> the RGBA
    accumulator ``f32[H, W, 4]``, whose alpha continues from
    ``acc0_alpha (H, W)`` when given. The counterpart of ``volrt``'s
    ``_slab_march`` (its ``backend="xla"``), on the samples of
    ``slab_rays``. ``alpha_only`` skips the colour (the prepass);
    ``shading`` (``"diffuse"`` or ``"phong"``) shades as ``volrt``'s does,
    its taps inside the slab when ``halo >= shading_halo(full_d,
    shading)``. ``rays``: the view's ``get_rays(view)``."""
    dev = slab.device
    sd = slab.shape[0] - 2 * halo
    o, d, k0, kend, alive = slab_rays(view, z_start, sd, full_d, ray_step,
                                      dev, rays)
    wv, hv = view.dims
    premult = tf_mod.premultiply(tf_base)
    light_pos = view.light_pos.to(torch.float32)
    n_steps = max_steps(ray_step)
    steps = torch.arange(n_steps, dtype=torch.float32, device=dev) * ray_step

    def sample(pt):
        return _sample_slab(slab, z_start, full_d, pt, halo)

    def classify(pt):
        val = sample(pt)
        color = sampling.tf_lookup_linear(premult, val)
        if alpha_only:
            return torch.cat([torch.zeros_like(color[:, :3]),
                              color[:, 3:]], -1)
        gate = (color[:, 3] > SHADE_ALPHA_GATE) & (light_kd > SHADE_KD_GATE)
        if shading == "phong":
            comps = []
            for axis, nv in ((0, slab.shape[2]), (1, slab.shape[1]),
                             (2, full_d)):
                off = torch.zeros(3, dtype=torch.float32, device=dev)
                off[axis] = 2.0 / nv
                comps.append(sample(pt + off) - sample(pt - off))
            nrm = -_safe_normalize(torch.stack(comps, -1))
            ldir = _safe_normalize(light_pos - pt)
            half = _safe_normalize(ldir + _safe_normalize(-d))
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            ndl = torch.maximum((nrm * ldir).sum(-1), zero)
            ndh = torch.maximum((nrm * half).sum(-1), zero)
            alpha = color[:, 3]
            lit = (color[:, :3] * (PHONG_KA + light_kd * ndl)[:, None]
                   + (PHONG_KS * ndh ** PHONG_SHININESS * alpha)[:, None])
            rgb = torch.where(gate[:, None], lit, color[:, :3])
            return torch.cat([rgb, color[:, 3:]], -1)
        if shading == "diffuse":
            ldir = light_pos - pt
            ldir = ldir / torch.linalg.norm(ldir, dim=-1, keepdim=True)
            val_l = sample(pt + ldir * SHADE_LIGHT_OFFSET)
            diffuse = torch.where(gate, (val_l - val) * light_kd, 0.0)
            return torch.cat([color[:, :3] + diffuse[:, None],
                              color[:, 3:]], -1)
        return color

    def chunk(acc, live, s0):
        for step in steps[s0:s0 + CHECKPOINT_CHUNK]:
            k = k0 + step
            pt = o + d * k[:, None]
            mask = live & (k <= kend)
            acc = acc + torch.where(mask[:, None],
                                    classify(pt) * (1.0 - acc[:, 3:4]), 0.0)
            live = live & (acc[:, 3] <= ray_threshold) & (k <= kend)
        return acc, live

    acc = torch.zeros((o.shape[0], 4), dtype=torch.float32, device=dev)
    if acc0_alpha is not None:
        acc = torch.cat([acc[:, :3], acc0_alpha.reshape(-1, 1)], -1)
    live = alive & (acc[:, 3] <= ray_threshold)
    for s0 in range(0, n_steps, CHECKPOINT_CHUNK):
        if torch.is_grad_enabled():
            acc, live = checkpoint(chunk, acc, live, s0, use_reentrant=False)
        else:
            acc, live = chunk(acc, live, s0)
    return acc.reshape(hv, wv, 4)


def slab_empty_grid(own: torch.Tensor, z_start: int, full_d: int,
                    tf_base: torch.Tensor, mesh: Mesh
                    ) -> tuple[torch.Tensor, int]:
    """The whole volume's ESL grid ``(empty bool[32, 32, 32], block)`` under
    ``tf_base``, from every rank's own rows ``own (sd, H, W)``: each rank
    takes the min and max of its rows' part of every block, and one
    ``all_reduce`` (max of ``255 - min`` and of ``max``) joins the parts;
    the whole-scene grid of ``diff.render.scene_empty_grid``, bit for bit.
    """
    with torch.no_grad():
        sd, h, w = own.shape
        block = default_esl_block_dims((w, h, full_d))
        u8 = torch.round(own * 255.0).clamp(0, 255).to(torch.int32)
        b0, b1 = z_start // block, (z_start + sd - 1) // block + 1
        nby, nbx = -(-h // block), -(-w // block)
        lo = torch.full(((b1 - b0) * block, nby * block, nbx * block), 255,
                        dtype=torch.int32, device=own.device)
        hi = torch.zeros_like(lo)
        z = z_start - b0 * block
        lo[z:z + sd, :h, :w] = u8
        hi[z:z + sd, :h, :w] = u8
        n = ESL_VOLUME_DIMS
        part = torch.zeros((n, n, n, 2), dtype=torch.int32,
                           device=own.device)
        shape = (b1 - b0, block, nby, block, nbx, block)
        part[b0:b1, :nby, :nbx, 0] = 255 - lo.reshape(shape).amin(
            dim=(1, 3, 5))
        part[b0:b1, :nby, :nbx, 1] = hi.reshape(shape).amax(dim=(1, 3, 5))
        both = mesh.all_reduce(part, op="max")
        min_max = torch.stack([255 - both[..., 0], both[..., 1]], -1).to(
            torch.uint8)
        empty = esl_mod.derive_empty_grid(min_max,
                                          tf_mod.premultiply(tf_base))
    return empty, block


def render_volume_sharded(
    scene: DiffScene, view: View, mesh: Mesh,
    ray_threshold: float = 0.95,
    front_to_back: bool | None = None,
    slabs: Slab | None = None,
    backend: str = "xla",
    shading: str | None = None,
    light_kd: float = 0.6,
    esl: bool = False,
) -> torch.Tensor:
    """Render with the volume Z-slab-sharded over ``mesh`` -> ``f32[H, W,
    4]`` on every rank, differentiable with respect to the scene: each
    rank's ``scene.density`` (or ``slabs.slab``) gets the gradient of its
    own rows, every rank the whole TF gradient.

    ``ray_threshold`` is the ERT threshold, honoured across slabs (2.0
    turns it off). ``front_to_back`` is the march order of the slabs (rank
    0's first) for every ray: by default each ray's own, from the sign of
    its direction's z, since a perspective view's rays can cross the slabs
    in both orders (``volrt`` takes the view direction's for all, which
    composites the slabs of the other rays in the wrong order).
    ``slabs``: this rank's :class:`Slab` (:func:`shard_slabs_to_devices`,
    :func:`refresh_halos`, built with ``halo=shading_halo(D, shading)``
    when shading); otherwise each rank cuts its own rows from the whole
    ``scene.density`` it holds and takes its halos from the neighbours.
    ``backend``: ``"xla"``, the slab march as torch ops (any ``shading``),
    or ``"pallas"``, the march kernels' slab mode (``shading`` None or
    ``"diffuse"``; phong raises ``NotImplementedError``, as in ``volrt``).
    ``esl=True`` (``"pallas"`` only) skips the samples whose whole-volume
    cell lies in blocks that the live TF leaves empty, on the grid the
    ranks build between them (:func:`slab_empty_grid`).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if shading not in (None, "diffuse", "phong"):
        raise ValueError(f"unknown shading mode: {shading!r}")
    if shading == "phong" and backend == "pallas":
        raise NotImplementedError(
            "phong in volume-sharded mode uses the XLA backend "
            "(backend='xla'); the slab mode of the march kernels carries "
            "the diffuse tap only (shading='diffuse')")
    if esl and backend != "pallas":
        raise NotImplementedError(
            "esl in volume-sharded mode uses the pallas backend (the "
            "kernels' ESL mode; the torch slab march has none)")
    # The view's rays, once a step: each slab pass takes its samples from
    # them, and each ray its slab order from the sign of its z.
    view_rays = rays_mod.get_rays(view)
    if front_to_back is None:
        w, h = view.dims
        reverse = view_rays[1].reshape(h, w, 3)[..., 2] < 0.0
    else:
        reverse = not front_to_back
    if slabs is None:
        full_d = scene.density.shape[0]
        halo = shading_halo(full_d, shading)
        sd, z0 = slab_geometry(full_d, mesh, halo)
        slabs = refresh_halos(scene.density[z0:z0 + sd], mesh, halo, full_d)
    z0, full_d, halo = slabs.z_start, slabs.full_d, slabs.halo
    slab = FoldHalo.apply(slabs.slab, z0, full_d, halo, mesh)
    tf_base = ReplicatedGrad.apply(scene.tf_base, mesh)
    step = scene.ray_step
    if backend == "pallas":
        premult = tf_mod.premultiply(tf_base)
        eg = None
        if esl:
            eg = slab_empty_grid(slabs.slab[halo:halo + slabs.depth], z0,
                                 full_d, scene.tf_base, mesh)
        shaded = shading == "diffuse"
        rays = view.dims[0] * view.dims[1]
        # The prepass is unshaded: shading moves RGB only.
        with trace.span("slab_march", tag="prepass", rays=rays):
            a_i = render_slab_v3(slab, premult, step, view, z0, full_d,
                                 ray_threshold=2.0, esl_grid=eg,
                                 halo=halo, rays=view_rays)[0][..., 3]
        p_i = OpacityScan.apply(a_i, mesh, reverse)
        with trace.span("slab_march", tag="seeded", rays=rays):
            acc = render_slab_v3(slab, premult, step, view, z0, full_d,
                                 ray_threshold=ray_threshold, acc0=p_i,
                                 esl_grid=eg, halo=halo, shaded=shaded,
                                 light_kd=light_kd if shaded else 0.0,
                                 rays=view_rays)[0]
    else:
        a_i = _slab_march(slab, z0, full_d, tf_base, step, view, 2.0,
                          alpha_only=True, halo=halo,
                          rays=view_rays)[..., 3]
        p_i = OpacityScan.apply(a_i, mesh, reverse)
        acc = _slab_march(slab, z0, full_d, tf_base, step, view,
                          ray_threshold, acc0_alpha=p_i, halo=halo,
                          shading=shading, light_kd=light_kd,
                          rays=view_rays)
    seg = acc - torch.cat([torch.zeros_like(acc[..., :3]), p_i[..., None]],
                          -1)
    return SumSegments.apply(seg, mesh)


def gather_density(own: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """The whole density from every rank's own rows ``own (sd, H, W)``, laid
    end to end on the host (one ``all_gather``; every rank gets it)."""
    every = mesh.all_gather(own)
    return every.reshape(-1, *own.shape[1:]).cpu().numpy()
