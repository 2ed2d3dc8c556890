"""The plain reference of the volume-sharded trainer (``synth1792-fit``): the
unsharded f32 L2 step of the whole volume, which is what Z-slab volume
sharding computes (the image and gradient of the whole march, up to the
rounding of the opacity in front of each slab).

It imports nothing of the program and no JAX, and reuses ``reference.py``'s
rays, cells, TF lerp and compositing. ``reference.l2_loss_grads`` cannot
serve at 1792^3: each chunk of rays makes whole-volume temporaries, and its
``Adam`` holds two more whole-volume moments. Here a chunk's eight taps of
every sample are gathered into a leaf of their own, autograd runs through
the march of those taps alone, and their gradients are added into one f32
gradient of the volume (``index_add_``): no whole-volume temporary a chunk.
The rays are split over the ranks of the caller's process group in equal
runs, and one ``all_reduce`` of plain ``torch.distributed`` sums the
gradient. Adam's first step is taken in place from the gradient alone
(the moments of a first step are functions of it), and the second step's
loss needs no gradient. So a rank holds the density and its gradient, f32,
and a chunk's samples.

The inputs are made here too, a row of the volume at a time, so that a rank
of the program makes its own rows alone and every rank and the reference
the same volume. The faults and the control that the cell's limits are
set against are computed here as well (:func:`first_steps`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from portbench import reference as ref

# Rows each side of a slab plane that the ``planes`` leaf holds: a halo
# fold lost shows there.
PLANE_ROWS = 2
FAULTS = ("no_scan", "halo_dropped", "half_batch", "unchanged")


def row_seed(seed: int, stream: int, row: int) -> int:
    """A 63-bit seed of each row's noise, from the run's seed and stream."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), int(stream),
                                    int(row)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def density_rows(n: int, z0: int, z1: int, seed: int, device,
                 stream: int = 0, noise: float = 20.0) -> torch.Tensor:
    """Rows ``z0 .. z1 - 1`` of the synthetic ``n^3`` density, ``f32[z1 -
    z0, n, n]``, made on ``device``: the volume of ``reference.py``'s
    ``synthetic_volume`` (a shell of 200 at 0.7 of the radius, a blob of
    255, noise in ``[0, noise)``, clipped and truncated to uint8) over 255;
    each row's noise drawn from a generator seeded from ``(seed, stream,
    row)`` alone."""
    c = (n - 1) / 2.0
    ax = (torch.arange(n, dtype=torch.float32, device=device) - c) ** 2
    yx = ax[:, None] + ax[None, :]
    out = torch.empty((z1 - z0, n, n), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    for z in range(z0, z1):
        gen.manual_seed(row_seed(seed, stream, z))
        r = torch.sqrt(ax[z] + yx) / c
        v = (torch.exp(-((r - 0.7) ** 2) / 0.02) * 200.0
             + torch.exp(-(r ** 2) / 0.08) * 255.0
             + torch.rand(r.shape, generator=gen, device=device) * noise)
        out[z - z0] = v.clamp(0.0, 255.0).to(torch.uint8).to(
            torch.float32) / 255.0
    return out


# ------------------------------------------------------------- geometry

def slab_depth(full_d: int, n_slabs: int) -> int:
    if full_d % n_slabs:
        raise ValueError(f"depth {full_d} does not split into {n_slabs}")
    return full_d // n_slabs


def leaf_rows(full_d: int, n_slabs: int, plane_rows: int = PLANE_ROWS
              ) -> list[list[tuple[int, int]]]:
    """The leaves the check compares, as row ranges ``[z0, z1)`` of the
    density: each slab's own rows, then the rows within ``plane_rows`` of
    a slab plane (``planes``). The TF is the last leaf, not listed."""
    sd = slab_depth(full_d, n_slabs)
    slabs = [[(s * sd, (s + 1) * sd)] for s in range(n_slabs)]
    planes = [(p * sd - plane_rows, p * sd + plane_rows)
              for p in range(1, n_slabs)]
    return slabs + [planes]


def share(r: dict, rank: int, size: int) -> tuple[dict, slice]:
    """The rays of ``r`` that rank ``rank`` of ``size`` marches: an equal
    run of them in raster order (the last rank's may be shorter)."""
    n = r["o"].shape[0]
    per = -(-n // size)
    sl = slice(min(rank * per, n), min((rank + 1) * per, n))
    return _part(r, sl), sl


def slab_range(r: dict, z_start: int, slab_d: int, full_d: int,
               ray_step: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The lattice indices ``[j_in, j_out)`` of each ray that the slab of
    rows ``z_start .. z_start + slab_d - 1`` marches: ``J = ceil(max(k -
    knear, 0) / step)`` of the ray's parameters at the slab's two z planes;
    the slab that holds the far face in the ray's direction takes every
    index from ``j_in`` on (``j_out`` infinite). A zero z direction counts
    as 1e-5."""
    o, d, knear = r["o"], r["d"], r["knear"]
    f32 = dict(dtype=torch.float32, device=o.device)
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
    far = torch.zeros_like(r["hit"])
    if z_start + slab_d == full_d:
        far = far | (dz > 0.0)
    if z_start == 0:
        far = far | (dz < 0.0)
    return j_in, torch.where(far, math.inf, j_out)


# ---------------------------------------------------------------- march

def _chunk_size(r: dict, ray_step: float, points: int) -> int:
    return max(1, points // max(1, ref._span_steps(r, slice(None),
                                                   ray_step)))


def _part(r: dict, sl: slice) -> dict:
    return {k: (v[sl] if torch.is_tensor(v) and v.dim() and k != "light"
                else v) for k, v in r.items()}


def _slab_lattice(part: dict, k: torch.Tensor, ray_step: float,
                  n_slabs: int, full_d: int) -> torch.Tensor:
    """``k [n, s]``, each sample's parameter ``knear + j * step``, as the
    slab kernels compute it instead: ``(knear + J_in * step) + i * step``
    in f32, ``J_in`` the first index of the slab that takes the sample
    (:func:`slab_range`; ``diff_v3.slab_rays``) and ``i = j - J_in``."""
    sd = slab_depth(full_d, n_slabs)
    step = torch.full((), ray_step, dtype=k.dtype, device=k.device)
    j = torch.arange(k.shape[1], dtype=k.dtype, device=k.device)[None, :]
    for s in range(n_slabs):
        a, b = slab_range(part, s * sd, sd, full_d, ray_step)
        k0 = part["knear"] + a * step
        inside = (j >= a[:, None]) & (j < b[:, None])
        k = torch.where(inside, k0[:, None] + (j - a[:, None]) * step, k)
    return k


def _march_chunk(flat, shape, tf_premult, part: dict, *, ray_step: float,
                 thr: float, rnd, grad: bool, slabs=None,
                 lattice=None) -> dict:
    """One chunk of rays' samples, every one classified at once and
    composited by a product scan (``reference.march_scan``'s form) ->
    ``out [n, 4]``; ``taps [P, 8]``, the samples' eight taps, and ``rows``,
    the two TF rows each sample lerps (leaves when ``grad``), with their
    indices ``idx [P, 8]`` (flat voxels) and ``tf_idx``; ``j [n, s]`` the
    lattice index of each sample, ``valid`` the lattice samples and
    ``taken`` those the march takes. ``rnd`` rounds the taps as stored
    (the control). ``slabs = (n_slabs, full_d)`` composites each slab's
    samples from zero opacity and sums the slabs (the fault of a lost
    opacity scan). ``lattice = (n_slabs, full_d)`` places the samples as
    the slab kernels do (:func:`_slab_lattice`)."""
    n = ref._span_steps(part, slice(None), ray_step)
    dtype = part["o"].dtype
    rays_n = part["o"].shape[0]
    steps = torch.arange(n, dtype=dtype, device=flat.device) * ray_step
    k = part["k0"][:, None] + steps[None, :]
    if lattice is not None:
        k = _slab_lattice(part, k, ray_step, *lattice)
    valid = part["alive"][:, None] & (k <= part["kfar"][:, None])
    pt = (part["o"][:, None, :] + part["d"][:, None, :] * k[..., None]
          ).reshape(-1, 3)
    _, (i0, i1, frac) = ref.cell(shape, pt)
    _, h, w = shape
    (x0, y0, z0), (x1, y1, z1) = i0.unbind(-1), i1.unbind(-1)
    fx, fy, fz = frac.unbind(-1)
    idx = torch.stack([(z * h + y) * w + x
                       for z in (z0, z1) for y in (y0, y1)
                       for x in (x0, x1)], -1)
    del pt, i0, i1, frac
    taps = flat.index_select(0, idx.reshape(-1)).reshape(idx.shape)
    if rnd is not None:
        taps = rnd(taps)
    if grad:
        taps.requires_grad_(True)
    t = taps.unbind(-1)
    c0 = ref._lerp(ref._lerp(t[0], t[1], fx), ref._lerp(t[2], t[3], fx), fy)
    c1 = ref._lerp(ref._lerp(t[4], t[5], fx), ref._lerp(t[6], t[7], fx), fy)
    # reference.tf_lerp, its two rows kept as leaves of their own.
    u = ref._lerp(c0, c1, fz) * ref.TF_SIZE - 0.5
    lo = torch.floor(u)
    tfrac = (u - lo)[..., None]
    lo = lo.to(torch.int64)
    tf_idx = [i.clamp(0, ref.TF_SIZE - 1) for i in (lo, lo + 1)]
    rows = [tf_premult.index_select(0, i) for i in tf_idx]
    if grad:
        for r in rows:
            r.requires_grad_(True)
    color = ref._lerp(rows[0], rows[1], tfrac)
    color = color.reshape(rays_n, n, 4) * valid[..., None]
    j = torch.arange(n, device=flat.device)[None, :].expand(rays_n, n)
    groups = [None]
    if slabs is not None:
        n_slabs, full_d = slabs
        sd = slab_depth(full_d, n_slabs)
        which = torch.zeros_like(j)
        for s in range(n_slabs):
            a, b = slab_range(part, s * sd, sd, full_d, ray_step)
            which = torch.where((j >= a[:, None]) & (j < b[:, None]), s,
                                which)
        groups = [which == s for s in range(n_slabs)]
    out = 0.0
    taken = torch.zeros_like(valid)
    for g in groups:
        c = color if g is None else color * g[..., None]
        trans = torch.cumprod(1.0 - c[..., 3], dim=1)
        before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
        active = valid if g is None else valid & g
        if thr < 1.0:
            ended = active & (1.0 - trans.detach() > thr)
            active = active & ((ended.cumsum(1) - ended.to(torch.int64))
                               == 0)
        out = out + (c * (before * active)[..., None]).sum(1)
        taken = taken | active
    return {"out": out, "taps": taps, "idx": idx, "rows": rows,
            "tf_idx": tf_idx, "j": j, "valid": valid, "taken": taken}


def march_loss(density: torch.Tensor, tf_base: torch.Tensor, r: dict,
               target: torch.Tensor, n_total: int, *, ray_step: float,
               thr: float, points: int, grad: torch.Tensor | None = None,
               rnd=None, fault: str | None = None, n_slabs: int = 1,
               slab_lattice: bool = False
               ) -> tuple[float, torch.Tensor | None]:
    """The L2 loss's share of the rays ``r`` (targets ``target [n, 4]``)
    in the mean over ``n_total`` rays' colours, of the march of
    ``density`` under the premultiplied ``tf_base`` -> ``(loss share,
    d_tf_base share or None)``. With ``grad`` (a flat f32 tensor of the
    density's size) the density's gradient share is added into it, and
    the TF's returned (f64). ``rnd`` rounds the density as stored (the
    control). ``fault``: ``"no_scan"`` composites each of the ``n_slabs``
    slabs from zero opacity; ``"halo_dropped"`` drops the gradient that a
    slab's samples give rows outside the slab. ``slab_lattice`` takes each
    sample where the slab kernels put it (:func:`_slab_lattice`)."""
    flat = density.reshape(-1)
    shape = tuple(density.shape)
    full_d = shape[0]
    sd = slab_depth(full_d, n_slabs)
    hw = shape[1] * shape[2]
    scale = 1.0 / (n_total * 4.0)
    chunk = _chunk_size(r, ray_step, points)
    premult = ref.premultiply(tf_base.detach())
    # The premultiplied TF's gradient, summed in f64: a chunk's millions of
    # samples add into a few rows.
    d_premult = torch.zeros(premult.shape, dtype=torch.float64,
                            device=flat.device)
    total = 0.0
    with torch.set_grad_enabled(grad is not None):
        for lo in range(0, r["o"].shape[0], chunk):
            sl = slice(lo, lo + chunk)
            part = _part(r, sl)
            c = _march_chunk(
                flat, shape, premult, part, ray_step=ray_step, thr=thr,
                rnd=rnd, grad=grad is not None,
                slabs=(n_slabs, full_d) if fault == "no_scan" else None,
                lattice=(n_slabs, full_d) if slab_lattice else None)
            diff = c["out"] - target[sl]
            part_loss = (diff * diff).sum() * scale
            total += float(part_loss.detach())
            if grad is None:
                continue
            part_loss.backward()
            for i, row in zip(c["tf_idx"], c["rows"]):
                d_premult.index_add_(0, i, row.grad.to(torch.float64))
            g = c["taps"].grad
            if fault == "halo_dropped":
                which = torch.zeros_like(c["j"])
                for s in range(n_slabs):
                    a, b = slab_range(part, s * sd, sd, full_d, ray_step)
                    which = torch.where((c["j"] >= a[:, None])
                                        & (c["j"] < b[:, None]), s, which)
                own = c["idx"] // hw // sd == which.reshape(-1, 1)
                g = torch.where(own, g, 0.0)
            grad.index_add_(0, c["idx"].reshape(-1), g.reshape(-1))
            del c, diff, part_loss, g
    if grad is None:
        return total, None
    base = tf_base.detach().to(torch.float64).requires_grad_(True)
    ref.premultiply(base).backward(d_premult)
    return total, base.grad


# ------------------------------------------------------------ the check

def _all_reduce(t: torch.Tensor, size: int) -> torch.Tensor:
    if size > 1:
        dist.all_reduce(t)
    return t


def sq_sum(t: torch.Tensor, rows: int = 16) -> float:
    """The sum of ``t``'s squares in f64, ``rows`` of its first axis at a
    time (no f64 copy of the whole)."""
    return sum(float(torch.linalg.vector_norm(
        t[i:i + rows].to(torch.float64)) ** 2)
        for i in range(0, t.shape[0], rows))


def _adam_first(p: torch.Tensor, g: torch.Tensor, lr: float) -> None:
    """Adam's first step (bias-corrected, ``eps`` outside the root) and the
    clamp to [0, 1], in place on ``p``, from the gradient alone: the
    moments are ``(1 - b1) g`` and ``(1 - b2) g^2``."""
    b1, b2 = ref.ADAM_BETAS
    m = g * (1 - b1)
    v = (g * g) * (1 - b2)
    p.sub_(lr / (1 - b1) * m / (v.sqrt() / math.sqrt(1 - b2)
                               + ref.ADAM_EPS))
    p.clamp_(0.0, 1.0)


def first_steps(density: torch.Tensor, tf0: torch.Tensor, views: list,
                targets: list, *, ray_step: float, thr: float, lr: float,
                n_slabs: int, points: int, rank: int = 0, size: int = 1,
                rnd=None, fault: str | None = None,
                chunk_rows: int = 16, leaves: list | None = None) -> dict:
    """The reference's readings over the trainer's first two steps, from
    ``density`` (the whole volume, updated in place) and ``tf0``: each
    step's loss, the norm of each leaf's gradient in the first step
    (:func:`leaf_rows`' slabs and planes, then the TF) and of each leaf's
    change after it. Step 1 takes ``views[0]`` and its gradient; step 2
    ``views[1]``, its loss alone. The rays of each view are split over the
    ``size`` ranks of the default process group (:func:`share`); every
    rank calls this and gets the readings.

    ``rnd`` rounds the density as stored (the control); ``fault`` is one of
    :data:`FAULTS`: no opacity scan, the halo's gradient dropped, half of
    each view's rays (the mean over the rest), or the state left
    unchanged (no update: a first gradient and a change of 0). ``leaves``
    replaces :func:`leaf_rows`' leaves (row ranges, as it gives them)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    dev = density.device
    full_d = density.shape[0]
    if leaves is None:
        leaves = leaf_rows(full_d, n_slabs)
    kw = dict(ray_step=ray_step, thr=thr, points=points, rnd=rnd,
              n_slabs=n_slabs,
              fault=fault if fault in ("no_scan", "halo_dropped") else None)

    def rays_of(k):
        r = ref.v3_rays(views[k], dev)
        tgt = targets[k].reshape(-1, 4)
        if fault == "half_batch":
            r = _part(r, slice(0, r["o"].shape[0] // 2))
        part, sl = share(r, rank, size)
        return part, tgt[sl], r["o"].shape[0]

    part, tgt, n_total = rays_of(0)
    grad = (None if fault == "unchanged" else
            torch.zeros(density.numel(), dtype=torch.float32, device=dev))
    loss1, d_tf = march_loss(density, tf0, part, tgt, n_total, grad=grad,
                             **kw)
    if fault == "unchanged":
        d_tf = torch.zeros(tf0.shape, dtype=torch.float64, device=dev)
    else:
        _all_reduce(grad, size)
    small = _all_reduce(torch.cat([torch.tensor([loss1], device=dev,
                                                dtype=torch.float64),
                                   d_tf.reshape(-1)]), size)
    loss1, d_tf = float(small[0]), small[1:].reshape(tf0.shape)
    out = {"loss": [loss1]}
    tf1 = tf0.detach().clone()
    if fault == "unchanged":
        out["grad1"] = [0.0] * (len(leaves) + 1)
        out["change"] = [0.0] * (len(leaves) + 1)
    else:
        grad = grad.reshape(density.shape)
        out["grad1"] = [math.sqrt(s) for s in sq_norms_at(grad, 0, leaves)]
        out["grad1"].append(float(torch.linalg.vector_norm(d_tf)))
        change = [0.0] * len(leaves)
        for z in range(0, full_d, chunk_rows):
            rows = slice(z, min(z + chunk_rows, full_d))
            before = density[rows].clone()
            _adam_first(density[rows], grad[rows], lr)
            moved = density[rows] - before
            for i, sq in enumerate(sq_norms_at(moved, z, leaves)):
                change[i] += sq
        _adam_first(tf1, d_tf.to(torch.float32), lr)
        out["change"] = [math.sqrt(c) for c in change] + [
            float(torch.linalg.vector_norm((tf1 - tf0).to(torch.float64)))]
    del grad
    part, tgt, n_total = rays_of(1)
    loss2, _ = march_loss(density, tf1, part, tgt, n_total, **kw)
    out["loss"].append(float(_all_reduce(
        torch.tensor([loss2], dtype=torch.float64, device=dev), size)[0]))
    return out


def sq_norms_at(t: torch.Tensor, z0: int, leaves: list) -> list[float]:
    """The squared norm of the rows of each leaf's ranges (:func:`leaf_rows`)
    that ``t`` holds: rows ``z0 .. z0 + len(t) - 1`` of the density."""
    z1 = z0 + t.shape[0]
    out = []
    for rows in leaves:
        sq = 0.0
        for a, b in rows:
            a, b = max(a, z0), min(b, z1)
            if a < b:
                sq += sq_sum(t[a - z0:b - z0])
        out.append(sq)
    return out


def render(density: torch.Tensor, tf_base: torch.Tensor, views: list, *,
           ray_step: float, thr: float, rank: int = 0, size: int = 1
           ) -> list[torch.Tensor]:
    """Each view's f32 image ``[H, W, 4]`` (``reference.march_v3``,
    unshaded), the rays split over the ranks (:func:`share`) and gathered
    with one ``all_gather`` a view (plain ``torch.distributed``)."""
    dev = density.device
    premult = ref.premultiply(tf_base)
    rs = [share(ref.v3_rays(v, dev), rank, size)[0] for v in views]
    with torch.no_grad():
        img = ref.march_v3(ref.cat_rays(rs), density, premult,
                           ray_step=ray_step, thr=thr)
    out, lo = [], 0
    for v, r in zip(views, rs):
        w, h = v["dims"]
        mine = img[lo:lo + r["o"].shape[0]]
        lo += r["o"].shape[0]
        padded = torch.zeros((-(-h * w // size), 4), dtype=img.dtype,
                             device=dev)
        padded[:mine.shape[0]] = mine
        if size > 1:
            parts = [torch.empty_like(padded) for _ in range(size)]
            dist.all_gather(parts, padded)
            padded = torch.cat(parts)
        out.append(padded[:h * w].reshape(h, w, 4))
    return out


def slab_samples(density: torch.Tensor, tf_base: torch.Tensor, view: dict,
                 target: torch.Tensor, *, ray_step: float, thr: float,
                 z_start: int, slab_d: int, points: int, rank: int = 0,
                 size: int = 1) -> dict:
    """The samples that the slab of rows ``z_start .. z_start + slab_d - 1``
    takes in a training step on ``view`` (its target ``target [H, W, 4]``),
    on the whole ``density`` and ``tf_base``, in each of its four launches:
    ``prepass``, every lattice sample of a ray that falls in the slab (ERT
    off); ``seeded``, the samples of the whole march with ERT at ``thr``
    that fall in it; each replay, its forward's samples of the rays whose
    cotangent is not zero (the replay kernel's ``start_replay`` returns
    before the first sample for a ray whose cotangent is zero in all four
    channels): ``seeded_replay``, of the rays whose colour differs from
    the target's (the loss's cotangent, which the segments' sum hands on
    as it is); ``prepass_replay``, of those that also take samples after
    the slab (the opacity in front of a later slab is what the prepass
    gives; a later slab that takes no sample gives its seed a cotangent
    of ``g.a - g.a = 0``). The rays split over the ranks, the counts
    summed."""
    dev = density.device
    full_d = density.shape[0]
    r, sl = share(ref.v3_rays(view, dev), rank, size)
    tgt = target.reshape(-1, 4)[sl]
    flat = density.reshape(-1)
    premult = ref.premultiply(tf_base)
    chunk = _chunk_size(r, ray_step, points)
    counts = torch.zeros(4, dtype=torch.float64, device=dev)
    with torch.no_grad():
        for lo in range(0, r["o"].shape[0], chunk):
            part = _part(r, slice(lo, lo + chunk))
            c = _march_chunk(flat, tuple(density.shape), premult, part,
                             ray_step=ray_step, thr=thr, rnd=None,
                             grad=False)
            a, b = slab_range(part, z_start, slab_d, full_d, ray_step)
            inside = (c["j"] >= a[:, None]) & (c["j"] < b[:, None])
            lattice = (c["valid"] & inside).sum(1)
            seeded = (c["taken"] & inside).sum(1)
            replayed = (c["out"] != tgt[lo:lo + chunk]).any(-1)
            later = c["taken"].sum(1) > b
            counts += torch.stack([lattice.sum(), seeded.sum(),
                                   (seeded * replayed).sum(),
                                   (lattice * (replayed & later)).sum()])
    _all_reduce(counts, size)
    return dict(zip(("prepass", "seeded", "seeded_replay", "prepass_replay"),
                    (int(c) for c in counts)))
