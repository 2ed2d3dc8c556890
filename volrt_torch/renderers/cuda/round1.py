"""The round-1 differentiable march kernels' wrappers and their plain
torch versions.

Four hand-written CUDA kernels (``csrc/march_round1.cu``), one thread per
ray, replace the two kernel pairs of ``volrt``'s round-1 differentiable
renderer:

- :func:`diff_tri_fwd` / :func:`diff_tri_bwd`:
  ``volrt/renderers/pallas/diff_tri.py:_fwd_kernel`` / ``_bwd_kernel``, the
  pair whose volume and gradient are resident in the TPU's VMEM;
- :func:`diff_blocked_fwd` / :func:`diff_blocked_bwd`:
  ``volrt/renderers/pallas/diff_blocked.py:_fwd_kernel`` / ``_bwd_kernel``,
  the pair for a volume of any size in HBM.

:class:`DiffTriFunction` and :class:`DiffBlockedFunction` tie each pair into
autograd, as ``render_tiles_diff`` and ``render_tiles_diff_blocked`` do with
``custom_vjp``.

On the TPU the pairs differ in where the volume and its gradient live; on
the card every ray loads its own taps and adds its own gradient, so both
pairs compute one function and share their plain versions. Each keeps its
own entry point, wrapper and launch counter.

The march is unshaded over an f32 density in [0, 1]. It differs from
:func:`march_fwd` / :func:`march_bwd` in its lattice, which accumulates
(``k0, k0 + step, (k0 + step) + step, ...``; the ray ends when its next
``k`` exceeds ``kfar``), and in the density slope of the backward, which
round 1 takes from the clamped TF rows with no in-range flag.

On CUDA tensors a wrapper launches its kernel (built at first use) or
raises; on CPU tensors it runs its plain version, which is also what the
kernel is held to on the card. The plain versions use no autograd.
Gradients are summed with atomics on the card, so two runs agree to
rounding, not to the bit; images agree to the bit. ``diff_tri``'s pair
takes a volume under 2^31 voxels (32-bit voxel offsets);
``diff_blocked``'s takes one of any size, launching the kernels' instances
with 64-bit offsets where :func:`march.wide_offsets` says the volume needs
them.
"""
from __future__ import annotations

import torch

from volrt_torch.renderers.common import classify_and_shade, composite
from volrt_torch.renderers.cuda.march import (
    _I, _F, _P, _RAY_ARGTYPES, PLAIN_CHUNK, PlainReplay, _check, _launch,
    _ray_pointers, max_steps, wide_offsets)

# ..., out, n, width, step, max_steps, no_ert, [wide,] stream
_FWD_ARGTYPES = _RAY_ARGTYPES + [_P, _I, _I, _F, _I, _I, _P]
# ..., image, cotangent, d_vol, d_tf, n, width, step, max_steps, no_ert,
# need_dtf, need_dvol, [wide,] stream
_BWD_ARGTYPES = _RAY_ARGTYPES + [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I,
                                 _P]


def _wide_args(wide) -> tuple:
    """The entry point's trailing ``wide`` argument: none for
    ``diff_tri``'s (``wide`` None), else its type and value."""
    return ([], ()) if wide is None else ([_I], (int(wide),))


def _forward(wrapper, entry: str, o, d, k0, kfar, alive, density, premult_tf,
             scal, ray_step, no_ert, width, wide=None) -> torch.Tensor:
    """One forward wrapper; ``wide`` is None for ``diff_tri``'s, whose
    kernel has 32-bit voxel offsets only, else whether to launch the 64-bit
    instance."""
    _check(o, d, k0, kfar, alive, density, premult_tf, scal, width,
           any_size=wide is not None)
    if o.device.type == "cpu":
        return round1_fwd_plain(o, d, k0, kfar, alive, density, premult_tf,
                                scal, ray_step=ray_step, no_ert=no_ert,
                                width=width)
    n = o.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=o.device)
    if n == 0:
        return out
    types, vals = _wide_args(wide)
    _launch(entry, _FWD_ARGTYPES[:-1] + types + _FWD_ARGTYPES[-1:],
            o.device,
            *_ray_pointers(o, d, k0, kfar, alive, density, premult_tf, scal),
            out.data_ptr(), n, width, ray_step, max_steps(ray_step),
            int(no_ert), *vals)
    wrapper.launches += 1
    return out


def _backward(wrapper, entry: str, o, d, k0, kfar, alive, density, premult_tf,
              scal, out, g, ray_step, no_ert, width, need_dtf, need_dvol,
              wide=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One backward wrapper; ``wide`` as :func:`_forward`'s."""
    _check(o, d, k0, kfar, alive, density, premult_tf, scal, width,
           any_size=wide is not None, out=out, g=g)
    if o.device.type == "cpu":
        return round1_bwd_plain(
            o, d, k0, kfar, alive, density, premult_tf, scal, out, g,
            ray_step=ray_step, no_ert=no_ert, width=width,
            need_dtf=need_dtf, need_dvol=need_dvol)
    d_density = torch.zeros_like(density)
    d_tf = torch.zeros_like(premult_tf)
    n = o.shape[0]
    if n == 0 or not (need_dtf or need_dvol):
        return d_density, d_tf
    types, vals = _wide_args(wide)
    _launch(entry, _BWD_ARGTYPES[:-1] + types + _BWD_ARGTYPES[-1:],
            o.device,
            *_ray_pointers(o, d, k0, kfar, alive, density, premult_tf, scal),
            out.data_ptr(), g.data_ptr(), d_density.data_ptr(),
            d_tf.data_ptr(), n, width, ray_step, max_steps(ray_step),
            int(no_ert), int(need_dtf), int(need_dvol), *vals)
    wrapper.launches += 1
    return d_density, d_tf


def diff_tri_fwd(o, d, k0, kfar, alive, density, premult_tf, scal, *,
                 ray_step: float, no_ert: bool, width: int) -> torch.Tensor:
    """March N rays through ``density`` on the accumulating lattice and
    composite them, unshaded -> ``f32[N, 4]``.

    The arguments are :func:`march_fwd`'s without ``shade``: rays in raster
    order (``width`` a row), ``density`` ``f32[D, H, W]`` in [0, 1],
    ``premult_tf`` ``f32[TF_SIZE, 4]``, ``scal`` ``f32[8]`` of which only
    the ERT threshold ``scal[0]`` is read. The first sample of a live ray
    lies at ``k0`` and is always taken; each further one at the last ``k``
    plus ``ray_step``, while that is ``<= kfar`` and ERT has not latched.

    CPU tensors take :func:`round1_fwd_plain`. CUDA tensors launch the
    kernel, building it at first use, and raise if it cannot launch.
    """
    return _forward(diff_tri_fwd, "volrt_diff_tri_fwd", o, d, k0, kfar,
                    alive, density, premult_tf, scal, ray_step, no_ert, width)


diff_tri_fwd.launches = 0


def diff_blocked_fwd(o, d, k0, kfar, alive, density, premult_tf, scal, *,
                     ray_step: float, no_ert: bool, width: int,
                     wide: bool | None = None) -> torch.Tensor:
    """As :func:`diff_tri_fwd`, through the entry point that replaces
    ``diff_blocked._fwd_kernel``, for a volume of any size: ``wide`` (by
    default :func:`march.wide_offsets` of its shape) launches the
    kernel's instance with 64-bit voxel offsets.

    CPU tensors take :func:`round1_fwd_plain`. CUDA tensors launch the
    kernel or raise.
    """
    if wide is None:
        wide = wide_offsets(density.shape)
    return _forward(diff_blocked_fwd, "volrt_diff_blocked_fwd", o, d, k0,
                    kfar, alive, density, premult_tf, scal, ray_step, no_ert,
                    width, wide)


diff_blocked_fwd.launches = 0


def diff_tri_bwd(o, d, k0, kfar, alive, density, premult_tf, scal, out, g, *,
                 ray_step: float, no_ert: bool, width: int,
                 need_dtf: bool = True, need_dvol: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`diff_tri_fwd`
    -> ``(d_density f32[D, H, W], d_premult_tf f32[TF_SIZE, 4])``.

    ``out`` is the image the forward returned and ``g`` its cotangent, both
    ``f32[N, 4]``. The march is replayed on the forward's lattice. A ray
    that is not alive, or whose cotangent is zero, sends no gradient.
    ``need_dtf=False`` / ``need_dvol=False`` skip that leaf's scatter and
    return zeros for it.

    CPU tensors take :func:`round1_bwd_plain`. CUDA tensors launch the
    kernel or raise. Both gradients are zero-filled here and accumulated
    into with atomics, so two runs on the card differ by rounding.
    """
    return _backward(diff_tri_bwd, "volrt_diff_tri_bwd", o, d, k0, kfar,
                     alive, density, premult_tf, scal, out, g, ray_step,
                     no_ert, width, need_dtf, need_dvol)


diff_tri_bwd.launches = 0


def diff_blocked_bwd(o, d, k0, kfar, alive, density, premult_tf, scal, out,
                     g, *, ray_step: float, no_ert: bool, width: int,
                     need_dtf: bool = True, need_dvol: bool = True,
                     wide: bool | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """As :func:`diff_tri_bwd`, through the entry point that replaces
    ``diff_blocked._bwd_kernel``, for a volume of any size (``wide`` as
    :func:`diff_blocked_fwd`'s: the dVol scatter's addresses are 64-bit
    too).

    CPU tensors take :func:`round1_bwd_plain`. CUDA tensors launch the
    kernel or raise.
    """
    if wide is None:
        wide = wide_offsets(density.shape)
    return _backward(diff_blocked_bwd, "volrt_diff_blocked_bwd", o, d, k0,
                     kfar, alive, density, premult_tf, scal, out, g,
                     ray_step, no_ert, width, need_dtf, need_dvol, wide)


diff_blocked_bwd.launches = 0


def round1_fwd_plain(o, d, k0, kfar, alive, density, premult_tf, scal, *,
                     ray_step: float, no_ert: bool, width: int
                     ) -> torch.Tensor:
    """The plain torch version of :func:`diff_tri_fwd` and
    :func:`diff_blocked_fwd`, same arguments.

    All rays of a chunk step in lockstep for at most ``max_steps(ray_step)``
    steps, with masks in place of the kernel's per-ray ``break``; ``k``
    gains one ``+ ray_step`` per step. ``width`` only shapes the kernel's
    blocks and is unused here.
    """
    del width
    out = torch.empty((o.shape[0], 4), dtype=torch.float32, device=o.device)
    thr = scal[0]
    for lo in range(0, o.shape[0], PLAIN_CHUNK):
        sl = slice(lo, lo + PLAIN_CHUNK)
        oc, dc, kf = o[sl], d[sl], kfar[sl]
        k, live = k0[sl], alive[sl]
        acc = torch.zeros((oc.shape[0], 4), dtype=torch.float32,
                          device=o.device)
        for _ in range(max_steps(ray_step)):
            color = classify_and_shade(density, premult_tf,
                                       oc + dc * k[:, None])
            acc = torch.where(live[:, None], composite(acc, color), acc)
            k = k + ray_step
            live = live & (k <= kf)
            if not no_ert:
                live = live & ~(acc[:, 3] > thr)
        out[sl] = acc
    return out


def round1_bwd_plain(o, d, k0, kfar, alive, density, premult_tf, scal, out,
                     g, *, ray_step: float, no_ert: bool, width: int,
                     need_dtf: bool = True, need_dvol: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version of :func:`diff_tri_bwd` and
    :func:`diff_blocked_bwd`, same arguments.

    The suffix-sum backward of ``volrt/renderers/pallas/diff_tri.py:
    227-304`` one lockstep step at a time (:class:`PlainReplay` without
    its in-range flag), replaying :func:`round1_fwd_plain`'s lattice. dTF
    is summed in f64.
    """
    del width
    replay = PlainReplay(density, premult_tf, scal, shade=False,
                         need_dtf=need_dtf, need_dvol=need_dvol,
                         in_range=False)
    thr = scal[0]
    for c0 in range(0, o.shape[0], PLAIN_CHUNK):
        sl = slice(c0, c0 + PLAIN_CHUNK)
        oc, dc, kf = o[sl], d[sl], kfar[sl]
        k, live = k0[sl], alive[sl]
        replay.start(g[sl], out[sl])
        for _ in range(max_steps(ray_step)):
            acc_a = replay.sample(oc + dc * k[:, None], live)
            k = k + ray_step
            live = live & (k <= kf)
            if not no_ert:
                live = live & ~(acc_a > thr)
    return replay.gradients()


# Each wrapper's plain version by the wrapper's name.
diff_tri_fwd_plain = diff_blocked_fwd_plain = round1_fwd_plain
diff_tri_bwd_plain = diff_blocked_bwd_plain = round1_bwd_plain


def _function_forward(ctx, fwd, density, premult_tf, o, d, k0, kfar, alive,
                      scal, ray_step, no_ert, width):
    out = fwd(o, d, k0, kfar, alive, density, premult_tf, scal,
              ray_step=ray_step, no_ert=no_ert, width=width)
    ctx.save_for_backward(o, d, k0, kfar, alive, density, premult_tf, scal,
                          out)
    ctx.kw = dict(ray_step=ray_step, no_ert=no_ert, width=width)
    return out


def _function_backward(ctx, bwd, g):
    need_dvol, need_dtf = ctx.needs_input_grad[:2]
    d_density, d_tf = bwd(*ctx.saved_tensors, g.contiguous(),
                          need_dtf=need_dtf, need_dvol=need_dvol, **ctx.kw)
    return (d_density if need_dvol else None,
            d_tf if need_dtf else None) + (None,) * 9


class DiffTriFunction(torch.autograd.Function):
    """:func:`diff_tri_fwd` under autograd, with :func:`diff_tri_bwd` as
    its backward (the counterpart of ``render_tiles_diff``'s custom_vjp).

    ``DiffTriFunction.apply(density, premult_tf, o, d, k0, kfar, alive,
    scal, ray_step, no_ert, width)`` returns the image ``f32[N, 4]``.
    Gradients flow to ``density`` and ``premult_tf`` only; a leaf that does
    not require one skips its scatter.
    """

    @staticmethod
    def forward(ctx, *args):
        return _function_forward(ctx, diff_tri_fwd, *args)

    @staticmethod
    def backward(ctx, g):
        return _function_backward(ctx, diff_tri_bwd, g)


class DiffBlockedFunction(torch.autograd.Function):
    """:func:`diff_blocked_fwd` under autograd, with
    :func:`diff_blocked_bwd` as its backward (the counterpart of
    ``render_tiles_diff_blocked``'s custom_vjp). Called as
    :class:`DiffTriFunction`."""

    @staticmethod
    def forward(ctx, *args):
        return _function_forward(ctx, diff_blocked_fwd, *args)

    @staticmethod
    def backward(ctx, g):
        return _function_backward(ctx, diff_blocked_bwd, g)
