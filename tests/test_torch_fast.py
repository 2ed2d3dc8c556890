"""The port's fast mode against ``volrt``'s ``fast=True``: the density
stored as bf16 and each trilinear sample taken as ``volrt``'s v3 kernels
take it in that mode, ``sum_x hat_x (sum_{z,y} bf16(hat_z hat_y) v)`` on
the clipped voxel coordinate, with the backward's scatter in f32.

Scenes, views and targets are made with numpy from a seed and handed to
both packages; the port runs its plain versions on the CPU (the kernels'
bf16 instances are held to them on the card, ``chip_smoke.py`` phase 22),
and ``volrt``'s Pallas kernels run in interpret mode. Each interpret call
costs 3-14 s, so every reference is computed once.

Tolerances are the f32 classes of ``test_torch_diff.py`` and
``test_torch_render.py``: images 2e-4 (2e-3 for rung 5 with the diffuse
tap, whose light direction the two packages normalise apart), the loss
rtol 1e-6, gradients within 5e-6. Measured on these scenes: images 1.3e-4
(rung 5 diffuse 3.3e-4), the loss 2e-7, d_density 1.3e-7, d_tf_base
2.8e-6. Phong (here with ESL), whose gradient ``volrt`` takes as a
difference of hat weights in one sum where the port differences two
samples, needs no class of its own: its loss 9e-8, d_density 2e-8,
d_tf_base 2.2e-6.

Rung 5 unshaded is the exception. Its f32 images already part from
``volrt``'s by 1.4e-5 on this pose (the two packages set up its rays in
other operations), and in the fast mode a position that moves by that
much can carry a (z, y) weight product across a bf16 rounding midpoint:
the sample then moves by up to 2^-8 of a tap. One pixel of 1024 differs
by 3.2e-4 (ERT off alike, so no ERT latch flips), the next by 1.6e-5. It
is held to 2e-4 but for at most 2 pixels, and those to 1e-3
(``ATOL_FLIP``).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_diff import ATOL_GRAD, ATOL_IMG, _jax_image_loss_grads
from tests.test_torch_diff import _pair
from tests.test_torch_render import _rcs
from tests.test_torch_slab import N as SLAB_N
from tests.test_torch_slab import STEP as SLAB_STEP
from tests.test_torch_slab import _seed, _views
from tests.conftest import synthetic_volume
from volrt.core.tf import default_transfer_fn as jdefault_tf
from volrt.dist import volume_sharded as jvs
from volrt.renderers.pallas import diff_v3 as jdiff_v3
from volrt.renderers.pallas import fwd_v3 as jfwd_v3
from volrt.renderers.pallas.diff_v3 import render_slab_v3 as jrender_slab
from volrt_torch import cli
from volrt_torch.bench import __main__ as headline
from volrt_torch.bench import harness
from volrt_torch.bench.step_ab import variant_name
from volrt_torch.core import sampling
from volrt_torch.core.tf import premultiply
from volrt_torch.diff import fused as tfused
from volrt_torch.diff import render as trender
from volrt_torch.dist import volume_sharded as tvs
from volrt_torch.renderers import diff_v3 as tdiff_v3
from volrt_torch.renderers import fwd_v3
from volrt_torch.renderers.cuda import march

CPU = "cpu"
RTOL_LOSS = 1e-6
# Rung 5 with the diffuse tap (test_torch_render.py's shade-tap class).
ATOL_RUNG5_DIFFUSE = 2e-3
# One (z, y) weight product's bf16 rounding flipped (module docstring).
ATOL_FLIP = 1e-3
FLIPPED_PIXELS = 2
DIFFUSE = dict(shaded=True, light_kd=0.6, ray_threshold=0.95)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _close(got, want, atol, what):
    want = np.asarray(want)
    assert np.abs(want).max() > 0, what
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0,
                               err_msg=what)


def test_bf16_copy_rounds_as_jax_does():
    """torch's ``.to(torch.bfloat16)`` gives ``jnp.astype(jnp.bfloat16)``'s
    bits on 1e5 seeded uniforms and on ties to even in both directions
    (the fast mode's stored density, and its weight rounding)."""
    x = np.random.default_rng(7).uniform(0, 1, 100_000).astype(np.float32)
    ties = np.array([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 0.5 + 2.0 ** -9,
                     -(1 + 2.0 ** -8)], np.float32)
    x = np.concatenate([x, ties])
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sampling.round_bf16(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)))


def test_render_image_v3_fast_matches_jax(pair):
    """``render_image_v3(fast=True)`` with the diffuse tap at ERT 0.95 under
    autograd (the forward and the backward kernels' bf16 instances, the
    bf16 copy made inside the autograd function): the image, the loss and
    both gradients."""
    (js, jv, jt), (ts, tv, tt) = pair
    img, loss, dd, dt = _jax_image_loss_grads(
        jdiff_v3.render_image_v3, js, jv, jt, fast=True, **DIFFUSE)
    got = tdiff_v3.render_image_v3(ts, tv, fast=True, **DIFFUSE)
    got_loss = torch.mean((got - tt) ** 2)
    gd, gt = torch.autograd.grad(got_loss, [ts.density, ts.tf_base])
    _close(got.detach(), img, ATOL_IMG, "image")
    assert got_loss.item() == pytest.approx(loss, rel=RTOL_LOSS)
    assert gd.dtype == torch.float32
    _close(gd, dd, ATOL_GRAD, "d_density")
    _close(gt, dt, ATOL_GRAD, "d_tf_base")


@pytest.mark.parametrize("mode", ["unshaded", "esl phong"])
def test_onepass_fast_matches_jax(pair, mode):
    """The one-launch step (``l2_loss_grads_v3_onepass(fast=True)``),
    unshaded, and with ESL (the grid from the f32 density) and phong
    together (one interpret call for both modes)."""
    (js, jv, jt), (ts, tv, tt) = pair
    kw = {"unshaded": {},
          "esl phong": dict(esl=True, phong=True, light_kd=0.6)}[mode]
    want_loss, want_g = jdiff_v3.l2_loss_grads_v3_onepass(js, jv, jt,
                                                          fast=True, **kw)
    loss, g = tdiff_v3.l2_loss_grads_v3_onepass(ts, tv, tt, fast=True, **kw)
    assert loss.item() == pytest.approx(float(want_loss), rel=RTOL_LOSS)
    _close(g["density"], want_g.density, ATOL_GRAD, "d_density")
    _close(g["tf_base"], want_g.tf_base, ATOL_GRAD, "d_tf_base")


@pytest.mark.parametrize("kd", [0.0, 0.6], ids=["unshaded", "diffuse"])
def test_rung5_fast_matches_jax(kd):
    """Rung 5's ``render_float(fast=True)``: the uint8 volume to an f32
    density to its bf16 copy, as ``volrt``'s ``fwd_v3.py:56`` and
    ``_phase_volumes`` make it, at ERT 0.95. Unshaded, a pixel where a
    weight's bf16 rounding flips is held to ``ATOL_FLIP`` (module
    docstring)."""
    jrc, trc = _rcs((30.0, 20.0, 0.0), kd, 0.95)
    want, _ = jfwd_v3.render_float(jrc, fast=True)
    got, ovf = fwd_v3.render_float(trc, fast=True)
    assert ovf == 0.0 and got[..., 3].max() > 0.5
    if kd:
        _close(got, want, ATOL_RUNG5_DIFFUSE, "image")
        return
    _close(got, want, ATOL_FLIP, "image")
    off = np.abs(got.numpy() - np.asarray(want)).max(-1) > ATOL_IMG
    assert off.sum() <= FLIPPED_PIXELS, np.argwhere(off)


def test_render_slab_v3_fast_matches_jax():
    """``render_slab_v3(fast=True)`` on slab 1 of 2 (rows 8-15 with a halo
    row each side), seeded, ERT 0.6: the slab's z coordinate clipped to its
    rows after the whole volume's clip, as ``volrt``'s ``_geometry``
    does."""
    vol = synthetic_volume(SLAB_N)
    tf = np.asarray(jdefault_tf(), np.float32)
    jv, tv = _views()
    acc0 = _seed(256).reshape(16, 16)
    scene = trender.scene_from_volume(vol, tf, SLAB_STEP, device=CPU)
    density = scene.density.detach()
    premult = premultiply(scene.tf_base.detach())
    want, _ = jrender_slab(
        jvs.shard_slabs(jnp.asarray(density.numpy()), 2, 1)[1],
        jnp.asarray(premult.numpy()), SLAB_STEP, jv, 8, SLAB_N, 0.6,
        acc0=jnp.asarray(acc0), fast=True)
    slab = tvs.shard_slabs(density, 2, 1)[1].contiguous()
    got, _ = tdiff_v3.render_slab_v3(
        slab, premult, SLAB_STEP, tv, 8, SLAB_N, 0.6,
        acc0=torch.from_numpy(acc0), fast=True)
    _close(got, want, ATOL_IMG, "slab image")


def test_fast_density_gradient_is_not_rounded(pair):
    """Under ``fast`` the density's gradient is the plain f32 scatter's
    (``march_bwd_plain`` on the bf16 copy), handed to the f32 leaf as it
    is: it keeps bits that a bf16 rounding would drop, through
    ``MarchFunction`` (the autograd engine casts a gradient to its
    input's type, so the copy is made inside the function) and through
    the one-launch step alike."""
    _, (ts, tv, tt) = pair
    img = tdiff_v3.render_image_v3(ts, tv, fast=True)
    loss = torch.mean((img - tt) ** 2)
    (gd,) = torch.autograd.grad(loss, [ts.density])
    with torch.no_grad():
        args, kw = fwd_v3.ray_args(
            tv, ts.density.detach().to(torch.bfloat16), ts.premult_tf(),
            ts.ray_step, 0.95, 0.0)
        out = march.march_fwd_plain(*args, **kw)
        g = ((out - tt.reshape(-1, 4)) * (2.0 / tt.numel())).contiguous()
        want = march.march_bwd_plain(*args, out, g, **kw)[0]
    assert gd.dtype == want.dtype == torch.float32
    torch.testing.assert_close(gd, want, atol=1e-12, rtol=1e-6)
    _, one = tdiff_v3.l2_loss_grads_v3_onepass(ts, tv, tt, fast=True)
    torch.testing.assert_close(one["density"], want, atol=1e-12, rtol=1e-6)
    lost = (gd - sampling.round_bf16(gd)).abs().max().item()
    assert lost > 1e-3 * gd.abs().max().item(), lost


def test_fused_routes_take_fast():
    """``render_image_fused(fast=True)`` is the v3 kernels' fast mode on
    ``blocked=None``; the round-1 routes keep refusing it (``volrt``'s is
    a matrix-unit precision there), naming ROADMAP."""
    _, (scene, view, target) = _pair(dims=(8, 8))
    img = tfused.render_image_fused(scene, view, fast=True)
    want = tdiff_v3.render_image_v3(scene, view, fast=True)
    torch.testing.assert_close(img, want, atol=0, rtol=0)
    for blocked in (False, True):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tfused.render_image_fused(scene, view, blocked=blocked,
                                      fast=True)


def test_variant_names_read_the_voxel_type():
    """``bench/step_ab.py``'s reader of the kernels' names: the ``Voxel``
    argument (``march_common.cuh``) reads "bf16" for the fast instances
    and is left out for f32, so an f32 variant keeps its name and is
    compared with a tree from before the mode."""
    fwd = ("_ZN12_GLOBAL__N_116march_fwd_kernelILN5volrt5ShadeE0ELNS1_3EslE"
           "{}ELNS1_4SlabE0ELNS1_5VoxelE{}ELb1EEEvNS1_9MarchArgsEPfNS1_7"
           "EslArgsENS1_8SlabArgsE")
    assert variant_name(fwd.format(0, 0)) == "march_fwd_kernel<0,1>"
    assert variant_name(fwd.format(1, 1)) == "march_fwd_kernel<0,esl,bf16,1>"
    l2 = ("_ZN12_GLOBAL__N_114l2_step_kernelILN5volrt5ShadeE2ELNS1_3EslE0E"
          "LNS1_5VoxelE1ELb1ELb1ELb0EEEvNS1_9MarchArgsEPKfPfNS1_8GradArgsE"
          "NS1_7EslArgsE")
    assert variant_name(l2) == "l2_step_kernel<2,bf16,1,1,0>"


def test_fast_flags_and_precision():
    """The bench's ``fast`` keeps f32 as its default (the result's
    ``precision``, read on the card by ``chip_smoke.py`` phase 22);
    ``--fast`` reaches the headline and ``cli bench``, which time a card;
    rung 2-4 frames have no fast mode."""
    for fn in (harness.bench_fwd_step, harness.bench_diff_step,
               harness.run_diff_suite):
        assert inspect.signature(fn).parameters["fast"].default is False
    with pytest.raises(ValueError, match="fast"):
        harness.bench_fwd_step(8, 16, device="cuda", renderer=3, fast=True)
    with pytest.raises(ValueError):
        headline.main(["--fast", "--device", "cpu", "--synthetic", "8"])
    args = cli.parser().parse_args(["bench", "--diff", "--fast"])
    assert args.fast and args.diff
