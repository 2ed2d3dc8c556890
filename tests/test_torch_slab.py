"""The slab mode of kernel rows 1-2 (``march_fwd``, ``march_bwd``: ``z_off``,
the ``acc0`` seed and its cotangent ``dacc0``) and ``render_slab_v3``
against ``volrt``'s, on the CPU, where the wrappers run their plain
versions.

``volrt``'s Pallas slab kernels run in interpret mode in one call (the
seeded forward with its gradient with respect to the density, the TF and
the seed), held to the repo's v3 image tolerance, 2e-4, and the
gradients within 2e-5 of their
largest entry (a cotangent of order 1 on every pixel: the TF's entries sum
256 rays' terms, about 14 at most, which the two packages round apart by
1.2e-4). Its XLA slab march (``_slab_march``, the ``"xla"`` backend),
with the diffuse tap, is held to the port's torch slab march within 1e-5:
XLA's CPU code rounds the trilinear lerps otherwise than torch, which
parts the two packages' unsharded oracles by 8.2e-6 on these poses
already. Within the port, the plain march of each slab, seeded in turn,
composes to the unsharded march within 1e-6, and the slab backward's
three outputs equal autograd through the plain forward within 1e-6 of
the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import synthetic_volume
from volrt.core.tf import default_transfer_fn as jdefault_tf
from volrt.core.view import Camera as JCamera
from volrt.diff import render as jrender
from volrt.dist import volume_sharded as jvs
from volrt.renderers.pallas.diff_v3 import render_slab_v3 as jrender_slab
from volrt_torch.bench.step_ab import variant_name
from volrt_torch.core.tf import premultiply
from volrt_torch.core.view import Camera
from volrt_torch.diff import render as trender
from volrt_torch.dist import volume_sharded as tvs
from volrt_torch.renderers import diff_v3, fwd_v3
from volrt_torch.renderers.cuda.march import (
    march_bwd, march_fwd, march_fwd_plain)

CPU = "cpu"
N = 16
STEP = 1.0 / N
POSE = (25.0, 10.0, 0.0)
KD = 0.6
ATOL_V3 = 2e-4
RTOL_GRAD = 2e-5
ATOL_XLA = 1e-5


def _views(pose=POSE, dims=(16, 16), persp=False):
    cams = [JCamera(dims=dims, perspective=persp),
            Camera(dims=dims, perspective=persp)]
    for cam in cams:
        if persp:
            cam.toggle_perspective(update_mode=True)
        cam.set_camera_position(pose)
    return cams[0].view(), cams[1].view(CPU)


def _seed(n_rays: int) -> np.ndarray:
    return (np.random.default_rng(3).random(n_rays) * 0.7).astype(
        np.float32)


@pytest.fixture(scope="module")
def scenes():
    vol = synthetic_volume(N)
    tf = np.asarray(jdefault_tf(), np.float32)
    js = jrender.scene_from_volume(vol, jnp.asarray(tf), STEP)
    ts = trender.scene_from_volume(vol, tf, STEP, device=CPU)
    return js, ts


@pytest.fixture(scope="module")
def pallas(scenes):
    """``volrt``'s interpret-mode calls: slab 1 of 2 of the volume (rows
    8-15), seeded, on the rotated pose."""
    js, _ = scenes
    jv, _ = _views()
    premult = jnp.concatenate(
        [js.tf_base[:, :3] * js.tf_base[:, 3:4], js.tf_base[:, 3:4]], -1)
    acc0 = jnp.asarray(_seed(256).reshape(16, 16))
    out = {}
    slab = jvs.shard_slabs(js.density, 2, 1)[1]
    g = np.random.default_rng(4).standard_normal((16, 16, 4)).astype(
        np.float32)

    def loss(d, tf, a0):
        img = jrender_slab(d, tf, STEP, jv, 8, N, 0.6, acc0=a0)[0]
        return jnp.sum(img * g), img

    # The seeded forward and its gradient in one call.
    (_, img), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(slab, premult, acc0)
    out["fwd"] = np.asarray(img)
    out["grads"] = [np.asarray(x) for x in grads]
    out["g"] = g
    return out


def _slab_inputs(ts, halo=1, k=1, n=2):
    slab = tvs.shard_slabs(ts.density.detach(), n, halo)[k].contiguous()
    return slab, premultiply(ts.tf_base.detach())


def test_seeded_slab_forward_matches_volrt_pallas(scenes, pallas):
    """``render_slab_v3`` (the plain slab forward here) against ``volrt``'s
    seeded slab kernel, ERT 0.6."""
    _, ts = scenes
    _, tv = _views()
    slab, premult = _slab_inputs(ts)
    img, ovf = diff_v3.render_slab_v3(
        slab, premult, STEP, tv, 8, N, 0.6,
        acc0=torch.from_numpy(_seed(256).reshape(16, 16)))
    assert ovf == 0.0 and img[..., 3].max() > 0.5
    np.testing.assert_allclose(img.detach().numpy(), pallas["fwd"],
                               atol=ATOL_V3, rtol=0)


def test_slab_gradients_match_volrt_pallas(scenes, pallas):
    """The slab backward (``MarchFunction`` with ``acc0``: ``march_bwd``'s
    slab mode, plain here) against ``jax.grad`` of ``volrt``'s slab render
    with respect to the slab's density, the premultiplied TF and the
    seed."""
    _, ts = scenes
    _, tv = _views()
    slab, premult = _slab_inputs(ts)
    slab.requires_grad_(True)
    premult.requires_grad_(True)
    acc0 = torch.from_numpy(_seed(256).reshape(16, 16)).requires_grad_(True)
    img, _ = diff_v3.render_slab_v3(slab, premult, STEP, tv, 8, N, 0.6,
                                    acc0=acc0)
    (img * torch.from_numpy(pallas["g"])).sum().backward()
    for got, want, what in zip((slab.grad, premult.grad, acc0.grad),
                               pallas["grads"], ("density", "tf", "acc0")):
        top = np.abs(want).max()
        assert top > 1e-3, what
        np.testing.assert_allclose(got.numpy(), want, atol=RTOL_GRAD * top,
                                   rtol=0, err_msg=what)


@pytest.mark.parametrize("shading", ["diffuse", "alpha"])
def test_torch_slab_march_matches_volrt_xla(scenes, shading):
    """The ``"xla"`` backend's slab march (``_slab_march``, torch ops)
    against ``volrt``'s, seeded, on slab 1 of 2 with the diffuse tap and
    ``shading_halo``'s halo, and the prepass (``alpha_only``, ERT off); the
    kernels' plain slab march is held to it below, diffuse too. Unshaded,
    ``volrt``'s Pallas slab kernel is the reference above; phong is held
    to ``volrt``'s through the sharded render
    (``tests/test_torch_dist.py``, ``4-xla-phong``)."""
    js, ts = scenes
    jv, tv = _views()
    alpha = shading == "alpha"
    shade = None if alpha else shading
    halo = tvs.shading_halo(N, shade)
    thr = 2.0 if alpha else 0.6
    seed = _seed(256).reshape(16, 16)
    want = jvs._slab_march(
        jvs.shard_slabs(js.density, 2, halo)[1], 8, N, js.tf_base, STEP, jv,
        thr, acc0_alpha=None if alpha else jnp.asarray(seed),
        alpha_only=alpha, halo=halo, shading=shade, light_kd=KD)
    got = tvs._slab_march(
        tvs.shard_slabs(ts.density.detach(), 2, halo)[1], 8, N,
        ts.tf_base.detach(), STEP, tv, thr,
        acc0_alpha=None if alpha else torch.from_numpy(seed),
        alpha_only=alpha, halo=halo, shading=shade, light_kd=KD)
    assert got[..., 3].max() > 0.5
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL_XLA, rtol=0)


@pytest.mark.parametrize("kd", [0.0, KD])
def test_plain_slab_march_is_the_torch_slab_march(scenes, kd):
    """Within the port the kernels' plain slab march (``render_slab_v3``)
    and the torch slab march take the same samples in the same
    operations, seeded, unshaded and with the diffuse tap (whose light
    direction the two normalise in two ways: 1e-6)."""
    _, ts = scenes
    _, tv = _views()
    halo = tvs.shading_halo(N, "diffuse" if kd else None)
    slab, premult = _slab_inputs(ts, halo)
    seed = torch.from_numpy(_seed(256).reshape(16, 16))
    img, _ = diff_v3.render_slab_v3(slab, premult, STEP, tv, 8, N, 0.6,
                                    acc0=seed, halo=halo, shaded=kd > 0,
                                    light_kd=kd)
    ref = tvs._slab_march(slab, 8, N, ts.tf_base.detach(), STEP, tv, 0.6,
                          acc0_alpha=seed, halo=halo,
                          shading="diffuse" if kd else None, light_kd=kd)
    np.testing.assert_allclose(img.detach().numpy(), ref.detach().numpy(),
                               atol=1e-6, rtol=0)


def _lattice_counts(o, d, k0, kend, alive, step, n_max):
    """Samples each ray takes on ``k0 + i*step <= kend`` (the kernels'
    test, in their rounding), 0 where not alive."""
    i = torch.arange(n_max, dtype=torch.float32)
    k = k0[:, None] + i[None, :] * step
    return ((k <= kend[:, None]) & alive[:, None]).sum(-1)


@pytest.mark.parametrize("case", ["boundary", "rotated", "perspective"])
@pytest.mark.parametrize("n", [2, 4])
def test_every_lattice_sample_in_exactly_one_slab(case, n):
    """``slab_rays``' partition: every ray's lattice samples of the whole
    march, counted over the slabs, are the unsharded march's samples, each
    once, and the first slab in a ray's path starts where it does, also
    on the axis-aligned pose whose samples lie on every slab plane (where
    ``volrt``'s split takes them twice)."""
    pose, persp, step = {"boundary": ((0.0, 0.0, 0.0), False, 0.125),
                         "rotated": (POSE, False, STEP),
                         "perspective": ((30.0, 20.0, 0.0), True, STEP)}[case]
    _, tv = _views(pose, persp=persp)
    args, _ = fwd_v3.ray_args(tv, torch.zeros(N, N, N), torch.zeros(128, 4),
                              step, 2.0, 0.0)
    o, d, knear, kfar, alive = args[:5]
    n_max = 2 * int(np.ceil(2 * np.sqrt(3) / step)) + 4
    whole = _lattice_counts(o, d, knear, kfar, alive, step, n_max)
    sd = N // n
    total = torch.zeros_like(whole)
    for k in range(n):
        so, sdir, k0, kend, sa = diff_v3.slab_rays(tv, k * sd, sd, N, step,
                                                   torch.device(CPU))
        assert torch.equal(so, o) and torch.equal(sdir, d)
        total += _lattice_counts(so, sdir, k0, kend, sa, step, n_max)
        # Each slab starts on the whole march's lattice.
        j = torch.round((k0 - knear) / step)
        assert torch.allclose(k0[sa], (knear + j * step)[sa])
    assert whole.sum() > 0
    assert torch.equal(total, whole)


@pytest.mark.parametrize("kd,thr", [(0.0, 2.0), (KD, 2.0), (0.0, 0.6)])
def test_seeded_slabs_compose_to_the_whole_march(scenes, kd, thr):
    """The plain slab forward on each of four slabs in march order, each
    seeded with the opacity its predecessors composed, sums (segments less
    their seeds) to the unsharded plain march: ERT off, unshaded and
    diffuse, within 1e-6; with ERT the segments stop where the whole
    march stops."""
    _, ts = scenes
    _, tv = _views()
    premult = premultiply(ts.tf_base.detach())
    args, kw = fwd_v3.ray_args(tv, ts.density.detach(), premult, STEP, thr,
                               kd)
    whole = march_fwd(*args, **kw)
    halo = tvs.shading_halo(N, "diffuse" if kd else None)
    slabs = tvs.shard_slabs(ts.density.detach(), 4, halo)
    front_to_back = bool(tv.direction[2] >= 0)
    acc = torch.zeros_like(whole)
    seed = torch.zeros(whole.shape[0])
    for k in (range(4) if front_to_back else range(3, -1, -1)):
        img, _ = diff_v3.render_slab_v3(
            slabs[k].contiguous(), premult, STEP, tv, k * 4, N, thr,
            acc0=seed.reshape(16, 16), halo=halo, shaded=kd > 0,
            light_kd=kd)
        img = img.detach().reshape(-1, 4)
        acc += img - torch.cat([torch.zeros(seed.shape[0], 3),
                                seed[:, None]], -1)
        seed = img[:, 3].clone()
    assert whole[:, 3].max() > 0.5
    np.testing.assert_allclose(acc.numpy(), whole.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("kd", [0.0, KD])
def test_slab_backward_is_autograd_of_the_plain_forward(scenes, kd):
    """``march_bwd``'s slab mode (plain) against autograd through
    ``march_fwd_plain`` in slab mode: ``d_density``, ``d_premult_tf`` and
    ``dacc0``, ERT 0.6, every seed level (0 to 0.98, some over the
    threshold)."""
    _, ts = scenes
    _, tv = _views()
    halo = tvs.shading_halo(N, "diffuse" if kd else None)
    slab, premult = _slab_inputs(ts, halo)
    o, d, k0, kend, alive = diff_v3.slab_rays(tv, 8, 8, N, STEP,
                                              torch.device(CPU))
    seed = torch.from_numpy(
        np.random.default_rng(5).random(256).astype(np.float32) * 0.98)
    scal = torch.tensor([0.6, kd, *tv.light_pos.tolist(), 8.0 - halo, 0.0,
                         0.0], dtype=torch.float32)
    kw = dict(ray_step=STEP, shade=kd > 0, no_ert=False, width=16)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (256, 4)).astype(np.float32))
    leaves = [slab.clone().requires_grad_(True),
              premult.clone().requires_grad_(True),
              seed.clone().requires_grad_(True)]
    out = march_fwd_plain(o, d, k0, kend, alive, leaves[0], leaves[1], scal,
                          slab=(leaves[2], N), **kw)
    (out * g).sum().backward()
    got = march_bwd(o, d, k0, kend, alive, slab, premult, scal,
                    out.detach(), g, slab=(seed, N), **kw)
    for a, leaf, what in zip(got, leaves, ("density", "tf", "acc0")):
        want = leaf.grad
        assert want.abs().max() > 1e-3, what
        torch.testing.assert_close(a, want, rtol=0,
                                   atol=1e-6 * want.abs().max().item(),
                                   msg=what)
    # A ray whose seed is over the threshold takes nothing: dacc0 = g.a.
    over = alive & (seed > 0.6)
    assert over.any()
    assert torch.equal(got[2][over], g[over, 3])


def test_slab_mode_refusals(scenes):
    """The slab mode has no phong (``volrt`` refuses it too), takes a seed
    of one value a ray and an integer depth."""
    _, ts = scenes
    _, tv = _views()
    slab, premult = _slab_inputs(ts)
    o, d, k0, kend, alive = diff_v3.slab_rays(tv, 8, 8, N, STEP,
                                              torch.device(CPU))
    scal = torch.zeros(8)
    kw = dict(ray_step=STEP, shade=False, no_ert=True, width=16)
    seed = torch.zeros(256)
    with pytest.raises(NotImplementedError, match="phong"):
        march_fwd(o, d, k0, kend, alive, slab, premult, scal,
                  slab=(seed, N), phong=True, **kw)
    with pytest.raises(ValueError, match="acc0"):
        march_fwd(o, d, k0, kend, alive, slab, premult, scal,
                  slab=(torch.zeros(255), N), **kw)
    with pytest.raises(ValueError, match="full_d"):
        march_fwd(o, d, k0, kend, alive, slab, premult, scal,
                  slab=(seed, 16.0), **kw)
    # fast (bf16 storage) is a mode of the slab kernels too: it moves the
    # image from the f32 slab's by up to 0.019 here (measured), and the
    # slab's gradient stays f32; test_torch_fast.py holds it to volrt's.
    leaf = slab.clone().requires_grad_(True)
    fast = diff_v3.render_slab_v3(leaf, premult, STEP, tv, 8, N, fast=True)[0]
    f32 = diff_v3.render_slab_v3(slab, premult, STEP, tv, 8, N)[0]
    assert 0.0 < (fast - f32).abs().max().item() <= 0.05
    fast.sum().backward()
    assert leaf.grad.dtype == torch.float32 and leaf.grad.abs().max() > 0


def test_variant_names_read_the_slab_mode():
    """``bench/step_ab.py``'s reader of the kernels' names: the ``Slab``
    argument (``march_common.cuh``) reads "slab" when on and is left out
    when off, so a slab-off variant keeps its name and is compared with a
    tree from before the mode."""
    fwd = ("_ZN12_GLOBAL__N_116march_fwd_kernelILN5volrt5ShadeE{}ELNS1_3EslE"
           "{}ELNS1_4SlabE{}ELb1EEEvNS1_9MarchArgsEPfNS1_7EslArgsENS1_8SlabArgsE")
    assert variant_name(fwd.format(0, 0, 0)) == "march_fwd_kernel<0,1>"
    assert variant_name(fwd.format(1, 1, 1)) == (
        "march_fwd_kernel<1,esl,slab,1>")
    bwd = ("_ZN12_GLOBAL__N_116march_bwd_kernelILN5volrt5ShadeE0ELNS1_3EslE0E"
           "LNS1_4SlabE1ELb0ELb1ELb0EEEvNS1_9MarchArgsEPKfS5_NS1_8GradArgsE"
           "NS1_7EslArgsENS1_8SlabArgsE")
    assert variant_name(bwd) == "march_bwd_kernel<0,slab,0,1,0>"
