"""The port's ``dist/`` (process group, ray-row data parallelism, Z-slab
volume sharding, ``fit(mesh=, volume_sharded=)``, ``cli fit --dist``,
``graft.dryrun_multichip``) against ``volrt``'s, on the CPU.

One ``gloo`` world of four CPU ranks (``tests/torch_dist_world.py``, which
imports no JAX) runs every check of the port once, a two-rank group of it
too, and writes what it found to files; each case here reads its file. The
world runs while this process computes ``volrt``'s references, on the
conftest's eight virtual CPU devices and ``volrt``'s XLA backend (its
Pallas slab path, in interpret mode, is ``tests/test_torch_slab.py``'s),
and for the fast mode (``volrt``'s fused fit and one-launch step) its
Pallas kernels in interpret mode.

Tolerances. Images: 1e-5 against ``volrt``: XLA's CPU code rounds the
trilinear lerps otherwise than torch, which parts the port's oracle from
``volrt``'s unsharded render by 8.2e-6 on this pose already. Gradients:
5e-6 (``tests/test_torch_diff.py``'s class for the oracle against
``volrt``; the largest entries are about 1e-2, and on this pose the
two-rank density gradient parts from ``volrt``'s by 8.5e-8). The port's
sharded step against its own single-rank step: the same operations summed
in another order, 1e-6 of the largest entry.

The boundary pose (``volrt``'s reference fault, ``ROADMAP.md`` queue 3): a
uniform volume of value 40, ERT off, orthographic along z, where lattice
samples lie on every slab plane. ``volrt``'s sharded render takes those
samples twice (an alpha excess of 0.0091 over two slabs and 0.0233 over
four, measured with ``volrt``); the port marches each once and equals
``volrt``'s unsharded render.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tests import torch_dist_world as world_mod
from tests.conftest import synthetic_volume
from volrt.core.tf import default_transfer_fn as jdefault_tf
from volrt.core.view import Camera as JCamera
from volrt.diff import render as jrender
from volrt.dist import volume_sharded as jvs
from volrt.dist.mesh import make_mesh as jmake_mesh
from volrt.renderers.pallas import diff_v3 as jdiff_v3
from volrt.train.fit import fit as jfit
from volrt_torch.core.types import Volume, make_raycaster
from volrt_torch.diff import render as trender
from volrt_torch.dist import mesh as mesh_mod
from volrt_torch.dist import volume_sharded as vs
from volrt_torch.dist.render import render_float_sharded
from volrt_torch.renderers import diff_v3, get_renderer

CPU = "cpu"
N = 16
ATOL_IMG = 1e-5
ATOL_GRAD = 5e-6
RTOL_SELF = 1e-6
# The fast step's TF gradient against volrt's: the two packages set up the
# rays in other operations, and a position that moves by an ulp can carry
# a (z, y) weight product across a bf16 rounding midpoint, which moves that
# sample by 2^-9 of a tap and its TF bin weights by 128 times as much.
# Measured: 5.1e-6 (TF entry 4, alpha; the loss equal to the bit, the
# density gradient 1.3e-8); the port's own fast d_tf moves by 4.4e-6 and
# 8.5e-6 when the pose turns by +-1e-5 degrees (its f32 d_tf by 2.7e-7).
ATOL_FAST_DTF = 1e-5
# The sharded cases whose gradients are held to volrt's (the first of
# each rank count; the port's other backend shares the reference).
GRAD_CASES = ("2-xla", "4-xla")
# The cases held to the port's own unsharded render: ESL (volrt has it on
# its Pallas backend only) and the diffuse tap (the slab mode's diffuse is
# held to volrt's in tests/test_torch_slab.py).
SELF_CASES = ("4-pallas-esl", "4-pallas-diffuse")
SHARDED = {c[0]: c for c in world_mod.SHARDED}
STEP_FAST = next(c for c in world_mod.STEPS if c[-1])


def _data() -> dict:
    tf = np.asarray(jdefault_tf(), np.float32)
    fit_init = np.full((N, N, N), 77, np.uint8)
    data = dict(synthetic=synthetic_volume(N),
                uniform=np.full((N, N, N), 40, np.uint8), fit=fit_init,
                tf=tf, steps=dict(synthetic=1.0 / N, uniform=0.125,
                                  fit=1.0 / N))
    return data


def _jview(pose, dims=world_mod.DIMS):
    cam = JCamera(dims=dims)
    cam.set_camera_position(pose)
    return cam.view()


def _jscene(data, which):
    return jrender.scene_from_volume(data[which], jnp.asarray(data["tf"]),
                                     data["steps"][which])


def _volrt_sharded(data) -> dict:
    """``volrt``'s sharded render (XLA backend) of each case's ranks,
    shading and pose, the gradients where the case needs them, and its
    unsharded render; one reference serves both of the port's backends."""
    refs = {}
    for name, n, backend, shading, pose, thr, esl, which in (
            world_mod.SHARDED):
        key = (n, shading, pose, thr, which)
        if name in SELF_CASES or key in refs:
            continue
        js, jv = _jscene(data, which), _jview(pose)
        mesh = jmake_mesh(jax.devices()[:n])

        def render(s):
            return jvs.render_volume_sharded(
                s, jv, mesh, ray_threshold=thr, backend="xla",
                shading=shading, light_kd=0.6)

        ref = {}
        if pose != world_mod.POSE:
            ref["whole"] = np.asarray(jrender.render_diff_image(js, jv, thr))
            if n == 2:
                refs[key] = ref  # volrt's split is shown on four slabs
                continue
        if name in GRAD_CASES:
            def loss(s):
                img = render(s)
                return jnp.mean(img ** 2), img

            (_, img), g = jax.value_and_grad(loss, has_aux=True)(js)
            ref.update(d_density=np.asarray(g.density),
                       d_tf=np.asarray(g.tf_base))
        else:
            img = render(js)
        ref["img"] = np.asarray(img)
        refs[key] = ref
    return refs


def _volrt_step(data) -> dict:
    """``volrt``'s XLA autodiff of the mean-square loss of the first step
    case, and its one-launch step in the fast mode (Pallas, interpret
    mode) for ``2-fast`` (the others are held to the port's single-rank
    step, which ``tests/test_torch_diff.py`` holds to ``volrt``)."""
    refs = {}
    for case in (world_mod.STEPS[0], STEP_FAST):
        name, _, dims, _, _, fast = case
        js, jv = _jscene(data, "synthetic"), _jview(world_mod.POSE, dims)
        target = jnp.asarray(world_mod.target_of(dims))
        if fast:
            value, g = jdiff_v3.l2_loss_grads_v3_onepass(js, jv, target,
                                                         fast=True)
        else:
            def loss(s):
                return jnp.mean(
                    (jrender.render_diff_image(s, jv, 0.95) - target) ** 2)

            value, g = jax.value_and_grad(loss)(js)
        refs[name] = dict(loss=float(value), d_density=np.asarray(g.density),
                          d_tf=np.asarray(g.tf_base))
    return refs


def _volrt_fit(data, fused=False) -> np.ndarray:
    """``volrt``'s data-parallel fit on a two-device mesh: its losses are
    its unsharded fit's, which every one of the port's oracle and
    volume-sharded mesh fits must give. ``fused=True``: its unsharded
    fused fit (the fast mode, Pallas in interpret mode), which the port's
    fused fit over a mesh must give."""
    target = world_mod.fit_target(data)
    mesh = dict(fused=True) if fused else dict(
        mesh=jmake_mesh(jax.devices()[:2]))
    _, losses = jfit(_jscene(data, "fit"),
                     [(_jview(world_mod.POSE), jnp.asarray(target))],
                     steps=world_mod.FIT_STEPS, lr=world_mod.FIT_LR, **mesh)
    return np.asarray(losses)


@pytest.fixture(scope="module")
def world():
    """The world's files and ``volrt``'s references: the four ranks run
    while the references are computed here."""
    data = _data()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            mesh_mod._rank_main,
            args=(world_mod.run, 4, "gloo", init, (data, tmp)), nprocs=4,
            join=False, start_method="spawn")
        refs = dict(sharded=_volrt_sharded(data), step=_volrt_step(data),
                    fit=_volrt_fit(data),
                    fit_fused=_volrt_fit(data, fused=True), data=data)
        while not ctx.join():
            pass
        found = {f[:-4]: dict(np.load(os.path.join(tmp, f)))
                 for f in os.listdir(tmp) if f.endswith(".npz")}
        yield found, refs, tmp


def _close(got, want, atol, what):
    assert np.abs(want).max() > 0, what
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


def _close_rel(got, want, rtol, what):
    top = np.abs(want).max()
    assert top > 0, what
    np.testing.assert_allclose(got, want, atol=rtol * top, rtol=0,
                               err_msg=what)


def test_world_ran_every_check(world):
    """The world reached its end: the dry run (``graft.dryrun_multichip``
    in the world's group) included."""
    found, _, _ = world
    assert "done" in found


def test_collectives(world):
    """``all_gather`` and ``all_reduce`` (sum, and max on int32) on every
    rank, and a group of two of the four ranks (``sub_mesh``)."""
    found, _, _ = world
    c = found["collectives"]
    assert int(c["size"]) == 4
    np.testing.assert_array_equal(
        c["every"], np.arange(4, dtype=np.float32)[:, None, None]
        * np.ones((1, 2, 3), np.float32))
    np.testing.assert_array_equal(c["total"], [10.0] * 3)
    np.testing.assert_array_equal(c["top"], [3, 0])
    np.testing.assert_array_equal(
        c["sub"], [[-1, -1], [0, 3], [1, 3], [-1, -1]])


@pytest.mark.parametrize("halo", [1, 3])
def test_slabs_from_host_and_from_neighbours(world, halo):
    """Each rank's slab copied from the host (``shard_slabs_to_devices``)
    and built from its own rows and its neighbours' edges
    (``refresh_halos``) both equal ``shard_slabs``' slab to the bit."""
    found, _, _ = world
    assert found[f"slabs-{halo}"]["ok"].all()


@pytest.mark.parametrize("case", [c[0] for c in world_mod.SHARDED])
def test_render_volume_sharded(world, case):
    """``render_volume_sharded`` on two and four ranks, both backends,
    against ``volrt``'s (XLA backend): the image within 1e-5, every rank's
    the same; the density gradient of each rank's own rows, laid end to
    end, and the TF gradient (the same on every rank) within 5e-6 (the
    first case of each rank count; the other backend's image is held to
    the same reference); nothing on rows a rank does not own. On the
    boundary pose the port equals ``volrt``'s unsharded render within 1e-5,
    on two slabs and four, while ``volrt``'s sharded render parts from it
    by more than 0.02 on four. ESL (the kernels' mode, which ``volrt`` has
    on its Pallas backend only) and the diffuse tap are held to the port's
    own unsharded render and its gradients within 1e-6."""
    found, refs, _ = world
    got = found["sharded-" + case]
    assert float(got["img_spread"]) == 0.0 and float(got["tf_spread"]) == 0.0
    assert float(got["leak"].max()) == 0.0
    assert got["img"][..., 3].max() > 0.3
    _, n, _, shading, pose, thr, esl, which = SHARDED[case]
    if case in SELF_CASES:
        data = refs["data"]
        scene = trender.scene_from_volume(data["synthetic"], data["tf"],
                                          1.0 / N, device=CPU)
        img = diff_v3.render_image_v3(
            scene, world_mod.view_of(world_mod.POSE), thr, esl=esl,
            shaded=shading == "diffuse", light_kd=0.6)
        (img ** 2).mean().backward()
        np.testing.assert_allclose(got["img"], img.detach().numpy(),
                                   atol=RTOL_SELF, rtol=0)
        _close_rel(got["d_density"], scene.density.grad.numpy(), RTOL_SELF,
                   "d_density")
        _close_rel(got["d_tf"], scene.tf_base.grad.numpy(), RTOL_SELF,
                   "d_tf")
        return
    want = refs["sharded"][(n, shading, pose, thr, which)]
    if case.startswith("boundary"):
        np.testing.assert_allclose(got["img"], want["whole"], atol=ATOL_IMG,
                                   rtol=0)
        if "img" in want:
            part = np.abs(want["img"] - want["whole"]).max()
            assert part > 0.02, part
        return
    np.testing.assert_allclose(got["img"], want["img"], atol=ATOL_IMG,
                               rtol=0)
    if "d_density" in want:
        _close(got["d_density"], want["d_density"], ATOL_GRAD, "d_density")
        _close(got["d_tf"], want["d_tf"], ATOL_GRAD, "d_tf")


@pytest.mark.parametrize("case", [f"{r}-{i}-{n}"
                                  for r, i, n, _ in world_mod.ROWS])
def test_render_float_sharded_equals_the_whole_frame(world, case):
    """``render_float_sharded`` on rungs 2-3 (``march_tri``), 4
    (``march_blocked``) and 5 (``march_fwd``), on two ranks and on four
    with uneven rows (24 x 18: bands of 5 rows, the last padded with dead
    ones): the frame equals the unsharded rung's to the bit on every rank,
    and the overflow count is 0."""
    found, _, _ = world
    got = found["rows-" + case]
    assert got["same"][:, 0].all() and not got["same"][:, 1].any()
    assert got["img"][..., 3].max() > 0.3


@pytest.mark.parametrize("case", [c[0] for c in world_mod.STEPS])
def test_l2_loss_grads_v3_sharded(world, case):
    """The row-split one-launch step against the port's single-rank step
    (1e-6), f32 and in the fast mode (``2-fast``, the default). The first
    case is also held to ``volrt``'s XLA autodiff of the same loss, and
    ``2-fast`` to ``volrt``'s one-launch step in the fast mode (Pallas in
    interpret mode): the loss rtol 1e-5, gradients within 5e-6, the fast
    step's TF gradient within 1e-5 (``ATOL_FAST_DTF``; ``volrt``'s own
    sharded step runs the same kernels on each row band)."""
    found, refs, _ = world
    got = found["step-" + case]
    assert float(got["loss"]) == pytest.approx(float(got["loss1"]),
                                               rel=RTOL_SELF)
    _close_rel(got["d_density"], got["d_density1"], RTOL_SELF, "d_density")
    _close_rel(got["d_tf"], got["d_tf1"], RTOL_SELF, "d_tf")
    if case not in refs["step"]:
        return
    want = refs["step"][case]
    assert float(got["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    _close(got["d_density"], want["d_density"], ATOL_GRAD, "d_density")
    _close(got["d_tf"], want["d_tf"],
           ATOL_FAST_DTF if case == STEP_FAST[0] else ATOL_GRAD, "d_tf")


@pytest.mark.parametrize("case", ["rays-2", "rays-4-fused", "volume-2",
                                  "volume-4"])
def test_fit_over_a_mesh(world, case):
    """Three steps of ``fit(mesh=)`` (the oracle's bands, then the
    one-launch step's) and ``fit(volume_sharded=True)`` against
    ``volrt``'s losses: its data-parallel fit on a two-device mesh for the
    oracle's bands, its unsharded fit for the volume-sharded fits
    (``volrt``'s runs its Pallas kernels); rtol 1e-4
    (``test_torch_fit.py``'s class). The one-launch step's bands train in
    the fast mode, as ``volrt``'s fused fit does, and are held to
    ``volrt``'s fused fit (unsharded, Pallas in interpret mode) and to
    the port's fused fit on one rank. Every rank ends with the same whole
    density, and the checkpoint (written by rank 0, the density gathered)
    loads."""
    from volrt_torch.train import checkpoint as ckpt

    found, refs, where = world
    got = found["fit-" + case]
    if case == "rays-4-fused":
        np.testing.assert_allclose(got["losses"], refs["fit_fused"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["losses"],
                                   found["fit-1-fused"]["losses"], rtol=1e-4)
    else:
        np.testing.assert_allclose(got["losses"], refs["fit"], rtol=1e-4)
    assert float(got["spread"]) == 0.0
    state = ckpt.load(os.path.join(where, f"fit-{case}.ckpt.npz"),
                      device=CPU)
    assert state.step == world_mod.FIT_STEPS
    np.testing.assert_array_equal(state.scene.density.detach().numpy(),
                                  got["density"])


@pytest.mark.parametrize("mode", ["rays", "volume"])
def test_cli_fit_dist(world, mode):
    """``cli fit --dist rays|volume`` in the world's group: every rank
    returns 0."""
    found, _, _ = world
    assert (found["cli-" + mode]["codes"] == 0).all()


def test_world_of_one_rank_is_the_unsharded_render():
    """A mesh of one rank needs no process group: the volume-sharded
    render (both backends) equals the unsharded one, and the row-split
    frame the whole frame to the bit."""
    data = _data()
    one = mesh_mod.make_mesh(CPU)
    assert (one.rank, one.size, one.group) == (0, 1, None)
    scene = trender.scene_from_volume(data["synthetic"], data["tf"],
                                      1.0 / N, device=CPU)
    view = world_mod.view_of(world_mod.POSE)
    with torch.no_grad():
        whole = diff_v3.render_image_v3(scene, view, 0.6)
        for backend in vs.BACKENDS:
            img = vs.render_volume_sharded(scene, view, one,
                                           ray_threshold=0.6,
                                           backend=backend)
            np.testing.assert_allclose(img.numpy(), whole.numpy(),
                                       atol=RTOL_SELF, rtol=0)
        rc = make_raycaster(Volume.from_numpy(data["synthetic"], CPU), view,
                            interpolation="trilinear")
        img, _ = render_float_sharded(rc, one, renderer="pallas-blocked")
        assert torch.equal(img, get_renderer(4).render_float(rc)[0])


def test_refusals():
    """What the sharded paths refuse, as ``volrt`` does: phong on the
    kernels' backend, ESL on the torch one, an unknown backend or
    renderer, a depth that does not split, a halo deeper than a slab."""
    data = _data()
    one = mesh_mod.make_mesh(CPU)
    scene = trender.scene_from_volume(data["synthetic"], data["tf"],
                                      1.0 / N, device=CPU)
    view = world_mod.view_of(world_mod.POSE)
    with pytest.raises(NotImplementedError, match="phong"):
        vs.render_volume_sharded(scene, view, one, backend="pallas",
                                 shading="phong")
    with pytest.raises(NotImplementedError, match="esl"):
        vs.render_volume_sharded(scene, view, one, backend="xla", esl=True)
    with pytest.raises(ValueError, match="backend"):
        vs.render_volume_sharded(scene, view, one, backend="tpu")
    with pytest.raises(ValueError, match="divisible"):
        vs.shard_slabs(scene.density, 3)
    two = mesh_mod.Mesh(None, 0, 2, torch.device(CPU))
    with pytest.raises(ValueError, match="halo"):
        vs.refresh_halos(scene.density[:1], mesh_mod.Mesh(
            None, 0, 16, torch.device(CPU)), 2, N)
    rc = make_raycaster(Volume.from_numpy(data["synthetic"], CPU), view)
    with pytest.raises(ValueError, match="renderer"):
        render_float_sharded(rc, two, renderer="pallas-golden")
