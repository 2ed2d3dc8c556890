"""The port's trainer, step benchmark and CLI against ``volrt``.

The same initial scene, view and target (rendered once by ``volrt`` from
the ground-truth scene) go to ``volrt.train.fit.fit`` and to the port's
``fit`` on the CPU, through numpy.

Tolerances of the trajectories. Adam divides each gradient by the root of
its running square, so an entry whose gradient is rounding noise moves by a
full ``lr`` in whichever direction the noise points, and the two packages
round differently. The tests therefore start from a scene whose gradients
are real on both leaves (a constant density under a non-flat TF), take 5
steps at ``lr = 0.02``, hold the losses to rtol 1e-4 (measured: 5e-6), and
hold the trained parameters to 1e-3 only on entries whose first gradient
exceeds 1e-7 in magnitude. The fused routes of both packages train in
``volrt``'s fast mode (the volume stored as bf16), so the port's fused fit
is held to ``volrt``'s fused fit (measured: losses within 4e-6, 8e-7
under the diffuse tap), at the same tolerances.
"""
import inspect
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_core import one_torch_thread  # noqa: F401
from tests.conftest import ASSET_PATH
from tests.test_torch_diff import CPU, STEP, _pair
from volrt.diff import render as jrender
from volrt.train.fit import fit as jfit
from volrt_torch import cli
from volrt_torch.bench import __main__ as headline
from volrt_torch.bench import harness
from volrt_torch.diff import render as trender
from volrt_torch.renderers import diff_v3 as tdiff_v3
from volrt_torch.train import fit as tfit_mod

LR = 0.02
STEPS = 5
GRAD_FLOOR = 1e-7


@pytest.fixture(scope="module")
def problem():
    """Both packages' view, the target image and the ground truth."""
    (jscene, jview, _), (_, tview, _) = _pair()
    target = np.array(jrender.render_diff_image(jscene, jview))
    return dict(jview=jview, tview=tview, target=target,
                density=np.asarray(jscene.density),
                tf_base=np.asarray(jscene.tf_base))


def _init(problem, train):
    """Density fits start from a constant, TF fits from a flattened copy
    of the true TF (not flat: see the module docstring)."""
    density = (problem["density"] if train == "tf"
               else np.full(problem["density"].shape, 0.3, np.float32))
    tf_base = ((0.5 * problem["tf_base"] + 0.25).astype(np.float32)
               if train in ("tf", "both") else problem["tf_base"])
    return density, tf_base


def _flags(train):
    return dict(train_density=train in ("density", "both"),
                train_tf=train in ("tf", "both"))


def _jax_fit(problem, train, **kw):
    density, tf_base = _init(problem, train)
    scene = jrender.DiffScene(density=jnp.asarray(density),
                              tf_base=jnp.asarray(tf_base), ray_step=STEP)
    scene, losses = jfit(
        scene, [(problem["jview"], jnp.asarray(problem["target"]))],
        steps=STEPS, lr=LR, **_flags(train), **kw)
    return np.asarray(scene.density), np.asarray(scene.tf_base), losses


def _torch_fit(problem, train, **kw):
    density, tf_base = _init(problem, train)
    scene = trender.scene_from_arrays(density, tf_base, STEP, device=CPU)
    target = torch.from_numpy(problem["target"])
    _, first = tdiff_v3.l2_loss_grads_v3_onepass(
        scene, problem["tview"], target, fast=kw.get("fused", False),
        **kw.get("first_kw", {}))
    kw.pop("first_kw", None)
    out, losses = tfit_mod.fit(scene, [(problem["tview"], target)],
                               steps=STEPS, lr=LR, **_flags(train), **kw)
    assert out is scene
    assert scene.density.requires_grad and scene.tf_base.requires_grad
    return (scene.density.detach().numpy(), scene.tf_base.detach().numpy(),
            losses, first)


@pytest.fixture(scope="module")
def jax_runs(problem):
    """``volrt``'s fits, one per ``train`` mode and route: its XLA f32 fit
    (``fused=False``) and its fused fit (``fused=True``: its kernels in
    their fast mode), each computed when a test first asks for it."""
    runs = {}

    def get(train, fused):
        if (train, fused) not in runs:
            runs[train, fused] = _jax_fit(problem, train, fused=fused)
        return runs[train, fused]
    return get


@pytest.mark.parametrize("fused", [False, True], ids=["autograd", "fused"])
@pytest.mark.parametrize("train", ["density", "tf", "both"])
def test_fit_matches_jax_fit(problem, jax_runs, train, fused):
    """(e) Five steps of ``fit`` against ``volrt``'s: the autograd route
    against its XLA f32 fit, the fused route (the fast mode) against its
    fused fit."""
    want_d, want_t, want_losses = jax_runs(train, fused)
    got_d, got_t, losses, first = _torch_fit(problem, train, fused=fused)
    assert len(losses) == STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    init_d, init_t = _init(problem, train)
    for got, want, init, name, trained in (
            (got_d, want_d, init_d, "density", train != "tf"),
            (got_t, want_t, init_t, "tf_base", train != "density")):
        assert got.min() >= 0.0 and got.max() <= 1.0
        if not trained:
            # No update; the clamp applies all the same, as in volrt (the
            # default TF's last blue entry is 129/128).
            np.testing.assert_array_equal(got, np.clip(init, 0.0, 1.0),
                                          err_msg=name)
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        sure = first[name].abs().numpy() > GRAD_FLOOR
        assert sure.any() and np.abs(got - init)[sure].min() > 0
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-3, rtol=0,
                                   err_msg=name)


def test_fused_diffuse_fit_matches_jax_fused_fit(problem):
    """(e) The one-launch route under the diffuse tap against ``volrt``'s
    fused route, both in the fast mode (bf16 storage): 1e-4 on the losses
    (measured: 8e-7)."""
    kw = dict(fused=True, shading="diffuse", light_kd=0.6)
    _, _, want_losses = _jax_fit(problem, "both", **kw)
    _, _, losses, _ = _torch_fit(
        problem, "both", first_kw=dict(shaded=True, light_kd=0.6), **kw)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_adam_step_is_optax_adam():
    """One optimiser, two leaves, three updates on seeded gradients."""
    rng = np.random.default_rng(21)
    p0 = [rng.uniform(0.2, 0.8, s).astype(np.float32)
          for s in ((4, 5, 6), (8, 4))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * 1e-3
              for p in p0] for _ in range(3)]
    opt = optax.adam(0.05)
    jp = tuple(jnp.asarray(p) for p in p0)
    state = opt.init(jp)
    scene = trender.DiffScene(torch.from_numpy(p0[0]),
                              torch.from_numpy(p0[1]), 0.1)
    topt = tfit_mod.make_optimizer(scene, 0.05)
    for g in grads:
        upd, state = opt.update(tuple(jnp.asarray(x) for x in g), state)
        jp = optax.apply_updates(jp, upd)
        scene.density.grad = torch.from_numpy(g[0])
        scene.tf_base.grad = torch.from_numpy(g[1])
        topt.step()
    np.testing.assert_allclose(scene.density.detach().numpy(),
                               np.asarray(jp[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(scene.tf_base.detach().numpy(),
                               np.asarray(jp[1]), atol=1e-5, rtol=0)


def test_train_step_and_losses(problem):
    """``make_train_step`` by hand: the two loss functions agree, a step
    counts, clamps and leaves a frozen leaf alone."""
    density, tf_base = _init(problem, "both")
    scene = trender.scene_from_arrays(density + 0.9, tf_base, STEP,
                                      device=CPU)
    view, target = problem["tview"], torch.from_numpy(problem["target"])
    a = tfit_mod.l2_loss(scene, view, target)
    b = tfit_mod.l2_loss_fused(scene, view, target)
    assert a.item() == pytest.approx(b.item(), rel=1e-6)
    state = tfit_mod.init_state(scene, tfit_mod.make_optimizer(scene, 0.05))
    step = tfit_mod.make_train_step(tfit_mod.l2_loss_fused,
                                    train_density=True, train_tf=False)
    before_tf = scene.tf_base.detach().clone()
    state, loss = step(state, view, target)
    assert state.step == 1 and loss.item() == pytest.approx(a.item())
    assert not loss.requires_grad
    torch.testing.assert_close(scene.tf_base.detach(), before_tf, atol=0,
                               rtol=0)
    # The density came in above 1 (0.3 + 0.9) and is clamped after the step.
    assert scene.density.max().item() == 1.0


def test_fit_refuses_what_is_not_ported(problem, tmp_path):
    """(f) Arguments of ``volrt``'s fit that wait for a later port; phong
    with ``fused=True``, ``esl`` and a ``.npz`` checkpoint run since the
    kernels and ``train/checkpoint.py`` have them, ``mesh`` and
    ``volume_sharded`` since ``dist/`` (here on a mesh of one rank, with
    no process group; ``tests/test_torch_dist.py`` runs them on worlds of
    two and four ranks); a mesh of another type raises ``TypeError``,
    ``volume_sharded`` without a mesh ``ValueError``, and a checkpoint
    path of another kind (``volrt``'s orbax directory) is refused."""
    from volrt_torch.dist.mesh import make_mesh

    scene = trender.scene_from_arrays(*_init(problem, "both"), STEP,
                                      device=CPU)
    pair = [(problem["tview"], torch.from_numpy(problem["target"]))]
    ckpt = str(tmp_path / "state.npz")
    one = make_mesh(CPU)
    for kw in (dict(mesh=one), dict(mesh=one, volume_sharded=True),
               dict(grad_chunks=4), dict(esl=True),
               dict(checkpoint_path=ckpt),
               dict(shading="phong", fused=True)):
        if "grad_chunks" not in kw:
            # Ported since: the one-launch step's phong mode, ESL (here
            # the oracle's leading leap), checkpoints and dist/.
            _, losses = tfit_mod.fit(scene, pair, steps=1, **kw)
            assert len(losses) == 1 and np.isfinite(losses[0])
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tfit_mod.fit(scene, pair, steps=1, **kw)
    with pytest.raises(TypeError, match="Mesh"):
        tfit_mod.fit(scene, pair, steps=1, mesh=object())
    with pytest.raises(ValueError, match="mesh"):
        tfit_mod.fit(scene, pair, steps=1, volume_sharded=True)
    assert os.path.exists(ckpt)
    with pytest.raises(ValueError, match="npz"):
        tfit_mod.fit(scene, pair, steps=1,
                     checkpoint_path=str(tmp_path / "orbax_dir"))
    with pytest.raises(ValueError):
        tfit_mod.fit(scene, pair, steps=1, shading="toon")
    assert tfit_mod.fit(scene, pair, steps=0) == (scene, [])
    # Phong trains through the oracle.
    _, losses = tfit_mod.fit(scene, pair, steps=1, shading="phong")
    assert len(losses) == 1 and np.isfinite(losses[0])


@pytest.mark.parametrize("kw", [dict(checkpoint_every=5),
                                dict(resume=True),
                                dict(esl_refresh_every=4)],
                         ids=["checkpoint_every", "resume",
                              "esl_refresh_every"])
def test_fit_takes_volrts_checkpoint_and_refresh_parameters(problem, kw):
    """(f) ``volrt``'s ``fit`` parameters for checkpoints and ESL refresh
    sit in its order, and after them the port's one parameter of its own
    (``full_d``: a rank's own rows in volume-sharded mode); each runs
    (``checkpoint_every`` and ``resume`` without a ``checkpoint_path``,
    like the ESL refresh without ``esl``, change nothing, as in ``volrt``);
    their defaults fit as before."""
    (name, _), = kw.items()
    want = [p for p in inspect.signature(jfit).parameters
            if p not in ("window", "flush")]
    got = list(inspect.signature(tfit_mod.fit).parameters)
    assert got == want + ["full_d"]
    assert inspect.signature(tfit_mod.fit).parameters[name].default in (
        0, False)
    scene = trender.scene_from_arrays(*_init(problem, "both"), STEP,
                                      device=CPU)
    pair = [(problem["tview"], torch.from_numpy(problem["target"]))]
    _, losses = tfit_mod.fit(scene, pair, steps=1, **kw)
    assert len(losses) == 1 and np.isfinite(losses[0])
    _, losses = tfit_mod.fit(scene, pair, steps=1, **{name: type(
        kw[name])()})
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_cli_fit_fits_a_file(capsys, tmp_path):
    """(f) ``cli fit -f`` on the committed DDS-compressed PVM, 32 x 32 for
    2 steps on the CPU; its checkpoint flags reach ``fit()``: a resume
    from the file at its last step has nothing to do, and a checkpoint
    path that is no ``.npz`` file is refused."""
    assert cli.main(["fit", "-f", ASSET_PATH, "-s", "32", "32", "--steps",
                     "2", "--device", CPU]) == 0
    captured = capsys.readouterr()
    losses = [float(ln.split("loss")[1]) for ln in captured.out.splitlines()
              if ln.startswith("fit step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "final loss" in captured.err and "on cpu" in captured.err
    ckpt = str(tmp_path / "state.npz")
    for flag in (["--checkpoint", ckpt], ["--checkpoint-every", "5"],
                 ["--resume"], ["--checkpoint", ckpt, "--resume"]):
        capsys.readouterr()
        assert cli.main(["fit", "-f", ASSET_PATH, "-s", "8", "8", "--steps",
                         "1", "--device", CPU, *flag]) == 0
    assert os.path.exists(ckpt)
    assert "fit step" not in capsys.readouterr().out
    with pytest.raises(ValueError, match="npz"):
        cli.main(["fit", "-f", ASSET_PATH, "-s", "8", "8", "--steps", "1",
                  "--device", CPU, "--checkpoint", str(tmp_path / "d")])


def test_step_bench_needs_a_card():
    """(f) A time on the CPU is no device metric: the headline
    (``python -m volrt_torch.bench``) refuses."""
    with pytest.raises(ValueError, match="CUDA"):
        harness.bench_diff_step(volume_size=8, viewport=16, device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        headline.main(["--synthetic", "8", "-s", "16", "--device", CPU])


@pytest.mark.parametrize("argv", [
    ["--fused", "--train", "both"],
    ["--train", "density"],
    ["--fused", "--train", "tf", "--shading", "diffuse"],
    ["--fused", "--esl", "--train", "both"],
    ["--esl", "--train", "density"],
], ids=["fused-both", "autograd-density", "fused-tf-diffuse", "fused-esl",
        "autograd-esl"])
def test_cli_fit_runs_on_the_cpu(argv, capsys):
    """(f) ``cli fit --device cpu`` at 8^3 / 16^2 for 2 steps."""
    assert cli.main(["fit", *argv, "--synthetic", "8", "-s", "16", "16",
                     "--steps", "2", "--device", CPU]) == 0
    captured = capsys.readouterr()
    lines = [ln for ln in captured.out.splitlines()
             if ln.startswith("fit step")]
    assert len(lines) == 2
    losses = [float(ln.split("loss")[1]) for ln in lines]
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert "final loss" in captured.err and "on cpu" in captured.err


def test_cli_fit_and_bench_default_to_the_card():
    """With no ``--device`` both commands ask for the card, and say so
    where there is none."""
    import inspect

    for fn in (harness.bench_diff_step, harness.bench_fwd_step,
               harness.bench_pose):
        assert inspect.signature(fn).parameters["device"].default is None
    if torch.cuda.is_available():
        return
    for main, argv in (
            (cli.main, ["fit", "--synthetic", "8", "-s", "16", "16",
                        "--steps", "1"]),
            (headline.main, ["--synthetic", "8", "-s", "16"])):
        with pytest.raises((AssertionError, RuntimeError),
                           match="CUDA|cuda"):
            main(argv)


def _trap():
    """``test_diff_v3.py::TestEslTfTrap``'s scene: all density at 200/255
    (TF entries near 100), a trainable TF that starts with zero opacity
    everywhere, so that every ESL block derives empty, and the target the
    open TF renders; on the CPU."""
    from volrt_torch.core.tf import default_transfer_fn
    from volrt_torch.core.view import Camera

    vol = np.zeros((16, 16, 16), np.uint8)
    vol[4:12, 4:12, 4:12] = 200
    tf_open = default_transfer_fn(CPU)
    truth = trender.scene_from_volume(vol, tf_open, 0.15, device=CPU)
    cam = Camera(dims=(24, 24))
    cam.set_camera_position((25.0, 10.0, 0.0))
    view = cam.view(CPU)
    with torch.no_grad():
        target = trender.render_diff_image(truth, view)
    tf_closed = tf_open.clone()
    tf_closed[:, 3] = 0.0
    return (trender.DiffScene(truth.density.detach(), tf_closed, 0.15),
            view, target)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "oracle"])
def test_pure_esl_training_is_trapped(fused):
    """``fit(esl=True)`` alone: every sample is skipped (the one-launch
    step's ESL mode) or leapt (the oracle's leading leap), so no TF entry
    gets a gradient; the TF's alpha stays at zero and the loss never
    moves (``test_diff_v3.py::TestEslTfTrap``)."""
    scene, view, target = _trap()
    _, losses = tfit_mod.fit(scene, [(view, target)], steps=4, lr=0.05,
                             train_density=False, fused=fused, esl=True)
    assert scene.tf_base[:, 3].max().item() == 0.0
    np.testing.assert_allclose(losses[-1], losses[0], rtol=1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "oracle"])
def test_esl_refresh_escapes_the_trap(fused):
    """``esl_refresh_every=2``: steps 0 and 2 march in full, which hands
    the closed TF entries their gradient; the TF opens and the loss falls
    below the trapped plateau. The first step is the full march's: its
    loss is the ESL-off step's (in the fast mode on the fused route)."""
    scene, view, target = _trap()
    with torch.no_grad():
        first = tdiff_v3.l2_loss_grads_v3_onepass(scene, view, target,
                                                  fast=fused)[0]
    _, losses = tfit_mod.fit(scene, [(view, target)], steps=4, lr=0.05,
                             train_density=False, fused=fused, esl=True,
                             esl_refresh_every=2)
    assert scene.tf_base[:, 3].max().item() > 0.0
    assert losses[-1] < losses[0]
    assert losses[0] == pytest.approx(first.item(), rel=1e-4)
