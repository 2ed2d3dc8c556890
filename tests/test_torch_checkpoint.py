"""The port's checkpoints (``volrt_torch.train.checkpoint``) against
``volrt``'s (``volrt.train.checkpoint``): one ``.npz`` format, resumed
by either package from the other's file.

The optimizer state of a file from ``volrt`` is made with
``optax.adam(lr).update`` on seeded gradients, no render. Tolerances: one
Adam update of the same state with the same gradient, in optax and in
torch: moments to 1e-6 (the same products and sums), parameters to 2e-5,
a thousandth of the step ``lr`` = 0.02 (optax takes the bias corrections
``1 - 0.999^t`` in f32, where the difference cancels most of its bits;
torch in f64; measured 5.1e-6). A fit step resumed from the same file, in either
package: the fit tests' classes (``tests/test_torch_fit.py``), losses to
rtol 1e-4 and parameters to 1e-3. Scenes are 16^3, views 16^2.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_core import one_torch_thread  # noqa: F401
from tests.test_torch_diff import CPU, STEP, _pair
from volrt.diff import render as jrender
from volrt.train import checkpoint as jckpt
from volrt.train.fit import TrainState as JTrainState
from volrt.train.fit import fit as jfit
from volrt_torch.diff import render as trender
from volrt_torch.train import checkpoint as tckpt
from volrt_torch.train import fit as tfit

LR = 0.02
SEED = 3


def _grads(shapes, k):
    """The k-th seeded gradient of (density, tf_base)."""
    rng = np.random.default_rng(SEED + k)
    return tuple(rng.normal(0.0, 0.1, s).astype(np.float32) for s in shapes)


def _volrt_file(path, density, tf_base, updates=2):
    """A ``volrt`` checkpoint after ``updates`` Adam updates of seeded
    gradients -> ``(params, opt_state)``."""
    opt = optax.adam(LR)
    params = (jnp.asarray(density), jnp.asarray(tf_base))
    state = opt.init(params)
    for k in range(updates):
        upd, state = opt.update(tuple(map(jnp.asarray, _grads(
            [p.shape for p in params], k))), state)
        params = optax.apply_updates(params, upd)
    scene = jrender.DiffScene(density=params[0], tf_base=params[1],
                              ray_step=STEP)
    jckpt.save(path, JTrainState(scene, state, jnp.asarray(updates)))
    return params, state


def _scene():
    (jscene, _, _), _ = _pair(dims=(16, 16))
    return np.asarray(jscene.density), np.asarray(jscene.tf_base)


def test_adam_leaves_are_optaxs():
    """The file's ``opt_i`` order is ``optax.adam``'s leaf order."""
    state = optax.adam(LR).init((jnp.zeros((2, 2)), jnp.zeros((3,))))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(state)[0]]
    names = {"count": "count", "exp_avg": "mu", "exp_avg_sq": "nu"}
    want = [f"[0].{names[leaf]}" if leaf == "count" else
            f"[0].{names[leaf[0]]}[{leaf[1]}]" for leaf in tckpt.ADAM_LEAVES]
    assert paths == want


def test_a_volrt_file_resumes_in_the_port(tmp_path):
    """``volrt``'s file loads into the port (leaves, step, moments), and
    the next Adam update there equals optax's."""
    path = str(tmp_path / "j.npz")
    density, tf_base = _scene()
    params, jstate = _volrt_file(path, density, tf_base)
    state = tckpt.load(path, lr=LR, device=CPU)
    assert state.step == 2 and state.scene.ray_step == STEP
    for p, want in zip((state.scene.density, state.scene.tf_base), params):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(want))
    g = _grads([p.shape for p in params], 2)
    upd, jstate = optax.adam(LR).update(tuple(map(jnp.asarray, g)), jstate)
    want = optax.apply_updates(params, upd)
    leaves = (state.scene.density, state.scene.tf_base)
    for p, gi in zip(leaves, g):
        p.grad = torch.from_numpy(gi)
    state.optimizer.step()
    for i, p in enumerate(leaves):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[i]),
                                   atol=2e-5, rtol=0)
        st = state.optimizer.state[p]
        assert int(st["step"]) == int(jstate[0].count) == 3
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(jstate[0].mu[i]), atol=1e-6)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(jstate[0].nu[i]), atol=1e-6)


def test_a_port_file_resumes_in_volrt(tmp_path):
    """The port's file loads into ``volrt`` (``volrt.train.checkpoint
    .load``), and the next Adam update there equals torch's; a frozen
    leaf's moments are written as zeros at the shared count."""
    density, tf_base = _scene()
    scene = trender.scene_from_arrays(density, tf_base, STEP, device=CPU)
    state = tfit.init_state(scene, tfit.make_optimizer(scene, LR))
    shapes = [density.shape, tf_base.shape]
    for k in range(2):
        scene.density.grad = torch.from_numpy(_grads(shapes, k)[0])
        scene.tf_base.grad = None  # frozen, as fit freezes a leaf
        state.optimizer.step()
        state.step += 1
    path = str(tmp_path / "t.npz")
    tckpt.save(path, state)
    assert not os.path.exists(path + ".tmp.npz")
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ["density", "tf_base", "step", "meta"]
            + [f"opt_{i}" for i in range(5)])
        assert z["opt_0"].dtype == np.int32 and int(z["opt_0"]) == 2
        assert not z["opt_2"].any() and not z["opt_4"].any()
    opt = optax.adam(LR)
    jstate = jckpt.load(path, opt)
    assert int(jstate.step) == 2 and jstate.scene.ray_step == STEP
    np.testing.assert_array_equal(np.asarray(jstate.scene.density),
                                  scene.density.detach().numpy())
    g = _grads(shapes, 2)
    params = (jstate.scene.density, jstate.scene.tf_base)
    upd, _ = opt.update(tuple(map(jnp.asarray, g)), jstate.opt_state)
    want = optax.apply_updates(params, upd)
    state = tckpt.load(path, lr=LR, device=CPU)
    for p, gi in zip((state.scene.density, state.scene.tf_base), g):
        p.grad = torch.from_numpy(gi)
    state.optimizer.step()
    np.testing.assert_allclose(state.scene.density.detach().numpy(),
                               np.asarray(want[0]), atol=2e-5, rtol=0)
    np.testing.assert_allclose(state.scene.tf_base.detach().numpy(),
                               np.asarray(want[1]), atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def problem():
    (jscene, jview, _), (_, tview, _) = _pair(dims=(16, 16))
    target = np.array(jrender.render_diff_image(jscene, jview))
    init = (np.full(np.asarray(jscene.density).shape, 0.3, np.float32),
            (0.5 * np.asarray(jscene.tf_base) + 0.25).astype(np.float32))
    return dict(jview=jview, tview=tview, target=target, init=init)


def _resume_both(problem, path, steps):
    """Resume ``path`` to ``steps`` in each package (copies of the file):
    ``((density, tf_base, losses) of volrt, the same of the port)``."""
    jpath, tpath = path + ".j.npz", path + ".t.npz"
    for dst in (jpath, tpath):
        with open(path, "rb") as f, open(dst, "wb") as g:
            g.write(f.read())
    d0, t0 = problem["init"]
    jscene = jrender.DiffScene(density=jnp.asarray(d0),
                               tf_base=jnp.asarray(t0), ray_step=STEP)
    jscene, jl = jfit(jscene, [(problem["jview"],
                                jnp.asarray(problem["target"]))],
                      steps=steps, lr=LR, checkpoint_path=jpath,
                      resume=True)
    tscene = trender.scene_from_arrays(d0, t0, STEP, device=CPU)
    tscene, tl = tfit.fit(tscene, [(problem["tview"],
                                    torch.from_numpy(problem["target"]))],
                          steps=steps, lr=LR, checkpoint_path=tpath,
                          resume=True)
    return ((np.asarray(jscene.density), np.asarray(jscene.tf_base), jl),
            (tscene.density.detach().numpy(),
             tscene.tf_base.detach().numpy(), tl))


@pytest.mark.parametrize("writer", ["volrt", "port"])
def test_the_step_after_a_resume_matches_across_packages(problem, tmp_path,
                                                         writer):
    """A file written by either package (``volrt``'s from optax updates on
    seeded gradients, the port's from two fit steps) resumes in both, and
    their next fit step agrees: losses to rtol 1e-4, parameters to 1e-3;
    each package's file records step 3 after it."""
    path = str(tmp_path / "state.npz")
    d0, t0 = problem["init"]
    if writer == "volrt":
        _volrt_file(path, d0, t0)
    else:
        scene = trender.scene_from_arrays(d0, t0, STEP, device=CPU)
        _, losses = tfit.fit(scene, [(problem["tview"], torch.from_numpy(
            problem["target"]))], steps=2, lr=LR, checkpoint_path=path)
        assert len(losses) == 2
    (jd, jt, jl), (td, tt, tl) = _resume_both(problem, path, 3)
    assert len(jl) == len(tl) == 1
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(td, jd, atol=1e-3, rtol=0)
    np.testing.assert_allclose(tt, jt, atol=1e-3, rtol=0)
    for suffix in (".j.npz", ".t.npz"):
        with np.load(path + suffix) as z:
            assert int(z["step"]) == 3 and int(z["opt_0"]) == 3


def test_fit_resumes_where_it_stopped(problem, tmp_path):
    """Two steps saved and resumed to four equal four steps straight
    through, to the bit on the CPU; ``checkpoint_every`` writes on its
    steps; a resume at the last step has nothing to do."""
    target = torch.from_numpy(problem["target"])
    d0, t0 = problem["init"]
    part, whole = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")

    def run(steps, path, **kw):
        scene = trender.scene_from_arrays(d0, t0, STEP, device=CPU)
        return tfit.fit(scene, [(problem["tview"], target)], steps=steps,
                        lr=LR, checkpoint_path=path, fused=True, **kw)

    _, first = run(2, part)
    scene, rest = run(4, part, resume=True, checkpoint_every=1)
    straight_scene, straight = run(4, whole)
    assert first + rest == straight
    assert torch.equal(scene.density, straight_scene.density)
    assert torch.equal(scene.tf_base, straight_scene.tf_base)
    assert run(4, part, resume=True)[1] == []
    a = tckpt.load(part, device=CPU)
    b = tckpt.load(whole, device=CPU)
    assert a.step == b.step == 4
    for p, q in zip((a.scene.density, a.scene.tf_base),
                    (b.scene.density, b.scene.tf_base)):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][key],
                               b.optimizer.state[q][key])


def test_orbax_paths_are_refused(tmp_path):
    density, tf_base = _scene()
    scene = trender.scene_from_arrays(density, tf_base, STEP, device=CPU)
    state = tfit.init_state(scene, tfit.make_optimizer(scene, LR))
    for fn in (lambda p: tckpt.save(p, state),
               lambda p: tckpt.load(p, device=CPU),
               lambda p: tckpt.restore(p, state)):
        with pytest.raises(ValueError, match=r"\.npz"):
            fn(str(tmp_path / "orbax_dir"))
