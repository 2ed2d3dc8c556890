"""The trainer's optimiser (``train/adam.py``, ``csrc/adam.cu``): Adam and
the [0, 1] clamp of each trained leaf in one pass.

On the CPU: the plain version is ``torch.optim.Adam`` followed by
``clamp_`` to the bit; the kernel's arithmetic (``csrc/adam.cuh``),
emulated in numpy f32 in its order, gives the plain version's moments to
the bit and its leaf to the bit wherever torch's square root is
correctly rounded; ``Adam`` keeps the interface its readers use; the
train step clamps a frozen leaf and does not update it; and building the
optimiser imports no ``torch._dynamo``. The tests marked ``card`` hold
the kernel to the plain version on the card; they skip without a card.
This file imports no JAX, so on the card:

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_adam.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from volrt_torch.core.types import View
from volrt_torch.diff.render import DiffScene
from volrt_torch.train import adam
from volrt_torch.train import fit as tfit

LR = 0.05
# Where torch's square root on the CPU is an ulp off (ATen's vectorised
# square root, within half an ulp and a little more: 0.6-0.75 % of random
# elements), the kernel's leaf may part from the plain version's: that ulp
# carries through the division by sqrt(1 - beta2^t), the eps and the
# division of the step, each rounded on its own. The worst read, in ulps
# of the larger of the leaf and its step: 4 with torch 2.13 on an AVX-512
# host (the numpy emulation, 7 steps of 4M elements), 3 on an H100's host
# with torch 2.11 (the kernel, chip_smoke.py phase 25). That is past the
# 2 ulps the kernel was asked to keep: the gap is the host's square root,
# not the kernel, which is equal to the bit wherever the host's square
# root is correctly rounded (moments everywhere).
STEP_ULPS = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(seed: int, shapes=((6, 7, 9), (128, 4))):
    """Leaves in [-0.3, 1.3] (so that the clamp bites) and four steps of
    gradients a leaf, one entry of the first step's NaN."""
    rng = np.random.default_rng(seed)
    leaves = [rng.uniform(-0.3, 1.3, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0.0, 0.1, s).astype(np.float32) for s in shapes]
             for _ in range(4)]
    grads[0][0].reshape(-1)[17] = np.nan
    return leaves, grads


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.int32).numpy()


def _assert_bits_equal(got: torch.Tensor, want: torch.Tensor, what):
    bad = int((_bits(got) != _bits(want)).sum())
    assert bad == 0, (what, bad)


def test_the_plain_update_is_torch_adam_then_clamp():
    """Four steps over two leaves, the second frozen (no gradient) at the
    third step, the first with a NaN gradient entry: leaves, moments and
    step counts equal ``torch.optim.Adam`` + ``clamp_(0, 1)``'s to the
    bit, the NaN kept, the frozen step updating nothing but the clamp."""
    leaves, grads = _leaves(5)
    ours = [torch.tensor(x, requires_grad=True) for x in leaves]
    theirs = [torch.tensor(x, requires_grad=True) for x in leaves]
    opt = adam.Adam(ours, LR)
    ref = torch.optim.Adam(theirs, lr=LR, betas=(0.9, 0.999), eps=1e-8)
    for k, step_grads in enumerate(grads):
        for a, b, g in zip(ours, theirs, step_grads):
            frozen = k == 2 and a is ours[1]
            a.grad = None if frozen else torch.from_numpy(g.copy())
            b.grad = None if frozen else torch.from_numpy(g.copy())
        opt.step(clamp=(0.0, 1.0))
        ref.step()
        with torch.no_grad():
            for b in theirs:
                b.clamp_(0.0, 1.0)
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_bits_equal(a, b, (k, i))
            for key in ("exp_avg", "exp_avg_sq"):
                _assert_bits_equal(opt.state[a][key], ref.state[b][key],
                                   (k, i, key))
            assert float(opt.state[a]["step"]) == float(
                ref.state[b]["step"])
    assert torch.isnan(ours[0].reshape(-1)[17])
    assert int(opt.state[ours[1]]["step"]) == 3
    assert int(opt.state[ours[0]]["step"]) == 4


def test_the_optimizer_keeps_torch_adams_interface():
    """What ``train/checkpoint.py``, the benchmark's drivers and the dist
    tests read: ``param_groups[0]``'s ``lr``, ``betas``, ``eps``;
    ``state[p]``'s ``step`` (a CPU f32 tensor), ``exp_avg``,
    ``exp_avg_sq``, made at a leaf's first update; ``zero_grad``; and
    ``step()`` without a clamp is Adam alone."""
    leaves, grads = _leaves(7)
    ps = [torch.tensor(x, requires_grad=True) for x in leaves]
    opt = adam.Adam(ps, 0.02)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (
        0.02, (0.9, 0.999), 1e-8)
    assert opt.state == {}
    ps[0].grad = torch.from_numpy(grads[1][0])
    opt.step()
    assert set(opt.state) == {ps[0]}
    st = opt.state[ps[0]]
    assert set(st) == {"step", "exp_avg", "exp_avg_sq"}
    assert st["step"].dtype == torch.float32 and st["step"].device.type == (
        "cpu") and int(st["step"]) == 1
    # Without a clamp the leaf may leave [0, 1]: Adam alone.
    assert ps[0].min() < 0.0 and ps[0].max() > 1.0
    b1 = group["betas"][0]
    torch.testing.assert_close(st["exp_avg"] / (1 - b1), ps[0].grad,
                               rtol=1e-6, atol=0.0)
    opt.zero_grad(set_to_none=False)
    assert torch.count_nonzero(ps[0].grad) == 0
    opt.zero_grad(set_to_none=True)
    assert ps[0].grad is None and ps[1].grad is None


def test_a_frozen_leaf_is_clamped_and_not_updated_by_the_train_step():
    """``make_train_step(train_tf=False)``: the TF, which starts outside
    [0, 1], is clamped and otherwise untouched, and keeps no Adam state;
    the density is updated once and clamped."""
    leaves, grads = _leaves(11)
    scene = DiffScene(torch.from_numpy(leaves[0]),
                      torch.from_numpy(leaves[1]), 0.1)
    state = tfit.init_state(scene, tfit.make_optimizer(scene, LR))
    want_tf = torch.from_numpy(leaves[1]).clamp(0.0, 1.0)
    want_density = torch.tensor(leaves[0])
    m, v = torch.zeros_like(want_density), torch.zeros_like(want_density)
    adam.adam_step_plain(want_density, torch.from_numpy(grads[1][0]), m, v,
                         LR, 1, (0.0, 1.0))

    def loss_grads_fn(scene, view, target):
        return torch.zeros(()), {"density": torch.from_numpy(grads[1][0]),
                                 "tf_base": torch.from_numpy(grads[1][1])}

    step = tfit.make_train_step(loss_grads_fn=loss_grads_fn,
                                train_density=True, train_tf=False)
    view = View.from_arrays((0, 0, -3), (0, 0, 1), (1, 0, 0), (0, 1, 0),
                            (0, 0, -3), (4, 4), False, "cpu")
    state, _ = step(state, view, None)
    _assert_bits_equal(scene.tf_base, want_tf, "frozen TF")
    _assert_bits_equal(scene.density, want_density, "density")
    assert scene.tf_base not in state.optimizer.state
    assert int(state.optimizer.state[scene.density]["step"]) == 1


def test_building_the_optimizer_imports_no_dynamo():
    """``torch.optim``'s optimisers import ``torch._dynamo`` at their first
    construction (some 9 s of a trainer's set-up on the card's host);
    ``make_optimizer`` and a train step import nothing of it."""
    code = (
        "import sys, torch\n"
        "from volrt_torch.diff.render import DiffScene\n"
        "from volrt_torch.train import fit\n"
        "s = DiffScene(torch.rand(4, 4, 4), torch.rand(8, 4), 0.5)\n"
        "opt = fit.make_optimizer(s)\n"
        "s.density.grad = torch.rand(4, 4, 4)\n"
        "opt.step(clamp=(0.0, 1.0))\n"
        "assert 'torch._dynamo' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=300)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Ulps between f32 arrays of one sign (0 where both are NaN)."""
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.abs(a.view(np.int32).astype(np.int64)
               - b.view(np.int32).astype(np.int64))
    return np.where(both_nan, 0, d)


def _step_ulps(got: np.ndarray, want: np.ndarray, before: np.ndarray
               ) -> np.ndarray:
    """``|got - want|`` in ulps of the largest of ``want``, ``before`` and
    the step between them (0 where both are NaN)."""
    both_nan = np.isnan(got) & np.isnan(want)
    scale = np.spacing(np.maximum.reduce(
        [np.abs(want), np.abs(before), np.abs(want - before)]))
    with np.errstate(invalid="ignore"):
        return np.where(both_nan, 0.0, np.abs(got - want) / scale)


def _held(got, want, before, v) -> None:
    """The kernel's leaf, moments (``got``) against the plain version's
    (``want``) after one step from the same state: the moments to the
    bit; the leaf to the bit wherever torch's square root of the new
    second moment ``v`` is correctly rounded, and within ``STEP_ULPS``
    (:func:`_step_ulps`) elsewhere."""
    for k in (1, 2):
        assert (_ulps(got[k], want[k]) == 0).all(), k
    rounded = torch.from_numpy(v).sqrt().numpy() == np.sqrt(v)
    assert (_ulps(got[0], want[0])[rounded] == 0).all()
    assert _step_ulps(got[0], want[0], before).max() <= STEP_ULPS


def _adam_emulated(p, g, m, v, lr, step, clamp):
    """``csrc/adam.cuh:adam_element`` in numpy f32, each operation rounded
    on its own in the kernel's order; an FMA as the exact f64 product and
    sum rounded to f32 (the sum's double rounding is too rare to meet
    here); the square root correctly rounded, as ``__fsqrt_rn``."""
    f32 = np.float32
    s = adam._scalars(lr, step)

    def fma(a, b, c):
        return (np.float64(a) * np.asarray(b, np.float64) + c).astype(f32)

    m = fma(f32(s["w1"]), g - m, m)
    v = fma(f32(s["w2"]) * g, g, v * f32(s["beta2"]))
    denom = np.sqrt(v) / f32(s["bc2_sqrt"]) + f32(s["eps"])
    p = p + (f32(-s["step_size"]) * m) / denom
    if clamp is not None:
        p = np.where(p < f32(clamp[0]), f32(clamp[0]), p)
        p = np.where(p > f32(clamp[1]), f32(clamp[1]), p)
    return p.astype(f32), m, v


def test_the_kernels_arithmetic_emulated_is_the_plain_version():
    """Three steps on 40,003 elements (every lane and tail of ATen's
    vectorised loops), each from the plain version's state: the emulated
    kernel is held to the plain version as the kernel is on the card
    (:func:`_held`)."""
    rng = np.random.default_rng(13)
    n = 40_003
    tp = torch.from_numpy(rng.uniform(-0.3, 1.3, n).astype(np.float32))
    tm, tv = torch.zeros(n), torch.zeros(n)
    for step in (1, 2, 3):
        g = rng.normal(0.0, 0.1, n).astype(np.float32)
        g[5] = np.nan
        before = tp.numpy().copy()
        got = _adam_emulated(before, g, tm.numpy().copy(),
                             tv.numpy().copy(), LR, step, (0.0, 1.0))
        adam.adam_step_plain(tp, torch.from_numpy(g), tm, tv, LR, step,
                             (0.0, 1.0))
        _held(got, (tp.numpy(), tm.numpy(), tv.numpy()), before, tv.numpy())
    assert np.isnan(tp.numpy()[5]) and np.isnan(got[0][5])


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    p = torch.zeros(8)
    for g, err in ((torch.zeros(9), ValueError),
                   (torch.zeros(8, dtype=torch.float64), TypeError),
                   (torch.zeros(16)[::2], ValueError)):
        with pytest.raises(err):
            adam.adam_step(p, g, torch.zeros(8), torch.zeros(8), LR, 1)


def test_the_gradients_of_the_meshes_start_16_byte_aligned():
    """The gradients that the kernel reads 16 bytes at a time start at a
    multiple of 16 B where a mesh's step hands out views of a buffer: the
    row-band steps' summed buffers (``fit.l2_loss_grads_sharded`` and
    ``dist/render.l2_loss_grads_v3_sharded``) and the volume-sharded
    step's own rows of the halo'd slab (``FoldHalo``), here on a volume
    whose rows hold an odd number of voxels (5 x 7)."""
    from volrt_torch.core.tf import default_transfer_fn
    from volrt_torch.core.view import Camera
    from volrt_torch.dist import volume_sharded as vs
    from volrt_torch.dist.mesh import Mesh
    from volrt_torch.dist.render import l2_loss_grads_v3_sharded

    cpu = torch.device("cpu")
    mesh = Mesh(None, 0, 1, cpu)
    rng = np.random.default_rng(5)
    scene = DiffScene(torch.from_numpy(rng.uniform(0, 1, (6, 5, 7)).astype(
        np.float32)), default_transfer_fn(cpu), 0.1)
    view = Camera(dims=(12, 10)).view(cpu)
    target = torch.zeros((10, 12, 4))
    for fn in (tfit.l2_loss_grads_sharded, l2_loss_grads_v3_sharded):
        _, grads = fn(scene, view, target, mesh)
        for name, g in grads.items():
            assert g.data_ptr() % 16 == 0, (fn.__name__, name)
    for halo in (1, 2, 3):
        own = scene.density.detach().clone().requires_grad_(True)
        slab = vs.refresh_halos(own, mesh, halo, 6)
        out = vs.FoldHalo.apply(slab.slab, slab.z_start, 6, halo, mesh)
        (out * out).sum().backward()
        assert own.grad.data_ptr() % 16 == 0, halo
        # The halo rows repeat the volume's edge rows: their gradient is
        # folded onto those rows.
        want = 2 * own.detach()
        want[0] *= 1 + halo
        want[-1] *= 1 + halo
        torch.testing.assert_close(own.grad, want)


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tmp_path):
    """The benchmark's fault "the optimiser's step leaves parameters and
    moments as they were", planted in the optimiser the trainer runs
    (``Adam.step``): a tiny ``synth256-fit.full1024`` run on the CPU is
    correct, and not correct with the fault. In a process of its own, since
    a benchmark run refuses a process that has loaded JAX."""
    code = (
        "import json, shutil, sys, torch\n"
        "from pathlib import Path\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "from tinybench import shrink\n"
        "from portbench import run\n"
        "from volrt_torch.train import adam\n"
        "root = Path(sys.argv[1])\n"
        "shutil.copy('BENCHMARK.json', root)\n"
        "shutil.copytree('portbench', root / 'portbench', ignore=shutil."
        "ignore_patterns('__pycache__', 'tests'))\n"
        "(root / 'volrt_torch').symlink_to(Path('volrt_torch').resolve())\n"
        "shrink(root)\n"
        "torch.set_num_threads(1)\n"
        "for fault in (False, True):\n"
        "    if fault:\n"
        "        adam.Adam.step = lambda self, clamp=None: None\n"
        "    rc = run.main(['--workload', 'synth256-fit.full1024', '--seed',"
        " str(2**31 + 12345), '--seconds', '0.2', '--trace', '0'],"
        " root=root, device='cpu')\n"
        "    assert rc == 0, rc\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         check=True, env=env, cwd=ROOT, timeout=600,
                         capture_output=True, text=True)
    results = [json.loads(line) for line in out.stdout.splitlines()
               if line.startswith("{")]
    assert [r["correct"] for r in results] == [True, False], out.stdout
    assert any(line.endswith("FAIL") for line in out.stderr.splitlines())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n", [3, 4, 1027, 1 << 20, 3 * (1 << 20) + 5])
def test_adam_kernel_is_the_plain_version_on_the_card(card, n):
    """The kernel against the plain version on the host copy, three steps
    each from the same state, the clamp on and off (:func:`_held`); one
    launch a step."""
    rng = np.random.default_rng(n)
    host = [torch.from_numpy(rng.uniform(-0.3, 1.3, n).astype(np.float32)),
            torch.zeros(n), torch.zeros(n)]
    before_launches = adam.adam_step.launches
    for step, clamp in ((1, (0.0, 1.0)), (2, None), (3, (0.0, 1.0))):
        g = rng.normal(0.0, 0.1, n).astype(np.float32)
        g[n // 2] = np.nan
        dev = [t.to(card) for t in host]
        before = host[0].numpy().copy()
        adam.adam_step(*dev[:1], torch.from_numpy(g).to(card), *dev[1:], LR,
                       step, clamp)
        adam.adam_step_plain(host[0], torch.from_numpy(g), *host[1:], LR,
                             step, clamp)
        _held([t.cpu().numpy() for t in dev], [t.numpy() for t in host],
              before, host[2].numpy())
    assert adam.adam_step.launches == before_launches + 3


@pytest.mark.card
def test_adam_kernel_refuses_a_misaligned_tensor(card):
    base = torch.zeros(9, device=card)
    with pytest.raises(ValueError, match="aligned"):
        adam.adam_step(base[1:], torch.zeros(8, device=card),
                       torch.zeros(8, device=card),
                       torch.zeros(8, device=card), LR, 1)
