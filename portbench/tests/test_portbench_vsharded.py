"""The volume-sharded cell (``synth1792-fit.vsharded4``): its files, its
reference's sample counts, its control and faults against its limits on
the CPU (four ``gloo`` ranks at a tiny size), and two NCCL steps on four
cards (``card``; skips without four)."""
from __future__ import annotations

import json
import math
import shutil

import pytest
import torch

from conftest import ROOT
from portbench import harness, peaks
from portbench import reference as ref
from portbench import reference_vsharded as rvs
from tinybench import run_cell

CELL = "synth1792-fit.vsharded4"


def test_the_cell_and_its_files():
    c = harness.Cell(CELL, ROOT)
    assert c.workload["chips"] == 4 and c.traffic["driver"] == "fit_sharded"
    assert c.config["volume"]["size"] == 1792
    assert set(c.config["reduced"]) == set(c.config_entry["reduced"])
    assert hasattr(c.driver(), "Run")
    assert {m["name"] for m in c.end_to_end()} == {"train_ray_steps_per_s",
                                                   "setup_s"}
    names = {m["name"] for m in c.per_layer()}
    assert names == {"slab_march_roofline", "collective_stream_ms.vsharded",
                     "halo_stream_ms.vsharded", "optimizer_stream_ms.vsharded",
                     "device_idle_pct.vsharded"}
    for name in names:
        assert hasattr(c.reader(name), "read")
    mod = harness.kernel_counts(ROOT, c.traffic["kernel"])
    assert len(mod.launches({"prepass": 10, "seeded": 5, "seeded_replay": 4,
                             "prepass_replay": 0}, 4, 64)) == 4
    # A slab of the cell stays under the slab kernels' 32-bit offsets.
    n = c.config["volume"]["size"]
    assert (n // 4 + 2) * n * n < 2**31


def _direct(r, z_lo, z_hi, full_d, step, taken, replayed):
    """Samples of each ray whose position lies in rows ``[z_lo, z_hi)``,
    one sample at a time: every lattice sample ``k0 + j * step <= kfar``
    (the prepass), those before ``taken[ray]`` (the seeded march), the
    latter for the rays ``replayed`` (the seeded march's replay), and the
    former for the rays replayed that take a sample past the slab (the
    prepass's replay)."""
    lo = -1.0 + 2.0 * z_lo / full_d
    hi = -1.0 + 2.0 * z_hi / full_d
    pre = seeded = seeded_replay = pre_replay = 0
    for i in range(r["o"].shape[0]):
        if not bool(r["alive"][i]):
            continue
        inside_j = []
        j = 0
        while True:
            k = float(r["k0"][i] + torch.tensor(float(j)) * step)
            if k > float(r["kfar"][i]):
                break
            z = float(r["o"][i, 2] + r["d"][i, 2] * k)
            if lo <= z < hi or (z_lo == 0 and z < lo) or (
                    z_hi == full_d and z >= hi):
                inside_j.append(j)
            j += 1
        n_taken = int(taken[i])
        mine = sum(j < n_taken for j in inside_j)
        pre += len(inside_j)
        seeded += mine
        if bool(replayed[i]):
            seeded_replay += mine
            if inside_j and n_taken > max(inside_j) + 1:
                pre_replay += len(inside_j)
    return {"prepass": pre, "seeded": seeded, "seeded_replay": seeded_replay,
            "prepass_replay": pre_replay}


def test_slab_counts_against_a_direct_count():
    """``reference_vsharded.slab_samples`` (the lattice indices each slab
    takes, and the rays each replay passes over) against a
    sample-by-sample count by position, on a 32^3 case with an oblique
    view, for a first, middle and last slab; and ``counts/march_slab.py``'s
    four launches from them."""
    n, seed = 32, 2**31 + 7
    dens = rvs.density_rows(n, 0, n, seed, "cpu")
    tf = ref.default_tf_base("cpu")
    step = ref.default_ray_step((n, n, n))
    view = ref.pose((25.0, 10.0, 0.0), False, 2.0, (12, 10))
    target = rvs.render(rvs.density_rows(n, 0, n, seed, "cpu", stream=1),
                        tf, [view], ray_step=step, thr=0.95)[0]
    r = ref.v3_rays(view, "cpu")
    # The whole march with ERT at 0.95: each ray's samples taken, and
    # whether its colour differs from the target's.
    c = rvs._march_chunk(dens.reshape(-1), dens.shape, ref.premultiply(tf),
                         r, ray_step=step, thr=0.95, rnd=None, grad=False)
    taken = c["taken"].sum(1)
    replayed = (c["out"] != target.reshape(-1, 4)).any(-1)
    assert 0 < int(replayed.sum()) < int(r["alive"].sum())
    for z0 in (0, 8, 24):
        got = rvs.slab_samples(dens, tf, view, target, ray_step=step,
                               thr=0.95, z_start=z0, slab_d=8,
                               points=1 << 12)
        want = _direct(r, z0, z0 + 8, n, step, taken, replayed)
        assert got == want
        assert got["seeded"] < got["prepass"]
    assert got["prepass_replay"] < got["prepass"]
    counts = harness.kernel_counts(ROOT, "march_slab")
    work = counts.launches(got, 120, 10 * n * n)
    assert work[0][0] == got["prepass"] * peaks.FLOPS_FWD
    assert work[2][0] == got["seeded_replay"] * peaks.FLOPS_BWD
    assert work[3][0] == got["prepass_replay"] * peaks.FLOPS_BWD
    assert work[1][1] < work[2][1]


def test_the_control_and_faults_fail_a_limit(tiny_root):
    """At a tiny size on the CPU (four ``gloo`` ranks): the program passes
    its limits, and the control (the reference with the density stored
    in bf16) and every fault (no opacity scan, the halo's gradient
    dropped, half of each view's rays, the state left unchanged) each
    fail one."""
    c = harness.Cell(CELL, tiny_root)
    run = c.driver().Run(c, 2**31 + 99, torch.device("cpu"))
    run.window(0.2)
    run.free()
    checks = run.check(controls=("control", *rvs.FAULTS))
    assert all(v <= lim for v, lim in checks.values()), checks
    assert set(run.calibration) == {"control", *rvs.FAULTS}
    for kind, found in run.calibration.items():
        assert any(found[k] > lim for k, (_, lim) in checks.items()), (
            kind, found)


def test_a_run_leaves_no_rank(tiny_root, capsys):
    """A run on the CPU reports, and ends every rank it started."""
    import multiprocessing

    rc, result, _ = run_cell(tiny_root, CELL, capsys)
    assert rc == 0 and result["correct"] is True
    assert result["device"]["count"] == 4
    assert multiprocessing.active_children() == []


@pytest.mark.card
def test_two_nccl_steps_on_four_cards(tmp_path, capsys):
    """The cell at 256^3 and 1024^2 on four cards, a rank a card: its first
    two steps against the reference, within the cell's limits."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "volrt_torch").symlink_to(ROOT / "volrt_torch")
    cfg = tmp_path / "portbench" / "configs" / "synth1792-fit.json"
    c = json.loads(cfg.read_text())
    c["volume"]["size"] = 256
    cfg.write_text(json.dumps(c))
    tr = tmp_path / "portbench" / "traffic" / f"{CELL}.json"
    t = json.loads(tr.read_text())
    t.update(viewport=[1024, 1024], warmup_steps=0)
    tr.write_text(json.dumps(t))
    rc, result, err = run_cell(tmp_path, CELL, capsys, seconds=1.0)
    assert rc == 0, err[-20:]
    assert result["correct"] is True, result["checks"]
    assert result["device"]["count"] == 4
    assert not math.isnan(result["metrics"]["train_ray_steps_per_s"]["value"])
