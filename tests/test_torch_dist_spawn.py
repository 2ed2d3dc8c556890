"""Where ``dist/mesh.py:spawn`` puts its ranks, and that a rank that fails
ends the call: on the CPU, with no JAX."""
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from volrt_torch.dist import mesh as mesh_mod

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("backend,caller,want", [
    ("nccl", None, [f"cuda:{r}" for r in range(4)]),
    ("nccl", "3", [f"cuda:{r}" for r in range(4)]),
    ("gloo", None, ["cuda:0"] * 4),
    ("gloo", "2", ["cuda:2"] * 4),
])
def test_the_device_of_a_spawned_rank(monkeypatch, backend, caller, want):
    """Under NCCL a spawned rank ``r`` takes ``cuda:r`` (NCCL refuses two
    ranks on one card), whatever the caller's ``LOCAL_RANK``; under
    ``gloo`` the ranks keep the caller's device (``cuda:LOCAL_RANK``,
    ``cuda:0`` without one) and may share it. ``make_mesh`` with no
    process group up and no device named, as a rank of ``cli fit --dist``
    calls it."""
    got = []
    for rank in range(4):
        if caller is None:
            monkeypatch.delenv("LOCAL_RANK", raising=False)
        else:
            monkeypatch.setenv("LOCAL_RANK", caller)
        for key, value in mesh_mod.spawned_rank_env(rank, backend).items():
            monkeypatch.setenv(key, value)
        got.append(mesh_mod.make_mesh().device)
    assert got == [torch.device(d) for d in want]


def test_a_rank_that_raises_ends_spawn():
    """Two ``gloo`` ranks on the CPU: rank 1 raises at once while rank 0
    waits for it in a collective. ``spawn`` raises, naming the failure,
    within the test's own limit of 120 s (the process group's timeout,
    torch's default, is far longer), and no rank is left."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from volrt_torch.dist import mesh\n"
            "from tests import torch_dist_world as w\n"
            "mesh.spawn(w.raise_on_rank_one, 2)\n" % str(ROOT))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, process_group=0)
    try:
        _, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("spawn hung after a rank failed")
    assert proc.returncode != 0
    assert "rank 1 fails on purpose" in err
    assert _in_group(proc.pid) == []


def _in_group(pgid: int) -> list[int]:
    """The processes of process group ``pgid`` still running (``/proc``)."""
    found = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            fields = (entry / "stat").read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            found.append(int(entry.name))
    return found
