"""The process group that the sharded paths run over (the counterpart of
``volrt/dist/mesh.py``).

``volrt``'s mesh is a 1-D ``jax.sharding.Mesh`` over the devices of one
process, axis ``"rays"``; its counterpart here is a ``torch.distributed``
process group with one rank a process. :class:`Mesh` holds the group, the
rank, the world size and the rank's device, and carries the only two
collectives the port uses, ``all_gather`` and ``all_reduce``: no
point-to-point, so that one code runs on NCCL with a rank a card, and on
``gloo`` for the CPU tests and for ranks that share one card (NCCL refuses
two ranks on one card). ``gloo`` carries CUDA tensors in both collectives
as they are (checked on an H100: ``PERF.md`` section 3), so the mesh
copies nothing through the host itself. The caller picks the backend;
nothing picks it for it. A mesh of one rank needs no process group at
all.

Three ways to a group: ``torchrun`` (``init_distributed()`` reads its
environment), an explicit ``init_distributed(rank=, world_size=,
init_method=)``, or :func:`spawn`, which starts N local ranks itself; under
NCCL a spawned rank ``r`` takes ``cuda:r``, as ``torchrun``'s would.

Each collective is a device stage of the program's tracing
(``utils/trace.py``, span ``collective``, its work the bytes this rank
sends), so that a step's collectives and their bytes can be read from the
records; under NCCL a collective's stream time holds the wait for the
slowest rank.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import tempfile
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from volrt_torch.core.device import resolve_device
from volrt_torch.utils import trace

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D mesh: its process ``group`` (None for a
    mesh of one rank with no process group), its ``rank`` and the world
    ``size`` within that group, and its ``device``.

    Ranks are in mesh order: rank ``r`` renders band ``r`` of the image
    rows (``dist/render.py``) or holds Z-slab ``r`` of the volume
    (``dist/volume_sharded.py``)."""

    group: object
    rank: int
    size: int
    device: torch.device

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of every rank, stacked in rank order -> ``(size, *t.shape)``
        on ``t``'s device; no gradient flows."""
        src = t.detach().contiguous()
        if self.size == 1:
            return src[None].clone()
        with trace.span("collective", device=src.device,
                        bytes=src.numel() * src.element_size()):
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            return torch.stack(parts)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` (``"sum"`` or ``"max"``) of ``t`` over the
        ranks -> a new tensor on ``t``'s device; no gradient flows."""
        out = t.detach().clone().contiguous()
        if self.size > 1:
            red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
            with trace.span("collective", device=out.device,
                            bytes=out.numel() * out.element_size()):
                dist.all_reduce(out, op=red, group=self.group)
        return out

    def barrier(self) -> None:
        """Wait for every rank (an ``all_reduce`` of one number)."""
        self.all_reduce(torch.zeros(1, device=self.device))


def init_distributed(backend: str = "gloo", rank: int | None = None,
                     world_size: int | None = None,
                     init_method: str | None = None,
                     timeout: float | None = None) -> None:
    """Join the process group, once per process. With no ``rank`` the
    ranks' places come from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``); otherwise give
    ``rank``, ``world_size`` and ``init_method`` (``tcp://localhost:PORT``
    or ``file://PATH``) yourself: nothing on a card's machine tells a
    program of a cluster. ``backend`` is ``"gloo"`` or ``"nccl"``.
    ``timeout`` (seconds; torch's default where None) bounds the wait to
    join and each collective's wait for the other ranks, so that a rank
    that has failed does not leave the others waiting for ever."""
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    if rank is None:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                **kw)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size, **kw)


def make_mesh(device=None, group=None) -> Mesh:
    """This rank's :class:`Mesh` over ``group`` (the default group, or a
    mesh of one rank when no process group is up) on ``device``: by default
    ``cuda:LOCAL_RANK`` under ``torchrun`` and for a rank that
    :func:`spawn` started on NCCL (a card a rank), else ``cuda:0`` (``gloo``
    ranks spawned here share it); the tests pass ``"cpu"``."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    if group is None and not dist.is_initialized():
        return Mesh(None, 0, 1, resolve_device(device))
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                resolve_device(device))


def sub_mesh(mesh: Mesh, ranks: list[int]) -> Mesh | None:
    """A mesh over the given ranks of ``mesh``'s world (every rank must
    call it, as ``torch.distributed.new_group`` needs), or None on a rank
    outside them."""
    group = dist.new_group(ranks)
    if mesh.rank not in ranks:
        return None
    return Mesh(group, ranks.index(mesh.rank), len(ranks), mesh.device)


def spawned_rank_env(rank: int, backend: str) -> dict[str, str]:
    """What a rank that :func:`spawn` starts adds to its environment: under
    NCCL ``LOCAL_RANK``, so that :func:`make_mesh` puts rank ``r`` on
    ``cuda:r`` (NCCL refuses two ranks on one card); under ``gloo``
    nothing, so the ranks keep the caller's device and may share a card."""
    return {"LOCAL_RANK": str(rank)} if backend == "nccl" else {}


def _rank_main(rank: int, fn: Callable, size: int, backend: str,
               init: str, args: tuple) -> None:
    os.environ.update(spawned_rank_env(rank, backend))
    if backend == "nccl":
        torch.cuda.set_device(rank)
    init_distributed(backend, rank=rank, world_size=size, init_method=init)
    try:
        fn(rank, size, *args)
    except BaseException:
        # The launcher reports one rank's failure; the others' show here.
        print(f"rank {rank} of {size} failed:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, backend: str = "gloo") -> None:
    """Run ``fn(rank, size, *args)`` in ``nprocs`` new local processes, each
    a rank of one process group (``file://`` rendezvous in a new temporary
    directory), and wait for them. ``fn`` and its arguments must be
    importable and picklable: the processes are started with the ``spawn``
    method, never by a fork after CUDA is up. Under NCCL rank ``r`` runs on
    ``cuda:r`` (:func:`spawned_rank_env`). A rank that fails fails the call
    (``torch.multiprocessing.ProcessRaisedException``), and prints its own
    traceback; the other ranks are ended then, wherever they wait."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(fn, nprocs, backend, init,
                                             args),
                           nprocs=nprocs, join=True, start_method="spawn")
