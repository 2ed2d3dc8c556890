"""The volume-sharded trainer over four cards: ``fit(volume_sharded=True)``'s
trainer (``train.fit.make_sharded_trainer``: each rank's own Z-slab rows,
Adam on them, the halos refreshed from the neighbours, the slabs marched
by the kernels' slab mode, the opacity scan and the segments' sum over the
process group), one rank a card on NCCL, stepping back to back over the
traffic's views, each step's loss read back on the host as ``fit`` reads
it.

Rank 0 is this process, on the device it is given. Before it starts the
others it imports every piece of the program it needs (and builds the
kernels), so that a program without them fails here, at once, with no
other process started. It then starts ranks 1 .. n-1 itself, each a new
process (the ``spawn`` method) on ``cuda:<rank>`` that calls the same
trainer factory, and steers them through a rendezvous store: every command,
steps included, is one key that rank 0 writes and the others read, so
that every rank takes the same steps in the window and in the traced
passes, and no collective of the benchmark's own enters a step. Every rank
joins with a timeout, each watches the others' process ends, and rank 0
ends the others whenever it leaves: a rank that fails ends the run.

Inputs, made from the seed on each card: a rank's own rows of the initial
density (``reference_vsharded.density_rows``: no card holds the whole
volume for the program), the default TF and, for each view, a target: the
reference's render of a second synthetic volume, its rays split over the
cards and gathered. The check compares the program's first steps with the
reference's unsharded step of the whole volume
(``reference_vsharded.first_steps``), computed on every card once the
program's state is freed. On the CPU the ranks run on ``gloo`` (the
benchmark's tests).
"""
from __future__ import annotations

import datetime
import importlib
import json
import math
import multiprocessing
import multiprocessing.connection
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

from portbench import harness, tracing
from portbench import reference as ref
from portbench import reference_vsharded as rvs
from portbench.harness import Window, kernel_counts, reset_peak, sync
from portbench.tracing import Context

# Seconds a rank waits to join, for a command, or in a collective.
TIMEOUT_S = 300.0
# Seconds rank 0 waits for the other ranks to end, once it has left the
# process group with them.
JOIN_S = 20.0


def gaps(prog: dict, want: dict) -> dict:
    """The numbers compared: ``loss_gap``, the largest gap of a step's
    loss relative to the reference's; ``grad1_gap`` and ``change_gap``,
    the worst leaf's gap between the norms of the first gradient and of
    the change after the first step, each relative to that leaf's own
    reference norm, or to a thousandth of the median leaf's where the
    leaf's is smaller: the few rows at the slab planes are held to their
    own norm, so that a halo fold lost shows. The change leaves out a leaf
    whose reference gradient is under a thousandth of the median leaf's
    (it moves by rounding alone)."""
    loss = max(abs(p - w) / abs(w) for p, w in zip(prog["loss"], want["loss"]))
    out = {"loss_gap": loss}
    g_floor = 1e-3 * statistics.median(want["grad1"])
    for key in ("grad1", "change"):
        floor = 1e-3 * statistics.median(want[key])
        out[key + "_gap"] = max(
            abs(p - w) / max(w, floor, 1e-30)
            for p, w, g in zip(prog[key], want[key], want["grad1"])
            if key == "grad1" or g >= g_floor)
    return out


def _store(port: int, rank: int, size: int):
    return dist.TCPStore("127.0.0.1", port, size, rank == 0,
                         timeout=datetime.timedelta(seconds=TIMEOUT_S),
                         wait_for_workers=False)


class Rank:
    """What every rank runs: its process group, its inputs, its trainer,
    and the reference's share of the check."""

    def __init__(self, cfg: dict, tr: dict, seed: int, rank: int,
                 size: int, device: torch.device, init_method: str):
        from volrt_torch.core.types import View
        from volrt_torch.dist.mesh import init_distributed, make_mesh
        from volrt_torch.train.fit import make_sharded_trainer

        if tr["esl"] or tr["shading"] is not None:
            raise NotImplementedError("the sharded reference is unshaded, "
                                      "without ESL")
        self.tr, self.seed, self.rank, self.size = tr, seed, rank, size
        self.device = device
        t0 = time.time()
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init_distributed("nccl" if device.type == "cuda" else "gloo",
                         rank=rank, world_size=size, init_method=init_method,
                         timeout=TIMEOUT_S)
        self.mesh = make_mesh(device)
        t1 = time.time()
        n = cfg["volume"]["size"]
        self.n, self.noise = n, cfg["volume"]["noise"]
        self.sd = rvs.slab_depth(n, size)
        self.z0 = rank * self.sd
        self.leaves = rvs.leaf_rows(n, size)
        self.ray_step = ref.default_ray_step((n, n, n))
        self.views = ref.poses(tr["poses"], tuple(tr["viewport"]))
        self.tf0 = ref.default_tf_base(device)
        second = rvs.density_rows(n, 0, n, seed, device, stream=1,
                                  noise=self.noise)
        self.targets = rvs.render(second, self.tf0, self.views,
                                  ray_step=self.ray_step,
                                  thr=tr["ray_threshold"], rank=rank,
                                  size=size)
        del second
        if device.type == "cuda":
            torch.cuda.empty_cache()
        own = self._own_rows()
        sync(device)
        t2 = time.time()
        reset_peak(device)
        self.pviews = [View.from_arrays(v["origin"], v["direction"],
                                        v["right"], v["up"], v["light"],
                                        v["dims"], v["perspective"],
                                        device) for v in self.views]
        self.state, self.train_step = make_sharded_trainer(
            own, n, self.tf0, self.ray_step, self.mesh, lr=tr["lr"])
        del own
        self.i = 0
        self.snap = None
        self.prof = None
        sync(device)
        self.parts = {"join": t1 - t0, "inputs": t2 - t1,
                      "program_build": time.time() - t2}

    def _own_rows(self) -> torch.Tensor:
        return rvs.density_rows(self.n, self.z0, self.z0 + self.sd,
                                self.seed, self.device, noise=self.noise)

    def step(self, timed: bool = False):
        """One training step on the next view; its loss read back. With
        ``timed``, ``(loss, ms to enqueue the step)``."""
        v = self.i % len(self.views)
        if not timed:
            self.state, loss = self.train_step(self.state, self.pviews[v],
                                               self.targets[v])
            self.i += 1
            return float(loss)
        t0 = time.perf_counter()
        self.state, loss = self.train_step(self.state, self.pviews[v],
                                           self.targets[v])
        t1 = time.perf_counter()
        self.i += 1
        return float(loss), (t1 - t0) * 1e3

    def steps(self, n: int) -> None:
        for _ in range(n):
            self.step()

    def first_steps(self, n: int) -> dict:
        """The program's readings of its first ``n`` steps, this rank's
        share: each step's loss, and the squared norms, over this rank's
        rows of each leaf (``reference_vsharded.leaf_rows``) and over the
        TF, of the first gradient as Adam holds it (its first moment over
        ``1 - beta1``) and of the change after the first step."""
        scene, opt = self.state.scene, self.state.optimizer
        out = {"loss": []}
        for k in range(n):
            out["loss"].append(self.step())
            if k:
                continue
            b1 = opt.param_groups[0]["betas"][0]
            grads = [opt.state[p]["exp_avg"] / (1 - b1) if p in opt.state
                     else torch.zeros_like(p)
                     for p in (scene.density, scene.tf_base)]
            out["grad1"] = self._squares(grads[0], grads[1])
            del grads
            out["change"] = self._squares(
                scene.density.detach() - self._own_rows(),
                scene.tf_base.detach() - self.tf0)
        return out

    def _squares(self, rows: torch.Tensor, tf: torch.Tensor) -> list:
        return rvs.sq_norms_at(rows, self.z0, self.leaves) + [
            float(torch.linalg.vector_norm(tf.to(torch.float64)) ** 2)]

    def trace_steps(self, n: int) -> list[float]:
        """``n`` steps, each one's ms to enqueue; then the state the next
        step (the first traced) starts from is kept for its samples."""
        enq = [self.step(timed=True)[1] for _ in range(n)]
        scene = self.state.scene
        self.snap = (self.i % len(self.views),
                     scene.density.detach().clone(),
                     scene.tf_base.detach().clone())
        return enq

    def prof_on(self) -> None:
        """Profile this rank's device (the other ranks, on a card) while
        rank 0 traces its window."""
        if self.rank == 0 or self.device.type != "cuda":
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.prof_t0 = time.perf_counter()

    def prof_off(self) -> dict | None:
        """This rank's device busy and window seconds over its profile."""
        if self.prof is None:
            return None
        torch.cuda.synchronize()
        span = time.perf_counter() - self.prof_t0
        self.prof.__exit__(None, None, None)
        dev = [(float(e.time_range.start), float(e.time_range.end), e.name)
               for e in self.prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        self.prof = None
        if not dev:
            return None
        w0 = min(d[0] for d in dev)
        t = tracing.reduce_device(dev, w0, w0 + span * 1e6)
        return {"busy_s": t.busy_s, "window_s": t.window_s}

    def free(self) -> None:
        del self.state, self.train_step, self.pviews
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, rnd: str | None = None, fault: str | None = None
                  ) -> dict:
        """The reference's readings of the first two steps
        (``reference_vsharded.first_steps``), every rank a share of the
        rays: ``rnd="bf16"`` is the control."""
        density = rvs.density_rows(self.n, 0, self.n, self.seed,
                                   self.device, noise=self.noise)
        out = rvs.first_steps(
            density, self.tf0, self.views[:2], self.targets[:2],
            ray_step=self.ray_step, thr=self.tr["ray_threshold"],
            lr=self.tr["lr"], n_slabs=self.size,
            points=self.tr["reference_points"], rank=self.rank,
            size=self.size, rnd=ref.round_bf16 if rnd == "bf16" else None,
            fault=fault)
        del density
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def counts(self) -> dict:
        """The samples rank 0's slab took in the first traced step, on its
        inputs: the whole density at that step, made of every rank's rows
        (one broadcast a rank)."""
        v, own, base = self.snap
        full = torch.empty((self.n, self.n, self.n), dtype=torch.float32,
                           device=self.device)
        full[self.z0:self.z0 + self.sd] = own
        del own, self.snap
        for r in range(self.size):
            part = full[r * self.sd:(r + 1) * self.sd]
            if self.size > 1:
                dist.broadcast(part, src=r)
        out = rvs.slab_samples(full, base, self.views[v], self.targets[v],
                               ray_step=self.ray_step,
                               thr=self.tr["ray_threshold"], z_start=0,
                               slab_d=self.sd,
                               points=self.tr["reference_points"],
                               rank=self.rank, size=self.size)
        del full
        return out

    def forbidden(self) -> list[str]:
        return harness.forbidden_modules()

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def _leave_with_parent() -> None:
    """End this process when the process that started it ends."""
    parent = multiprocessing.parent_process()
    if parent is None:
        return

    def watch():
        multiprocessing.connection.wait([parent.sentinel])
        os._exit(3)

    threading.Thread(target=watch, daemon=True).start()


def worker(rank: int, size: int, cfg: dict, tr: dict, seed: int,
           device: str, init_method: str, port: int) -> None:
    """Rank ``rank``'s process: build its :class:`Rank`, then run rank 0's
    commands, one key of the store each, until ``exit``; a result goes
    back under ``res/<command>/<rank>``. A failure is written under
    ``error/<rank>`` and ends the process with 1. At ``exit`` the rank
    leaves the process group, at the time rank 0 leaves it, and ends at
    once."""
    _leave_with_parent()
    torch.set_num_threads(1)
    store = _store(port, rank, size)
    r = None
    try:
        r = Rank(cfg, tr, seed, rank, size, torch.device(device),
                 init_method)
        k = 0
        while True:
            op, args, report = json.loads(store.get(f"cmd/{k}"))
            if op == "exit":
                break
            res = getattr(r, op)(*args)
            if report:
                store.set(f"res/{k}/{rank}", json.dumps(res))
            k += 1
        r.close()
    except BaseException:
        text = traceback.format_exc()
        print(f"rank {rank} of {size} failed:\n{text}", file=sys.stderr,
              flush=True)
        store.set(f"error/{rank}", text)
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


class Run:
    call = "step"
    gaps = staticmethod(gaps)

    def __init__(self, cell, seed: int, device):
        # The program first: a program without these fails here.
        t_in = time.time()
        import volrt_torch.dist.volume_sharded  # noqa: F401
        import volrt_torch.train.fit  # noqa: F401
        from volrt_torch.dist.mesh import init_distributed  # noqa: F401
        from volrt_torch.train.fit import make_sharded_trainer  # noqa: F401

        t_import = time.time()
        if device.type == "cuda":
            from volrt_torch import _build

            _build.load()
        self.cell, self.seed, self.device = cell, seed, device
        self.tr = tr = cell.traffic
        self.size = size = cell.workload["chips"]
        self.k = 0
        self.procs, self.tmp = [], None
        self.ending = self.closed = False
        t0 = time.time()
        self.store = _store(0, 0, size)
        self.tmp = tempfile.mkdtemp(prefix="portbench-vsharded-")
        init = "file://" + os.path.join(self.tmp, "rendezvous")
        ctx = multiprocessing.get_context("spawn")
        entry = importlib.import_module("portbench.drivers.fit_sharded")
        for r in range(1, size):
            dev = f"cuda:{r}" if device.type == "cuda" else "cpu"
            p = ctx.Process(target=entry.worker, daemon=True,
                            args=(r, size, cell.config, tr, seed, dev, init,
                                  self.store.port))
            p.start()
            self.procs.append(p)
        threading.Thread(target=self._watch, args=(self.store.port,),
                         daemon=True).start()
        t1 = time.time()
        try:
            self.rank = Rank(cell.config, tr, seed, 0, size, device, init)
            t2 = time.time()
            self.readings = self._first_steps(tr["check_steps"])
            self._all("steps", tr["warmup_steps"])
            sync(device)
        except BaseException:
            self.close()
            raise
        w, h = tr["viewport"]
        self.n_rays, self.ray_steps = w * h, int(2.0 / self.rank.ray_step)
        self.parts = {"program_import": t_import - t_in,
                      "kernels": t0 - t_import, "spawn": t1 - t0,
                      **self.rank.parts, "warmup": time.time() - t2}

    # ------------------------------------------------------------ ranks

    def _watch(self, port: int) -> None:
        """End the run when another rank has ended before it was told to:
        its error on standard error, the others ended, exit code 1. (A
        store connection of its own: the main thread's may be waiting.)"""
        store = None
        while not self.ending:
            for r, p in enumerate(self.procs, start=1):
                if p.exitcode is not None and not self.ending:
                    store = store or _store(port, r, self.size)
                    err = ""
                    if store.check([f"error/{r}"]):
                        err = store.get(f"error/{r}").decode()
                    print(f"rank {r} ended with {p.exitcode} before the "
                          f"run's end:\n{err}", file=sys.stderr, flush=True)
                    self._end_procs()
                    sys.stdout.flush()
                    os._exit(1)
            time.sleep(0.2)

    def _end_procs(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()

    def _all(self, op: str, *args, gather: bool = False):
        """Run ``op`` on every rank -> this rank's result; with ``gather``
        every rank's, in rank order."""
        self.store.set(f"cmd/{self.k}", json.dumps([op, list(args), gather]))
        mine = getattr(self.rank, op)(*args)
        k, self.k = self.k, self.k + 1
        if not gather:
            return mine
        return [mine] + [json.loads(self.store.get(f"res/{k}/{r}"))
                         for r in range(1, self.size)]

    def close(self) -> None:
        """Tell the other ranks to end and wait for them (then end them);
        leave the process group."""
        if self.closed:
            return
        self.ending = True
        try:
            rank = getattr(self, "rank", None)
            if self.procs and all(p.is_alive() for p in self.procs):
                self.store.set(f"cmd/{self.k}",
                               json.dumps(["exit", [], False]))
                if rank is not None:
                    # Every rank leaves the group at once: NCCL's teardown
                    # may wait for the others.
                    rank.close()
            deadline = time.monotonic() + JOIN_S
            for p in self.procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            self.closed = True
            self._end_procs()
            if self.tmp:
                shutil.rmtree(self.tmp, ignore_errors=True)

    # ------------------------------------------------------------ steps

    def _step(self) -> float:
        self.store.set(f"cmd/{self.k}", json.dumps(["step", [], False]))
        self.k += 1
        return self.rank.step()

    def _first_steps(self, n: int) -> dict:
        """The program's readings over its first ``n`` steps: each step's
        loss, and the norm of each leaf's first gradient and change after
        the first step, from the ranks' squares."""
        every = self._all("first_steps", n, gather=True)
        out = {"loss": every[0]["loss"]}
        for key in ("grad1", "change"):
            sq = [sum(e[key][i] for e in every)
                  for i in range(len(every[0][key]) - 1)]
            out[key] = [math.sqrt(s) for s in sq] + [
                math.sqrt(every[0][key][-1])]
        return out

    def window(self, seconds: float) -> Window:
        sync(self.device)
        t0 = time.perf_counter()
        t_end = t0 + seconds
        t1, times = t0, []
        while t1 < t_end:
            self._step()
            t2 = time.perf_counter()
            times.append(t2 - t1)
            t1 = t2
        return Window(self.call, len(times), t1 - t0, times, self.n_rays,
                      self.ray_steps)

    def trace(self, n: int) -> Context:
        enq = self._all("trace_steps", n)
        self._all("prof_on")
        trace = tracing.profile_calls(lambda i: self._step(), n)
        others = self._all("prof_off", gather=True)[1:]
        self.ctx = Context(self.call, trace, enq)
        busy = [{"busy_s": trace.busy_s, "window_s": trace.window_s}]
        for r, b in enumerate(busy + others):
            if b:
                print(f"rank {r} device busy {b['busy_s']:.6f} s of "
                      f"{b['window_s']:.6f} s", file=sys.stderr)
        return self.ctx

    def free(self) -> None:
        self._all("free")

    # ------------------------------------------------------------ check

    def reference_readings(self, rnd: str | None = None,
                           fault: str | None = None) -> dict:
        return self._all("reference", rnd, fault)

    def check(self, controls=()) -> dict:
        """The program's first steps against the reference's, each gap
        beside its limit. ``controls`` names readings of the reference put
        in the program's place, ``"control"`` (the density stored in
        bf16) or a fault of ``reference_vsharded.FAULTS``, whose gaps go
        to :attr:`calibration`. Ends the other ranks."""
        try:
            limits = self.tr["limits"]
            self.want = self.reference_readings()
            got = gaps(self.readings, self.want)
            print("readings (leaves: the slabs, the plane rows, the TF) "
                  + json.dumps({"program": self.readings,
                                "reference": self.want}), file=sys.stderr)
            self.calibration = {
                kind: gaps(self.reference_readings(rnd="bf16")
                           if kind == "control" else
                           self.reference_readings(fault=kind), self.want)
                for kind in controls}
            if getattr(self, "ctx", None) is not None:
                self._work()
            found = sorted({m for ms in self._all("forbidden",
                                                  gather=True)[1:]
                            for m in ms})
        finally:
            self.close()
        if found:
            print(f"modules of JAX or the JAX package are loaded on another "
                  f"rank: {found}", file=sys.stderr)
            raise SystemExit(3)
        return {k: (v, limits[k]) for k, v in got.items()}

    def _work(self) -> None:
        """The operations and bytes of rank 0's slab launches in the first
        traced step, from the samples the reference counts."""
        counts = self._all("counts")
        w, h = self.tr["viewport"]
        n = self.rank.n
        slab_voxels = (self.rank.sd + 2) * n * n
        mod = kernel_counts(self.cell.root, self.tr["kernel"])
        self.ctx.work[self.tr["kernel"]] = mod.launches(counts, w * h,
                                                        slab_voxels)
