"""The trainer: the program's one-launch L2 step under Adam, as
``volrt_torch.train.fit.fit(fused=True)`` builds it (``make_train_step``
over ``l2_loss_grads_v3_onepass`` in the fast mode, ``make_optimizer``,
``init_state``), stepping back to back over the traffic's views, each
step's loss read back on the host as ``fit`` reads it.

One trainer is built in set-up and runs from its first step to the end of
the window: ``fit`` itself builds a new Adam at each call and runs a fixed
count of steps, so the benchmark composes the pieces it composes.

Inputs, made from the seed on the card: the initial density (the
synthetic volume over 255), the default TF and, for each view, a target:
the reference's render of a second synthetic volume (other noise) under
the default TF. The reference follows the first steps from the same
inputs and works out again the rays, the bf16 copy and the gradients.
"""
from __future__ import annotations

import math
import statistics
import time

import torch
from torch.profiler import record_function

from portbench import reference as ref
from portbench import tracing
from portbench.harness import Window, kernel_counts, reset_peak, sync
from portbench.tracing import Context


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float64)))


def gaps(prog: dict, want: dict) -> dict:
    """The numbers compared: ``loss_gap``, the largest gap of a step's
    loss relative to the reference's; ``grad1_gap`` and ``change_gap``,
    the worst leaf's gap between the norms of the first gradient and of
    the change over the steps compared, each relative to the larger of
    the reference's norm of that leaf and of the median leaf's. The change
    leaves out a leaf whose reference gradient is under a thousandth of
    the median leaf's (it moves by rounding alone)."""
    loss = max(abs(p - w) / abs(w) for p, w in zip(prog["loss"], want["loss"]))
    g_med = statistics.median(want["grad1"])
    c_med = statistics.median(want["change"])
    grad1 = max(abs(p - w) / max(w, g_med)
                for p, w in zip(prog["grad1"], want["grad1"]))
    change = max(abs(p - w) / max(w, c_med)
                 for p, w, g in zip(prog["change"], want["change"],
                                    want["grad1"])
                 if g >= 1e-3 * g_med)
    return {"loss_gap": loss, "grad1_gap": grad1, "change_gap": change}


class Run:
    call = "step"
    gaps = staticmethod(gaps)

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.tr = tr
        if tr["esl"] or tr["shading"] == "diffuse":
            raise NotImplementedError("the reference's training step has "
                                      "no ESL and no diffuse tap")
        t_in = time.time()
        n = cfg["volume"]["size"]
        self.dims = (n, n, n)
        self.ray_step = ref.default_ray_step(self.dims)
        self.phong = tr["shading"] == "phong"
        self.kd = tr["light_kd"] if self.phong else 0.0
        vol = ref.synthetic_volume(n, seed, device,
                                   noise=cfg["volume"]["noise"])
        self.density0 = vol.to(torch.float32) / 255.0
        del vol
        self.tf0 = ref.default_tf_base(device)
        self.views = ref.poses(tr["poses"], tuple(tr["viewport"]))
        self.targets = self._targets()
        sync(device)
        t0 = time.time()
        reset_peak(device)
        self._build_program()
        t1 = time.time()
        self.readings = self._first_steps(tr["check_steps"])
        while self.i < tr["warmup_steps"]:
            self._step()
        sync(device)
        self.parts = {"inputs": t0 - t_in, "program_import": self.t_import - t0,
                      "program_build": t1 - self.t_import,
                      "warmup": time.time() - t1}

    def _targets(self) -> list[torch.Tensor]:
        """A target a view: the reference's f32 render, unshaded, ERT as
        the trainer's, of a synthetic volume of other noise."""
        n = self.dims[0]
        vol = ref.synthetic_volume(n, self.seed, self.device, stream=1,
                                   noise=self.cell.config["volume"]["noise"])
        dens = vol.to(torch.float32) / 255.0
        r = ref.cat_rays([ref.v3_rays(v, self.device) for v in self.views])
        with torch.no_grad():
            img = ref.march_v3(r, dens, ref.premultiply(self.tf0),
                               ray_step=self.ray_step,
                               thr=self.tr["ray_threshold"])
        w, h = self.tr["viewport"]
        return list(img.reshape(len(self.views), h, w, 4).unbind(0))

    def _build_program(self) -> None:
        from volrt_torch.core.types import View
        from volrt_torch.diff.render import DiffScene
        from volrt_torch.renderers.diff_v3 import l2_loss_grads_v3_onepass
        from volrt_torch.train.fit import (init_state, make_optimizer,
                                           make_train_step)

        self.t_import = time.time()
        tr = self.tr
        self.pviews = [View.from_arrays(v["origin"], v["direction"],
                                        v["right"], v["up"], v["light"],
                                        v["dims"], v["perspective"],
                                        self.device) for v in self.views]
        scene = DiffScene(self.density0, self.tf0, self.ray_step)

        def loss_grads_fn(scene, view, target):
            return l2_loss_grads_v3_onepass(
                scene, view, target, ray_threshold=tr["ray_threshold"],
                fast=True, need_dtf=True, need_dvol=True, esl=tr["esl"],
                shaded=tr["shading"] == "diffuse", phong=self.phong,
                light_kd=tr["light_kd"])

        self.state = init_state(scene, make_optimizer(scene, tr["lr"]))
        self.train_step = make_train_step(loss_grads_fn=loss_grads_fn)
        self.i = 0

    def _step(self) -> float:
        v = self.i % len(self.views)
        with record_function("portbench.train_step"):
            self.state, loss = self.train_step(self.state, self.pviews[v],
                                               self.targets[v])
        with record_function("portbench.loss_readback"):
            value = float(loss)
        self.i += 1
        return value

    def _first_steps(self, n: int) -> dict:
        """The program's readings over its first ``n`` steps: each step's
        loss, the norm of each leaf's first gradient as Adam holds it
        after one step (its first moment over ``1 - beta1``), and the norm
        of each leaf's change after ``n`` steps."""
        scene, opt = self.state.scene, self.state.optimizer
        leaves = [scene.density, scene.tf_base]
        start = [self.density0, self.tf0]
        out = {"loss": []}
        for k in range(n):
            out["loss"].append(self._step())
            if k == 0:
                b1 = opt.param_groups[0]["betas"][0]
                out["grad1"] = [norm(opt.state[p]["exp_avg"] / (1 - b1))
                                if p in opt.state else 0.0 for p in leaves]
        out["change"] = [norm(p.detach() - s) for p, s in zip(leaves, start)]
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
        w, h = self.tr["viewport"]
        return Window(self.call, len(times), t1 - t0, times, w * h,
                      int(2.0 / self.ray_step))

    def trace(self, n: int) -> Context:
        enq = []
        for _ in range(n):
            v = self.i % len(self.views)
            t0 = time.perf_counter()
            self.state, loss = self.train_step(self.state, self.pviews[v],
                                               self.targets[v])
            enq.append((time.perf_counter() - t0) * 1e3)
            float(loss)
            self.i += 1
        # The first traced step's inputs, for the samples its launch takes.
        scene = self.state.scene
        self.snap = (self.i % len(self.views),
                     scene.density.detach().clone(),
                     scene.tf_base.detach().clone())
        self.ctx = Context(self.call, tracing.profile_calls(
            lambda i: self._step(), n), enq)
        return self.ctx

    def free(self) -> None:
        del self.state, self.train_step, self.pviews
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def reference_readings(self, rnd=ref.round_bf16, rows: float = 1.0
                           ) -> dict:
        """The reference's readings over the same first steps: the fast
        mode's storage rounding ``rnd``; ``rows`` < 1 keeps that share of
        each view's rays (a fault: part of the batch left out, the mean
        over the rest)."""
        n_steps = self.tr["check_steps"]
        adam = ref.Adam([self.density0, self.tf0], self.tr["lr"])
        out = {"loss": []}
        for k in range(n_steps):
            v = k % len(self.views)
            r = ref.v3_rays(self.views[v], self.device)
            tgt = self.targets[v].reshape(-1, 4)
            if rows < 1.0:
                keep = int(r["o"].shape[0] * rows)
                r = {key: (t[:keep] if t.dim() and key != "light" else t)
                     for key, t in r.items()}
                tgt = tgt[:keep]
            loss, gd, gt = ref.l2_loss_grads(
                adam.params[0], adam.params[1], r, tgt,
                ray_step=self.ray_step, thr=self.tr["ray_threshold"],
                kd=self.kd, phong_on=self.phong, rnd=rnd,
                points=self.tr["reference_points"])
            out["loss"].append(loss)
            if k == 0:
                out["grad1"] = [norm(gd), norm(gt)]
            adam.step([gd, gt])
            del gd, gt
        out["change"] = [norm(p - s) for p, s in
                         zip(adam.params, [self.density0, self.tf0])]
        return out

    def check(self) -> dict:
        limits = self.tr["limits"]
        self.want = self.reference_readings()
        got = gaps(self.readings, self.want)
        if getattr(self, "ctx", None) is not None:
            self._work()
        return {k: (v, limits[k]) for k, v in got.items()}

    def _work(self) -> None:
        """The samples the first traced step's launch took, on its inputs."""
        v, dens, base = self.snap
        counts = ref.Counts(self.device)
        ref.march_v3(ref.v3_rays(self.views[v], self.device),
                     ref.round_bf16(dens), ref.premultiply(base),
                     ray_step=self.ray_step, thr=self.tr["ray_threshold"],
                     kd=self.kd, phong_on=self.phong, fast=ref.round_bf16,
                     counts=counts)
        w, h = self.tr["viewport"]
        voxels = math.prod(self.dims)
        mod = kernel_counts(self.cell.root, self.tr["kernel"])
        self.ctx.work[self.tr["kernel"]] = [
            mod.work(counts.as_dict(), w * h, voxels, 2, self.tr["esl"])]
