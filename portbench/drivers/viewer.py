"""The viewer: one client renders the traffic's poses in turn, each frame
through the program's renderer ladder (``get_renderer(r).render_float``,
and for uint8 output ``sampling.write_color``) and synchronised on the card
before the next is asked for (a closed loop).

Inputs, made from the seed on the card: the synthetic volume, the default
TF and the poses (view vectors). The program derives the rest (the f32
density or raw volume, the ESL tables, the rays); the reference works them
out again. A frame kept from the window for each pose (drawn from the
seed) is compared with the reference's frame of that pose.
"""
from __future__ import annotations

import random
import time

import torch
from torch.profiler import record_function

from portbench import reference as ref
from portbench import tracing
from portbench.harness import Window, kernel_counts, reset_peak, sync
from portbench.tracing import Context


class Run:
    call = "frame"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.tr = tr
        t_in = time.time()
        n = cfg["volume"]["size"]
        self.dims = (n, n, n)
        self.vol = ref.synthetic_volume(n, seed, device,
                                        noise=cfg["volume"]["noise"])
        self.tf_base = ref.default_tf_base(device)
        self.ray_step = ref.default_ray_step(self.dims)
        self.views = ref.poses(tr["poses"], tuple(tr["viewport"]))
        self.kept, self.seen = {}, {}
        self.pick = random.Random(seed)
        sync(device)
        t0 = time.time()
        reset_peak(device)
        self._build_program()
        t1 = time.time()
        for _ in range(tr["warmup_cycles"]):
            for p in range(len(self.views)):
                self._frame(p)
        sync(device)
        self.parts = {"inputs": t0 - t_in, "program_import": self.t_import - t0,
                      "program_build": t1 - self.t_import,
                      "warmup": time.time() - t1}

    def _build_program(self) -> None:
        from volrt_torch.core import sampling
        from volrt_torch.core.types import View, Volume, make_raycaster
        from volrt_torch.renderers import get_renderer

        self.t_import = time.time()
        tr = self.tr
        w, h, d = self.dims
        volume = Volume(data=self.vol, dims=(w, h, d))
        views = [View.from_arrays(v["origin"], v["direction"], v["right"],
                                  v["up"], v["light"], v["dims"],
                                  v["perspective"], self.device)
                 for v in self.views]
        rc = make_raycaster(
            volume, views[0], self.tf_base, ray_step=self.ray_step,
            ray_threshold=tr["ray_threshold"], esl=tr["esl"],
            light_kd=tr["light_kd"], interpolation="trilinear",
            shading=tr["shading"])
        self.rcs = [rc.replace(view=v) for v in views]
        render_float = get_renderer(tr["renderer"]).render_float
        if tr["output"] == "uint8":
            def frame(rc):
                with record_function("portbench.render_float"):
                    img = render_float(rc)[0]
                with record_function("portbench.write_color"):
                    return sampling.write_color(img)
        else:
            def frame(rc):
                with record_function("portbench.render_float"):
                    return render_float(rc)[0]
        self.render = frame

    def _frame(self, p: int) -> torch.Tensor:
        img = self.render(self.rcs[p])
        with record_function("portbench.sync"):
            sync(self.device)
        return img

    def _keep(self, p: int, img: torch.Tensor) -> None:
        """Keep one frame of each pose, each frame of it as likely."""
        self.seen[p] = self.seen.get(p, 0) + 1
        if self.pick.random() * self.seen[p] < 1.0:
            self.kept[p] = img

    def window(self, seconds: float) -> Window:
        n_poses = len(self.views)
        times = []
        sync(self.device)
        t0 = time.perf_counter()
        t_end = t0 + seconds
        t1 = t0
        i = 0
        while t1 < t_end:
            p = i % n_poses
            img = self._frame(p)
            t2 = time.perf_counter()
            times.append(t2 - t1)
            self._keep(p, img)
            i += 1
            t1 = time.perf_counter()
        w, h = self.tr["viewport"]
        return Window(self.call, len(times), t2 - t0, times, w * h,
                      int(2.0 / self.ray_step))

    def trace(self, n: int) -> Context:
        n_poses = len(self.views)
        enq = []
        for i in range(n):
            p = i % n_poses
            t0 = time.perf_counter()
            img = self.render(self.rcs[p])
            enq.append((time.perf_counter() - t0) * 1e3)
            sync(self.device)
            self._keep(p, img)

        def call(i):
            self._keep(i % n_poses, self._frame(i % n_poses))

        ctx = Context(self.call, tracing.profile_calls(call, n), enq)
        self.traced = [i % n_poses for i in range(n)]
        self.ctx = ctx
        return ctx

    def free(self) -> None:
        del self.rcs, self.render
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def ref_frames(self, poses: list[int], dtype=torch.float32,
                   counts=None) -> dict:
        """The reference's frames of ``poses``, their rays marched as one
        set; ``counts`` gathers the samples they take."""
        tr = self.tr
        views = [self.views[p] for p in poses]
        tf32 = ref.premultiply(self.tf_base)
        tf = tf32.to(dtype)
        if tr["renderer"] == 5:
            if tr["shading"] != "phong" and tr["light_kd"] > ref.SHADE_KD_GATE:
                raise NotImplementedError("the reference's rung 5 shades "
                                          "with phong or not at all")
            r = ref.cat_rays([ref.v3_rays(v, self.device, dtype)
                              for v in views])
            dens = (self.vol.to(torch.float32) / 255.0).to(dtype)
            esl = ref.esl_empty(self.vol, tf32) if tr["esl"] else None
            img = ref.march_v3(r, dens, tf, ray_step=self.ray_step,
                               thr=tr["ray_threshold"], kd=tr["light_kd"],
                               phong_on=tr["shading"] == "phong", esl=esl,
                               counts=counts)
        elif tr["renderer"] == 3:
            r = ref.cat_rays([ref.rays(v, self.device, dtype) for v in views])
            r = ref.ladder_start(r, self.vol, tf, self.ray_step, tr["esl"])
            kd = tr["light_kd"] if tr["shading"] == "diffuse" else 0.0
            img = ref.march_ladder(r, self.vol.to(dtype), tf,
                                   ray_step=self.ray_step,
                                   thr=tr["ray_threshold"], kd=kd,
                                   counts=counts)
        else:
            raise NotImplementedError(f"no reference of rung {tr['renderer']}")
        w, h = tr["viewport"]
        img = img.reshape(len(poses), h, w, 4)
        if tr["output"] == "uint8":
            img = ref.write_color(img)
        return dict(zip(poses, img.unbind(0)))

    def check_poses(self) -> list[int]:
        """The poses whose kept frames are compared: a sample of
        ``check_frames`` drawn from the seed; every pose in a traced run,
        whose roofline needs each pose's samples."""
        rendered = sorted(self.kept)
        if getattr(self, "traced", None):
            return rendered
        k = min(self.tr["check_frames"], len(rendered))
        return sorted(random.Random(self.seed).sample(rendered, k))

    def frame_gaps(self, frames: dict, refs: dict) -> dict:
        """``max_abs`` and ``mean_abs`` of frames against the reference's,
        in the frames' units (levels of 255 for uint8)."""
        mx, mean = 0.0, 0.0
        for p, img in frames.items():
            diff = (img.to(torch.float64) - refs[p].to(torch.float64)).abs()
            mx = max(mx, float(diff.max()))
            mean += float(diff.mean()) / len(frames)
        return {"max_abs": mx, "mean_abs": mean}

    def check(self) -> dict:
        """The numbers compared, each with its limit."""
        limits = self.tr["limits"]
        poses = self.check_poses()
        if getattr(self, "traced", None):
            counts = {p: ref.Counts(self.device) for p in poses}
            self.refs = {}
            for p in poses:
                self.refs.update(self.ref_frames([p], counts=counts[p]))
            self._work({p: counts[p].as_dict() for p in poses})
        else:
            self.refs = self.ref_frames(poses)
        got = self.frame_gaps({p: self.kept[p] for p in poses}, self.refs)
        return {k: (v, limits[k]) for k, v in got.items()}

    def _work(self, counts: dict) -> None:
        kernel = self.tr["kernel"]
        mod = kernel_counts(self.cell.root, kernel)
        w, h = self.tr["viewport"]
        voxels = self.dims[0] * self.dims[1] * self.dims[2]
        self.ctx.work[kernel] = [
            mod.work(counts[p], w * h, voxels, 4, self.tr["esl"])
            for p in self.traced]
