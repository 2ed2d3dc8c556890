"""Frame profiler: per-(config, renderer) timing statistics (the
counterpart of ``volrt/utils/profiler.py``).

Rebuilds the reference ``Profiler`` (reference: Profiler.cpp:19-114) on the
card: :meth:`Profiler.start` and :meth:`Profiler.stop` each wait for the
card (``torch.cuda.synchronize``) before they read the clock, so a sample
is the wall time from the card's last completion to the timed work's, as
the reference's ``cudaEventSynchronize`` has it (Profiler.cpp:64-66), not
the host's enqueue. The stats keep the reference's shape, {samples, sum,
max} per (config, renderer), with derived rays/s and rays*steps/s and a
ring of recent frame times (Profiler.cpp:73-74).

Beside the times, a roofline table (:meth:`Profiler.print_roofline`): the
least time the card could take for the nominal full march of a cell
(every ray, ``int(2 / ray_step)`` samples, ERT off), over the time
measured. It is not a utilization: ERT and ESL prune real work below the
nominal march, so a value above 1 means they did. The least time is the
one ``chip_smoke.py`` sets beside each kernel (:func:`bound`): the bytes
that must move over the card's memory rate, or the f32 operations a
sample, counted by hand from ``csrc/march_common.cuh``, over its f32 rate,
whichever is longer.

``volrt``'s MFU (``print_mfu``, ``mfu``, ``chip_peak_flops``,
``windowed_kernel_flops``) counts one-hot matrix-unit FLOPs against a TPU's
peak; the card's kernels do no such products, and it is not ported.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

MIN_SAMPLE_STAT = 8  # reference: Profiler.h:12
RING_SIZE = 300      # reference: Profiler.h graph ring

# Published peaks of one H100 SXM at its full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 operations per composited sample, counted by hand from
# csrc/march_common.cuh. Forward: the position 8, three axes' taps 15, seven
# lerps of the trilinear sample 28, the TF coordinate and its lerps 20, the
# composite 9. Replay: the forward without its three colour composites 74,
# the cotangent chain 20, the TF rows' weights and adds 17, the TF slope
# and the eight voxels' weights and adds 35.
FLOPS_FWD = 80
FLOPS_BWD = 146
# The ladder (raw units). Trilinear: the position and the next k 7, the taps
# 15, the seven lerps 28, the division by 255 1, the TF coordinate and its
# lerps 20, the composite 9. Nearest: the position and the next k 7, three
# axes' indices 9, the composite 9.
FLOPS_TRI = 80
FLOPS_NEAREST = 25
# Round 1 (a density). Forward: the ladder's trilinear sample without the
# division. Replay: that without its three colour composites 73, and the
# cotangent chain, TF rows, slope and voxels as above 72.
FLOPS_ROUND1_FWD = 79
FLOPS_ROUND1_BWD = 145
# Phong's f32 operations a gated sample, counted by hand from
# csrc/march_common.cuh (shade_phong, phong_chain), on top of FLOPS_FWD /
# FLOPS_BWD. Forward: the six shifted axes 48 (two clips, the shift, the
# floor and the weight), six trilinear samples 168 and their differences
# 3, the normal's and the light's and the half vector's norms and
# directions 36, the two dots 13, the powers 4, the specular, lit and
# colour 10. Replay: the forward's again, the chain 54 (drgb, dlit, the
# masks, dnh, the powers, dc, dn, dn.g, dg), the six cells' weights and
# adds 168.
FLOPS_PHONG_FWD = 282
FLOPS_PHONG_BWD = 504
# ESL. A skipped sample's f32 operations: the position 6 and the three
# axes' voxel coordinates 9 (the block test is integer work). A round of
# the leap kernel that leaps: the position 6, the voxel indices 9, the
# three faces 12, their minimum and clamp 3, the face's and the ball's
# whole steps 8, the larger and the two adds 3.
FLOPS_ESL_SKIP = 15
FLOPS_LEAP = 41


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``ops`` f32
    operations: ``{"bound_ms", "bound_by": "bytes" | "operations"}``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nominal_bound_ms(n_rays: int, n_steps: int, volume_bytes: int,
                     flops_per_sample: int, grad_bytes: int = 0) -> float:
    """The least time of a nominal full march: ``n_rays`` rays of
    ``n_steps`` samples each at ``flops_per_sample``, the volume
    (``volume_bytes``) read once and an RGBA f32 image written; for a
    training step (``grad_bytes`` > 0, the gradients' size) also the
    target read and the gradients zero-filled and written."""
    nbytes = volume_bytes + n_rays * 16
    if grad_bytes:
        nbytes += n_rays * 16 + 2 * grad_bytes
    return bound(nbytes, n_rays * n_steps * flops_per_sample)["bound_ms"]


def _sync() -> None:
    """Wait for the card, where this process uses one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class _Stat:
    samples: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0

    def add(self, ms: float) -> None:
        self.samples += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)

    @property
    def avg_ms(self) -> float:
        return self.total_ms / self.samples if self.samples else 0.0


@dataclass
class Profiler:
    stats: dict = field(
        default_factory=lambda: defaultdict(lambda: defaultdict(_Stat))
    )
    # Derived per-(config, renderer) metrics beside the timing stats, e.g.
    # {"roofline_x": 0.41}; filled by the bench harness.
    notes: dict = field(
        default_factory=lambda: defaultdict(lambda: defaultdict(dict))
    )
    ring: list = field(default_factory=list)
    _t0: float = 0.0
    _key: tuple = ()

    def start(self, config: str, renderer: str) -> None:
        """Start timing, once the card has finished the work before."""
        self._key = (config, renderer)
        _sync()
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """Stop timing once the card has finished the timed work (the
        whole queue, ``result``'s included; ``result`` is kept for
        ``volrt``'s signature)."""
        del result
        _sync()
        ms = (time.perf_counter() - self._t0) * 1e3
        config, renderer = self._key
        self.stats[config][renderer].add(ms)
        self.ring.append(ms)
        if len(self.ring) > RING_SIZE:
            self.ring.pop(0)
        return ms

    def time_fn(self, config: str, renderer: str, fn, iters: int = 1):
        """Time ``fn()`` ``iters`` times; returns the last result."""
        result = None
        for _ in range(iters):
            self.start(config, renderer)
            result = fn()
            self.stop(result)
        return result

    # --- reports (shape of reference print_avg/max/samples,
    #     Profiler.cpp:80-114) ---

    def _table(self, cell) -> str:
        renderers = sorted({
            r for cfg in self.stats.values() for r in cfg
        })
        lines = ["config," + ",".join(renderers)]
        for config, per_r in self.stats.items():
            row = [config]
            for r in renderers:
                s = per_r.get(r)
                row.append(
                    f"{cell(s):.2f}"
                    if s and s.samples >= MIN_SAMPLE_STAT else ""
                    if s is None else f"{cell(s):.2f}*"
                )
            lines.append(",".join(row))
        return "\n".join(lines)

    def print_avg(self) -> str:
        return "average ms:\n" + self._table(lambda s: s.avg_ms)

    def print_max(self) -> str:
        return "max ms:\n" + self._table(lambda s: s.max_ms)

    def print_samples(self) -> str:
        return "samples:\n" + self._table(lambda s: float(s.samples))

    def note(self, config: str, renderer: str, **metrics) -> None:
        """Attach derived metrics (e.g. ``roofline_x=0.41``) to a cell."""
        self.notes[config][renderer].update(metrics)

    def _notes_table(self, key: str) -> str:
        renderers = sorted({r for cfg in self.notes.values() for r in cfg})
        lines = ["config," + ",".join(renderers)]
        for config, per_r in self.notes.items():
            row = [config]
            for r in renderers:
                v = per_r.get(r, {}).get(key)
                row.append("" if v is None else f"{v:.4f}")
            lines.append(",".join(row))
        return "\n".join(lines)

    def print_roofline(self) -> str:
        """Nominal roofline-multiple table: the least time of a full march
        at nominal steps (:func:`nominal_bound_ms`) over the time measured.
        Not a utilization: ERT and ESL prune real work below the nominal
        march, so a value above 1.0 means they beat it."""
        return ("nominal_roofline_x (full-march bound / measured; NOT a "
                "utilization — >1 = ERT/ESL pruned work):\n"
                + self._notes_table("roofline_x"))

    def reset(self) -> None:
        self.stats.clear()
        self.notes.clear()
        self.ring.clear()


def derived_metrics(ms: float, n_rays: int, n_steps: int) -> dict:
    s = ms / 1e3
    return {
        "ms": ms,
        "rays_per_s": n_rays / s if s else 0.0,
        "ray_steps_per_s": n_rays * n_steps / s if s else 0.0,
    }
