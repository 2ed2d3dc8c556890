"""The traced window: a ``torch.profiler`` trace of a run of calls, reduced to
the device's busy time, its idle gaps by what the host was doing, device
time by operation and each kernel's launches.

Adapted from the program's ``bench/trace_step.py:trace``, which sums device
time by kernel over a few steps: here the busy time is the union of the
device's operations in time, so that overlapping copies and kernels count
once, it is read from a pass that records the device alone, and each idle
gap of a second pass that records the host too is put down to the
innermost host event under its middle.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

WINDOW = "portbench.window"
OUTSIDE = "python_outside_torch_ops"
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: list  # [[name, seconds]], the most time first
    idle_gaps: list   # [[what the host did, seconds]], the most first
    kernels: dict     # name -> [seconds of each launch, in order]

    def launches(self, pattern: str) -> list[float]:
        """Each launch's device seconds of the kernels whose name holds
        ``pattern``, in the order they ran."""
        out = []
        for name, times in self.kernels.items():
            if pattern in name:
                out.extend(times)
        return [t for _, t in sorted(out)]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


class Context:
    """What the per-layer readers read: ``call`` (``"frame"`` or
    ``"step"``), ``trace``, ``host_enqueue_ms`` (a call's, untraced) and
    ``work`` (a kernel's ``(ops, bytes)`` a traced launch)."""

    def __init__(self, call: str, trace: Trace, host_enqueue_ms: list):
        self.call, self.trace = call, trace
        self.host_enqueue_ms = host_enqueue_ms
        self.work = {}


def profile_calls(call, n: int) -> Trace:
    """Trace ``call(i)`` for ``i`` in ``range(n)``, twice; each call ends
    when the card has finished its work. The first pass records the
    device's activity alone, which costs the host little: the busy time,
    the device operations and the kernels' launches come from it, and the
    window is its length on the host's clock. The second records the
    host's operations too, whose recording slows the host: it gives only
    what the host was doing in each idle gap."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            call(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    device = [(float(e.time_range.start), float(e.time_range.end), e.name)
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    w0 = min(d[0] for d in device)
    first = reduce_device(device, w0, w0 + (t1 - t0) * 1e6)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in range(n):
                call(i)
            torch.cuda.synchronize()
    return dataclasses.replace(first,
                               idle_gaps=reduce(prof.events()).idle_gaps)


def reduce(events) -> Trace:
    """A trace of host and device events with a window span, reduced."""
    device, host, window = [], [], None
    for e in events:
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # A span of the host's (record_function) shown on the device's
            # timeline is no device operation.
            if not getattr(e, "is_user_annotation", False):
                device.append((start, end, e.name))
        elif e.name == WINDOW:
            window = (start, end)
        else:
            host.append((start, end, e.name))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    trace = reduce_device(device, *window)
    trace.idle_gaps = _top(_attribute(trace.idle_gaps, host))
    return trace


def reduce_device(device: list, w0: float, w1: float) -> Trace:
    """Device events ``(start, end, name)`` in microseconds within the
    window ``[w0, w1]``: the busy time (their union), device time by name,
    each kernel's launches; ``idle_gaps`` holds the gaps' ``(start, end)``
    until :func:`reduce` names them."""
    device = [(max(s, w0), min(e, w1), n) for s, e, n in device
              if e > w0 and s < w1]
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    by_name, kernels = {}, {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        kernels.setdefault(name, []).append((s, (e - s) * 1e-6))
    busy, gaps, cur_s, cur_e = 0.0, [], w0, w0
    for s, e, _ in sorted(device):
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                 device_ops=_top(by_name), idle_gaps=gaps, kernels=kernels)


def _attribute(gaps, host) -> dict:
    """Seconds of idle device by the innermost host event under each
    gap's middle (the latest to start among those that hold it)."""
    out = {}
    if not gaps:
        return out
    hs = np.array([h[0] for h in host]) if host else np.zeros(0)
    he = np.array([h[1] for h in host]) if host else np.zeros(0)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        held = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = host[held[np.argmax(hs[held])]][2] if held.size else OUTSIDE
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-6
    return out


def _top(seconds: dict) -> list:
    return [[name[:120], s] for name, s in
            sorted(seconds.items(), key=lambda kv: -kv[1])[:TOP]]
