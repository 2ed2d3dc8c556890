"""Spans at the layer boundaries of a frame and of a training step, on the
profiler's clock.

``span(name, **work)`` marks a stretch of the program's host code: the ray
setup, the volume's copy, a march wrapper's call, the optimiser's update.
It does nothing unless a ``torch.profiler`` is recording, which torch
keeps in a module global (``torch.autograd.profiler._is_profiler_enabled``)
that the span reads first; there is no other switch. While one records,
a span

- enters a profiler range named ``"volrt_torch." + name``, so that the
  stretch shows on the profiler's timeline beside the device's operations
  (Chrome traces, and the host events that an idle gap of the device is
  put down to). The range is torch's ``_RecordFunctionFast``, the
  ``record_function`` that torch's own compiled code enters: the same
  range, without ``torch.profiler.record_function``'s trip through two
  operator calls, which took some 75 µs a span inside a frame on an H100's
  host under a profiler;
- keeps a :class:`Record` of it in memory: its name, its parent span's
  record and the top-level call it belongs to (the spans of one frame or
  step share a call), the host's start and end from ``time.time_ns()``,
  and its work (rays, voxels or elements);
- with ``device=`` a CUDA device (a device stage), records a pair of
  timing events on that device's current stream at entry and at exit.
  The stream's milliseconds between them (:attr:`Record.stream_ms`) hold
  the device work the span queued and any wait for the host inside it:
  read beside the host's milliseconds, they say which side paced the
  stage. The events are resolved only when read.

``time.time_ns()`` is the profiler's clock: its events lie at
``trace_start_ns()`` plus their ``time_range`` in microseconds.

:func:`records` reads the records, :func:`call_ids` the top-level calls
they hold, :func:`clear` drops them and :func:`summary` gives each span's
host ms, stream ms and work per top-level call. The records of the last
:data:`KEEP_CALLS` to ``2 * KEEP_CALLS`` top-level calls are kept: a
profiler held around a long run keeps the newest, not all. Spans nest
on one stack: they are for the thread that drives the card.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections.abc import Iterable

import torch
from torch.autograd import profiler as _profiler

PREFIX = "volrt_torch."
# A context that opens a range named by its argument on the profiler's
# timeline (the one torch.profiler.record_function opens).
_range = torch._C._profiler._RecordFunctionFast


class Record:
    """One span, and the context that records it: ``name``, ``parent``
    (the enclosing span's record, None for none), ``call`` (the top-level
    call's index), ``start_ns`` and ``end_ns`` (``time.time_ns()``;
    ``end_ns`` is None while the span is open), ``unit`` and ``work``, and
    ``events`` (the stream's start and end events of a device stage, else
    None)."""

    __slots__ = ("name", "parent", "call", "start_ns", "end_ns", "unit",
                 "work", "events", "_device", "_fn", "_stream")

    def __init__(self, name: str, device, work: dict):
        self.name, self._device = PREFIX + name, device
        if work:
            (self.unit, self.work), = work.items()
        else:
            self.unit, self.work = "", 0
        self.end_ns = self.events = None

    def __enter__(self):
        global _calls
        self.start_ns = time.time_ns()
        self._fn = _range(self.name)
        self._fn.__enter__()
        self.parent = parent = _open[-1] if _open else None
        if parent is not None:
            self.call = parent.call
        else:
            self.call, _calls = _calls, _calls + 1
            if _records and self.call - _records[0].call >= 2 * KEEP_CALLS:
                _drop_before(self.call - KEEP_CALLS)
        if self._device is not None and self._device.type == "cuda":
            self._stream = _current_stream(self._device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self._stream)
        _records.append(self)
        _open.append(self)
        return None

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self._stream)
        _open.pop()
        self._fn.__exit__(*exc)
        self.end_ns = time.time_ns()
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def stream_ms(self) -> float | None:
        """The stream's milliseconds from the span's entry to its exit
        (waits for the device to reach the exit), or None where the span
        recorded no events."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


# Top-level calls kept: once the records hold twice as many, the oldest
# are dropped down to this many.
KEEP_CALLS = 4096
_records: list[Record] = []
_open: list[Record] = []
_calls = 0
# The device's current stream by (stream id, device index, device type):
# torch.cuda.current_stream builds a new Stream object on each call.
_streams: dict[tuple, torch.cuda.Stream] = {}


def _current_stream(device: torch.device) -> torch.cuda.Stream:
    index = torch.cuda.current_device() if device.index is None else (
        device.index)
    key = torch._C._cuda_getCurrentStream(index)
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


def _drop_before(call: int) -> None:
    """Drop the records of the top-level calls before ``call``."""
    del _records[:bisect.bisect_left(_records, call, key=_call_of)]


def _call_of(rec: Record) -> int:
    return rec.call


class _Off:
    """The span while no profiler records: enters nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, device: torch.device | None = None, **work):
    """A context that marks ``name`` (``"volrt_torch." + name`` on the
    timeline) while a profiler records, and does nothing otherwise.

    ``work`` is at most one keyword, the span's work in its unit (``rays=``,
    ``voxels=``, ``parameters=``, ...). ``device``, a CUDA device, makes
    the span a device stage (stream events on its current stream)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Record(name, device, work)


def records() -> list[Record]:
    """The records kept, in the order the spans were entered."""
    return list(_records)


def call_ids() -> list[int]:
    """The top-level calls the records kept belong to, oldest first."""
    return list(dict.fromkeys(r.call for r in _records))


def clear() -> None:
    """Drop the records and number top-level calls from 0 again (not
    inside an open span)."""
    global _calls
    if _open:
        raise RuntimeError("clear() inside an open span")
    _records.clear()
    _calls = 0


@dataclasses.dataclass
class Summary:
    """One span name over some top-level calls: ``calls`` (the calls
    summarised), ``spans`` (its records in them), and per call: ``host_ms``,
    ``stream_ms`` (None unless every record has events) and ``work`` (in
    ``unit``)."""
    name: str
    calls: int
    spans: int
    host_ms: float
    stream_ms: float | None
    unit: str
    work: float


def summary(calls: Iterable[int] | None = None) -> dict[str, Summary]:
    """Each span name's :class:`Summary` over the top-level calls
    ``calls`` (their indices; every call kept by default); spans still
    open are left out."""
    keep = set(call_ids() if calls is None else calls)
    by_name: dict[str, list[Record]] = {}
    for r in _records:
        if r.call in keep and r.end_ns is not None:
            by_name.setdefault(r.name, []).append(r)
    n = len(keep)
    out = {}
    for name, rs in by_name.items():
        stream = None
        if all(r.events is not None for r in rs):
            stream = sum(r.stream_ms for r in rs) / n
        out[name] = Summary(name, n, len(rs), sum(r.host_ms for r in rs) / n,
                            stream, rs[0].unit, sum(r.work for r in rs) / n)
    return out
