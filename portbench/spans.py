"""What the readers of the program's spans share: a span's mean per call
over the traced window's first pass, from ``volrt_torch.utils.trace``.

The program records its spans only while a profiler records. The traced
window runs its ``len(ctx.host_enqueue_ms)`` calls twice, each pass under
a profiler of its own, and its readers run right after: so the window's
two passes are the last ``2 * n`` top-level calls recorded, and the first
pass, which records the device alone and lets the host run near its
untraced speed, is the first ``n`` of them. Calls recorded earlier, under
a profiler the window did not start, are left out. A program without the
module, a call without the span, a window of which fewer calls were
recorded, or a span without stream events (on the CPU) reads None.
"""
from __future__ import annotations


def read(ctx, call: str, span: str, field: str) -> float | None:
    """``field`` (``"host_ms"`` or ``"stream_ms"``) of the program's span
    ``span`` (its name after ``volrt_torch.``), the mean per call of the
    first pass, where the calls are ``call`` (``"frame"`` or ``"step"``)."""
    n = len(ctx.host_enqueue_ms)
    if ctx.call != call or not n:
        return None
    try:
        from volrt_torch.utils import trace
    except ImportError:
        return None
    ids = trace.call_ids()
    if len(ids) < 2 * n:
        return None
    found = trace.summary(ids[-2 * n:-n]).get(trace.PREFIX + span)
    return None if found is None else getattr(found, field)
