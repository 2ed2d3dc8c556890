"""``march_fwd_roofline``: the share of its roofline that ``march_fwd`` reaches in the
traced window, in %: the least time of the samples its traced launches
took (counted by the reference on their inputs, ``counts/march_fwd.py``) over
their device time (kernel ``march_fwd_kernel``)."""
from __future__ import annotations

from portbench import peaks


def read(ctx) -> float | None:
    return peaks.roofline_pct(ctx.trace.launches("march_fwd_kernel"),
                              ctx.work.get("march_fwd", []))
