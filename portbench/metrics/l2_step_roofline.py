"""``l2_step_roofline``: the share of its roofline that ``l2_step`` reaches in the
traced window, in %: the least time of the samples its traced launches
took (counted by the reference on their inputs, ``counts/l2_step.py``) over
their device time (kernel ``l2_step_kernel``)."""
from __future__ import annotations

from portbench import peaks


def read(ctx) -> float | None:
    return peaks.roofline_pct(ctx.trace.launches("l2_step_kernel"),
                              ctx.work.get("l2_step", []))
