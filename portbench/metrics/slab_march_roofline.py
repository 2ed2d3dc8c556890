"""``slab_march_roofline``: the share of their roofline that rank 0's slab
launches of the march kernels reach in the first traced step, in %: the
least time of their work (the samples the reference counts on that step's
inputs, ``counts/march_slab.py``) over their device time; the forwards
(kernel ``march_fwd_kernel``: the prepass, the seeded march) and the
replays (``march_bwd_kernel``: the seeded march's, the prepass's)."""
from __future__ import annotations

from portbench import peaks


def read(ctx) -> float | None:
    fwd = ctx.trace.launches("march_fwd_kernel")[:2]
    bwd = ctx.trace.launches("march_bwd_kernel")[:2]
    work = ctx.work.get("march_slab", [])
    if len(fwd) < 2 or len(bwd) < 2 or len(work) < 4:
        return None
    return peaks.roofline_pct(fwd + bwd, work)
