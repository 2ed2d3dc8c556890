"""``halo_stream_ms.vsharded``: the stream's milliseconds of rank 0's halo
copies in a step: the halo'd slab built from its own rows and the
neighbours' edges (span ``volrt_torch.halo_refresh``) and the gradient's
copy with the folded planes (``volrt_torch.halo_fold``), their
collectives left out; the mean per step over the traced window's first
pass (``portbench/spans.py``)."""
from __future__ import annotations

from portbench import spans


def read(ctx) -> float | None:
    parts = [spans.read(ctx, "step", s, "stream_ms")
             for s in ("halo_refresh", "halo_fold")]
    return None if None in parts else sum(parts)
