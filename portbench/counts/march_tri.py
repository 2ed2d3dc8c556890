"""Rung 3's ladder march (``csrc/march_ladder.cu``): its operations and
bytes."""
from __future__ import annotations

from portbench import peaks


def work(counts: dict, n_rays: int, n_voxels: int, voxel_bytes: int,
         esl: bool) -> tuple[float, float]:
    """``(ops, bytes)`` of one launch: the samples taken at the ladder's
    f32 operations (the diffuse tap left out, so the bound stays a least
    time); the raw f32 volume, TF, scalars and rays read once, the image
    written once. The leap is a kernel of its own (``esl`` unused)."""
    del esl
    ops = counts["taken"] * peaks.FLOPS_TRI
    nbytes = (n_voxels * voxel_bytes + peaks.TF_BYTES + peaks.SCAL_BYTES
              + n_rays * (peaks.RAY_BYTES + 16))
    return float(ops), float(nbytes)
