"""Rung 5's forward march (``csrc/march_fwd.cu``): its operations and bytes."""
from __future__ import annotations

from portbench import peaks


def work(counts: dict, n_rays: int, n_voxels: int, voxel_bytes: int,
         esl: bool) -> tuple[float, float]:
    """``(ops, bytes)`` of one launch: the samples taken (and those the
    phong gate opened, and those ESL skipped) at their f32 operations; the
    density, TF, scalars, ESL grid and rays read once, the image written
    once."""
    ops = (counts["taken"] * peaks.FLOPS_FWD
           + counts["gated"] * peaks.FLOPS_PHONG_FWD
           + counts["skipped"] * peaks.FLOPS_ESL_SKIP)
    nbytes = (n_voxels * voxel_bytes + peaks.TF_BYTES + peaks.SCAL_BYTES
              + (peaks.ESL_BYTES if esl else 0)
              + n_rays * (peaks.RAY_BYTES + 16))
    return float(ops), float(nbytes)
