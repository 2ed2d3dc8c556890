"""The one-launch L2 step (``csrc/l2_step.cu``): its operations and bytes."""
from __future__ import annotations

from portbench import peaks


def work(counts: dict, n_rays: int, n_voxels: int, voxel_bytes: int,
         esl: bool) -> tuple[float, float]:
    """``(ops, bytes)`` of one launch: each sample taken marched forward
    and replayed (with phong's operations both ways where its gate
    opened; an ESL-skipped sample's position both ways); the density
    (``voxel_bytes`` a voxel: 2 in the fast mode), TF, scalars, ESL grid,
    rays and target read once, the image, the f32 density gradient and the
    TF gradient written once."""
    ops = (counts["taken"] * (peaks.FLOPS_FWD + peaks.FLOPS_BWD)
           + counts["gated"] * (peaks.FLOPS_PHONG_FWD + peaks.FLOPS_PHONG_BWD)
           + counts["skipped"] * 2 * peaks.FLOPS_ESL_SKIP)
    nbytes = (n_voxels * (voxel_bytes + 4) + 2 * peaks.TF_BYTES
              + peaks.SCAL_BYTES + (peaks.ESL_BYTES if esl else 0)
              + n_rays * (peaks.RAY_BYTES + 16 + 16))
    return float(ops), float(nbytes)
