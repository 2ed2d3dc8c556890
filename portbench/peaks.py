"""The yardstick of every roofline share: the card's published peaks and the
f32 operations a sample of each march costs.

Frozen copies of the program's ``utils/profiler.py`` counts (counted by
hand from ``csrc/march_common.cuh``), kept here so that a change to the
program cannot move them.
"""
from __future__ import annotations

# One H100 SXM at its full 700 W power limit (NVIDIA's data sheet): HBM3
# bandwidth and the f32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# f32 operations per composited sample of a density (rung 5, the training
# step). Forward: the position 8, three axes' taps 15, seven lerps 28, the
# TF coordinate and its lerps 20, the composite 9. Replay: the forward
# without its three colour composites 74, the cotangent chain 20, the TF
# rows' weights and adds 17, the TF slope and the eight voxels' weights and
# adds 35.
FLOPS_FWD = 80
FLOPS_BWD = 146
# The ladder over raw values (rung 3): the position and the next k 7, the
# taps 15, the seven lerps 28, the division by 255 1, the TF coordinate and
# its lerps 20, the composite 9. The diffuse tap is not counted.
FLOPS_TRI = 80
# Phong, on top of the above, a sample that opens the shade gate. Forward:
# the six shifted axes 48, six trilinear samples 168 and their differences
# 3, the three norms and directions 36, two dots 13, the powers 4, the
# specular, lit and colour 10. Replay: the forward's again, the chain 54,
# the six cells' weights and adds 168.
FLOPS_PHONG_FWD = 282
FLOPS_PHONG_BWD = 504
# A sample that ESL skips: the position 6 and three voxel coordinates 9.
FLOPS_ESL_SKIP = 15

# Bytes a ray's inputs hold: origin and direction f32[3] each, first and
# last ray parameter f32, alive bool.
RAY_BYTES = 12 + 12 + 4 + 4 + 1
# The premultiplied TF, f32[128, 4]; the kernels' scalars, f32[8].
TF_BYTES = 128 * 16
SCAL_BYTES = 8 * 4
# The packed ESL grid, int32[1024].
ESL_BYTES = 1024 * 4


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take for ``ops`` f32 operations over
    ``nbytes`` that must move: the longer of the two at the peaks."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def roofline_pct(launch_seconds: list[float], work: list) -> float | None:
    """A kernel's share of its roofline, in %: the least time of the work
    of its traced launches (``work``: ``(ops, bytes)`` a launch, in the
    order they ran) over their device time. None where there is nothing
    to read."""
    n = min(len(launch_seconds), len(work))
    if n == 0:
        return None
    spent = sum(launch_seconds[:n])
    if spent <= 0.0:
        return None
    return 100.0 * sum(least_seconds(o, b) for o, b in work[:n]) / spent
