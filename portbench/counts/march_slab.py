"""The march kernels' slab mode (``csrc/march_fwd.cu`` and
``csrc/march_bwd.cu`` with ``Slab::kOn``, f32): their operations and bytes
on one rank's slab."""
from __future__ import annotations

from portbench import peaks

# A ray's seed opacity (and, in the replay, its cotangent), f32.
ACC0_BYTES = 4
RGBA_BYTES = 16


def forward(samples: int, n_rays: int, slab_voxels: int
            ) -> tuple[float, float]:
    """``(ops, bytes)`` of a forward launch: the samples taken at the
    forward's f32 operations; the halo'd slab (f32), TF, scalars, rays
    and seed opacities read once, the colours written once."""
    return (float(samples * peaks.FLOPS_FWD),
            float(slab_voxels * 4 + peaks.TF_BYTES + peaks.SCAL_BYTES
                  + n_rays * (peaks.RAY_BYTES + ACC0_BYTES + RGBA_BYTES)))


def replay(samples: int, n_rays: int, slab_voxels: int
           ) -> tuple[float, float]:
    """``(ops, bytes)`` of a replay launch: the samples replayed at the
    replay's f32 operations (the forward again and the chain); the slab,
    TF, scalars, rays, seed opacities, the forward's colours and their
    cotangents read once, the slab's f32 gradient, the TF's and the seeds'
    written once."""
    return (float(samples * peaks.FLOPS_BWD),
            float(slab_voxels * 8 + 2 * peaks.TF_BYTES + peaks.SCAL_BYTES
                  + n_rays * (peaks.RAY_BYTES + 2 * ACC0_BYTES
                              + 2 * RGBA_BYTES)))


def launches(counts: dict, n_rays: int, slab_voxels: int) -> list:
    """The four launches of one step on a slab, forwards first and replays
    after, each in the order it ran, from the samples each takes
    (``reference_vsharded.slab_samples``): the prepass and the seeded
    march, then the seeded march's replay and the prepass's (a replay
    passes over a ray whose cotangent is zero)."""
    return [forward(counts["prepass"], n_rays, slab_voxels),
            forward(counts["seeded"], n_rays, slab_voxels),
            replay(counts["seeded_replay"], n_rays, slab_voxels),
            replay(counts["prepass_replay"], n_rays, slab_voxels)]
