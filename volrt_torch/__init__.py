"""volrt_torch — the PyTorch and CUDA port of volrt for one NVIDIA H100.

A second package beside ``volrt``, which stays as the JAX reference. It
imports ``torch`` and never ``jax``; the few framework-neutral pieces of
``volrt`` it needs (constants, the PNG writer, the synthetic volume, the
PVM loader) are copied, because importing anything under ``volrt`` loads
jax.

Ported so far: the renderer ladder (``renderers.get_renderer(0..5)``) with
the leading empty-space leap and the PVM loader (``io.pvm``), and the
training path (``diff.render``, ``renderers.diff_v3``, ``diff.fused``,
``train.fit``), through nine hand-written CUDA kernels: the forward marches
``csrc/march_fwd.cu`` (rung 5) and ``csrc/march_ladder.cu`` (rungs 2-4),
the backward ``csrc/march_bwd.cu``, the one-launch L2 step
``csrc/l2_step.cu`` and the two round-1 differentiable pairs of
``csrc/march_round1.cu`` (``render_image_fused(blocked=)``). Gradient
Blinn-Phong is torch ops (rungs 0-1 and ``render_diff_image``). Entry
points run on the card
(:func:`default_device`) unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from volrt_torch.constants import RENDERER_COUNT, TF_RATIO, TF_SIZE  # noqa: F401
from volrt_torch.core.device import default_device  # noqa: F401
from volrt_torch.core.types import (  # noqa: F401
    Raycaster,
    View,
    Volume,
    make_raycaster,
    raycaster_from_arrays,
)
