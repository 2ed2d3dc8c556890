"""volrt_torch — the PyTorch and CUDA port of volrt for one NVIDIA H100.

A second package beside ``volrt``, which stays as the JAX reference. It
imports ``torch`` and never ``jax``; the few framework-neutral pieces of
``volrt`` it needs (constants, the PNG writer, the synthetic volume) are
copied, because importing anything under ``volrt`` loads jax.

Ported so far: rung 5's forward render (``renderers.fwd_v3``) through the
hand-written CUDA march kernel ``csrc/march_fwd.cu``.
"""

__version__ = "0.1.0"

from volrt_torch.constants import RENDERER_COUNT, TF_RATIO, TF_SIZE  # noqa: F401
from volrt_torch.core.types import (  # noqa: F401
    Raycaster,
    View,
    Volume,
    make_raycaster,
    raycaster_from_arrays,
)
