"""volrt_torch — the PyTorch and CUDA port of volrt for one NVIDIA H100.

A second package beside ``volrt``, which stays as the JAX reference. It
imports ``torch`` and never ``jax``; the few framework-neutral pieces of
``volrt`` it needs (constants, the PNG writer, the synthetic volume) are
copied, because importing anything under ``volrt`` loads jax.

Ported so far: rung 5's forward render (``renderers.fwd_v3``) and the
training path (``diff.render``, ``renderers.diff_v3``, ``diff.fused``,
``train.fit``) through three hand-written CUDA kernels: the forward march
``csrc/march_fwd.cu``, its backward ``csrc/march_bwd.cu`` and the
one-launch L2 step ``csrc/l2_step.cu``. Entry points run on the card
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
