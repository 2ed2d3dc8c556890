"""volrt_torch — the PyTorch and CUDA port of volrt for one NVIDIA H100.

A second package beside ``volrt``, which stays as the JAX reference. It
imports ``torch`` and never ``jax``; the few framework-neutral pieces of
``volrt`` it needs (constants, the PNG writer, the synthetic volume, the
PVM loader, the native library's C++ source) are copied, because importing
anything under ``volrt`` loads jax.

Everything ``volrt`` does is ported (``ROADMAP.md`` names the two modes
left open on purpose): the renderer ladder (``renderers.get_renderer(0..5)``)
with the empty-space leap, the differentiable render and its oracle
(``renderers.diff_v3``, ``diff.render``, ``diff.fused``), the trainer
(``train.fit``, ``train.checkpoint``), ``dist/`` over
``torch.distributed``, the benchmark suite (``bench``), ``utils/``, the CLI,
the volume loader (``io.pvm``) and the host C++ library it decodes and
quantises with (``native``, built with ``g++`` at first use, no numpy
fallback). Ten hand-written CUDA kernels stand for ``volrt``'s nine Pallas
kernels and its XLA leap: the forward marches ``csrc/march_fwd.cu`` (rung
5) and ``csrc/march_ladder.cu`` (rungs 2-4), the backward
``csrc/march_bwd.cu``, the one-launch L2 step ``csrc/l2_step.cu``, the two
round-1 differentiable pairs of ``csrc/march_round1.cu``
(``render_image_fused(blocked=)``) and the leap ``csrc/esl_leap.cu``.
Shading (diffuse, gradient Blinn-Phong), ESL, the slab mode of ``dist/`` and
``volrt``'s bf16 fast mode are modes of the v3 kernels; rungs 0-1 and the
oracle shade with torch ops. Entry points run on the card
(:func:`default_device`) unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from volrt_torch.constants import (  # noqa: F401
    ESL_MIN_BLOCK_SIZE,
    ESL_VOLUME_DIMS,
    RENDERER_COUNT,
    TF_RATIO,
    TF_SIZE,
)
from volrt_torch.core.device import default_device  # noqa: F401
from volrt_torch.core.types import (  # noqa: F401
    Raycaster,
    View,
    Volume,
    make_raycaster,
    raycaster_from_arrays,
)
