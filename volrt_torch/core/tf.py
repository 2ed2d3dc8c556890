"""Transfer functions: the default ramp, premultiplication and loading
(the counterparts of ``volrt/core/tf.py:16-36, 88``).

A transfer function is an ``f32[TF_SIZE, 4]`` RGBA LUT.
"""
from __future__ import annotations

import numpy as np
import torch

from volrt_torch.constants import TF_RATIO, TF_SIZE
from volrt_torch.core.device import resolve_device


def default_transfer_fn(
        device: torch.device | str | None = None) -> torch.Tensor:
    """The reference's default RGB ramp TF (reference: RaycasterBase.cpp:76-84).

    R ramps over the first third of the LUT, G the middle, B the last;
    alpha ramps linearly but is zeroed below ``255*0.1/TF_RATIO``.
    Returned un-premultiplied ("base") as ``f32[TF_SIZE, 4]`` on ``device``
    (the card when ``None``).
    """
    i = np.arange(TF_SIZE, dtype=np.float32)
    third = TF_SIZE // 3
    r = np.where(i <= third, (i * 3) / TF_SIZE, 0.0)
    g = np.where((i > third) & (i <= 2 * third), ((i - third) * 3) / TF_SIZE, 0.0)
    b = np.where(i > 2 * third, ((i - 2 * third) * 3) / TF_SIZE, 0.0)
    a = np.where(i > (255.0 * 0.1) / TF_RATIO, i / TF_SIZE, 0.0)
    return torch.tensor(np.stack([r, g, b, a], axis=-1), dtype=torch.float32,
                        device=resolve_device(device))


def premultiply(base_tf: torch.Tensor) -> torch.Tensor:
    """Premultiply RGB by alpha (reference: RaycasterBase.cpp:46-52)."""
    rgb = base_tf[:, :3] * base_tf[:, 3:4]
    return torch.cat([rgb, base_tf[:, 3:4]], dim=-1)


def load_tf(path: str,
            device: torch.device | str | None = None) -> torch.Tensor:
    """Load a base (un-premultiplied) ``.npy`` LUT saved by ``volrt``."""
    arr = np.load(path)
    if arr.shape != (TF_SIZE, 4):
        raise ValueError(f"TF file must be ({TF_SIZE}, 4); got {arr.shape}")
    return torch.tensor(arr, dtype=torch.float32,
                        device=resolve_device(device))
