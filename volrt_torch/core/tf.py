"""Transfer functions: the default ramp, premultiplication, the editor's
operations, saving and loading (the counterparts of ``volrt/core/tf.py``).

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


def first_opaque_index(premult_tf: torch.Tensor) -> torch.Tensor:
    """For each LUT index x, the first index ``y >= x`` with nonzero
    opacity, ``TF_SIZE`` where the rest of the LUT is transparent: a
    reverse cumulative minimum over indices, ``int64[TF_SIZE]``
    (reference: RaycasterBase.cpp:53-61, the ``esl_temp_tf`` table)."""
    idx = torch.arange(TF_SIZE, device=premult_tf.device)
    cand = torch.where(premult_tf[:, 3] != 0.0, idx, TF_SIZE)
    return torch.cummin(cand.flip(0), 0).values.flip(0)


def edit_alpha(base_tf: torch.Tensor, lo: int, hi: int,
               intensity: float) -> torch.Tensor:
    """Set the opacity of LUT entries ``[lo, hi]`` like a TF-editor drag.

    The editor maps drag height ``y in [0,1]`` to ``alpha = y**4``
    (reference: UI.cpp:317-340); callers pass the already-curved intensity
    or use :func:`editor_alpha_curve`. Returns a new LUT.
    """
    idx = torch.arange(TF_SIZE, device=base_tf.device)
    mask = (idx >= lo) & (idx <= hi)
    a = torch.where(mask, torch.tensor(intensity, dtype=torch.float32,
                                       device=base_tf.device), base_tf[:, 3])
    return torch.cat([base_tf[:, :3], a[:, None]], dim=-1)


def set_colors(base_tf: torch.Tensor, lo: int, hi: int,
               rgb) -> torch.Tensor:
    """Paint the RGB of LUT entries ``[lo, hi]`` (reference:
    UI.cpp:330-335). Returns a new LUT."""
    idx = torch.arange(TF_SIZE, device=base_tf.device)
    mask = ((idx >= lo) & (idx <= hi))[:, None]
    rgb_arr = torch.as_tensor(rgb, dtype=torch.float32,
                              device=base_tf.device).expand(TF_SIZE, 3)
    new_rgb = torch.where(mask, rgb_arr, base_tf[:, :3])
    return torch.cat([new_rgb, base_tf[:, 3:4]], dim=-1)


def editor_alpha_curve(height: torch.Tensor) -> torch.Tensor:
    """Editor drag-height -> opacity curve: ``clip(h, 0, 1)**4``
    (reference: UI.cpp:327-329)."""
    return torch.clamp(height, 0.0, 1.0) ** 4


def save_tf(path: str, base_tf) -> None:
    """Persist a base (un-premultiplied) TF LUT as .npy, the file that
    ``--tf`` and ``volrt``'s ``load_tf`` read."""
    if isinstance(base_tf, torch.Tensor):
        base_tf = base_tf.detach().cpu().numpy()
    np.save(path, np.asarray(base_tf, np.float32))


def load_tf(path: str,
            device: torch.device | str | None = None) -> torch.Tensor:
    """Load a base (un-premultiplied) ``.npy`` LUT saved by ``volrt``."""
    arr = np.load(path)
    if arr.shape != (TF_SIZE, 4):
        raise ValueError(f"TF file must be ({TF_SIZE}, 4); got {arr.shape}")
    return torch.tensor(arr, dtype=torch.float32,
                        device=resolve_device(device))
