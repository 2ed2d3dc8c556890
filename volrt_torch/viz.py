"""PNG output (a copy of ``volrt/viz.py:16-46``, which cannot be imported
without loading jax). Pure-stdlib encoder: no imaging dependency."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write an image to PNG. ``image`` is uint8 ``(H, W)``, ``(H, W, 3)``
    or ``(H, W, 4)``.

    Rows are written top-to-bottom; render buffers use y-up like the
    reference's GL window, so callers typically pass ``image[::-1]``.
    """
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    raw = b"".join(
        b"\x00" + img[row].tobytes() for row in range(h)
    )
    compressed = zlib.compress(raw, 6)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", compressed))
        f.write(chunk(b"IEND", b""))
