"""PNG output and input (a copy of ``volrt/viz.py``, which cannot be
imported without loading jax). Pure-stdlib encoder and decoder: no imaging
dependency."""
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


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for files written by :func:`write_png`
    (8-bit, non-interlaced, filter 0 rows)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    w = h = c = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", payload[:10])
            assert depth == 8, "only 8-bit supported"
            c = {0: 1, 2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * c
    rows = []
    for row in range(h):
        off = row * (stride + 1)
        filt = raw[off]
        assert filt == 0, "only filter 0 supported"
        rows.append(np.frombuffer(raw, np.uint8, stride, off + 1))
    img = np.stack(rows).reshape(h, w, c)
    return img[..., 0] if c == 1 else img
