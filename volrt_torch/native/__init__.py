"""The port's host C++ library (``volrt_native.cpp``), loaded with ctypes.

The counterpart of ``volrt/native/``: the DDS body decoder, the
gradient-weighted 16 -> 8 bit quantiser, the 256-bin histogram and the ESL
per-block (min, max) scan, with ``volrt``'s C ABI and results to the bit.
The port keeps its own copy of the source and imports nothing of
``volrt``. ``volrt_torch._build.load_native`` compiles it at first use with
``g++`` into ``volrt_torch/build/<hash>/``; it is host code, so it builds
and runs wherever there is a C++ compiler, the CPU tests included.

Unlike ``volrt``'s, this library has no numpy fallback and no switch to
turn it off: ``volrt``'s ``load()`` returns ``None`` when the compiler is
missing or ``VOLRT_NATIVE=0``, and its callers then quietly take numpy,
whose quantiser rounds some voxels the other way. Here :func:`load`
raises with the compiler's output, so the loader always gives the bytes
of one path. The numpy versions stay as the plain versions that the tests
and ``chip_smoke.py`` hold this library to: ``io.pvm.dds_decode``,
``io.pvm.quantize16_plain``, ``np.bincount`` and the corner of
``core.esl.build_min_max_grid``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from volrt_torch import _build

_I64 = ctypes.c_int64
_PTR = ctypes.c_void_p
_SIGNATURES = {
    "volrt_dds_decode": [ctypes.c_char_p, _I64, ctypes.c_int, _PTR, _I64,
                         ctypes.POINTER(_I64)],
    "volrt_esl_minmax": [_PTR, _I64, _I64, _I64, _I64, _PTR, _PTR],
    "volrt_histogram": [_PTR, _I64, _PTR],
    "volrt_quantize16": [_PTR, _I64, _I64, _I64, ctypes.c_int, _PTR],
    "volrt_native_abi_version": [],
}


@functools.cache
def load() -> ctypes.CDLL:
    """Build (at first use) and load the library with its signatures set;
    raises ``RuntimeError`` with the compiler's output if it cannot."""
    lib = _build.load_native()
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(_PTR)


def dds_decode(payload: bytes, block: int = 0) -> bytes:
    """Decode a DDS body (the bytes after the magic); ``block`` is the v3e
    interleave chunk (``io.pvm.DDS_INTERLEAVE_BLOCK``), 0 for v1.
    ``ValueError`` on a corrupt stream."""
    lib = load()
    payload = bytes(payload)
    # A generous first guess; the decoder reports the exact size when the
    # guess is short, and the second call takes it (no cap at 2^31 bytes).
    cap = max(len(payload) * 4, 1 << 20)
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        n_out = _I64(0)
        rc = lib.volrt_dds_decode(payload, len(payload), int(block),
                                  _ptr(out), cap, ctypes.byref(n_out))
        if rc == 0:
            return out[:n_out.value].tobytes()
        if rc != 1:
            raise ValueError("corrupt DDS stream (native decoder)")
        cap = n_out.value
    raise RuntimeError("native DDS decode failed to size its output")


def esl_minmax(volume: np.ndarray, block: int) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """Per-block (min, max) of a uint8 ``(D, H, W)`` volume, each
    ``uint8[ceil(D / block), ceil(H / block), ceil(W / block)]`` (no
    padding to the 32^3 grid; partial edge blocks cover their voxels)."""
    vol = np.ascontiguousarray(volume, np.uint8)
    if vol.ndim != 3 or block < 1:
        raise ValueError(f"need a 3-D volume and a block >= 1, got shape "
                         f"{vol.shape} and block {block}")
    d, h, w = vol.shape
    grid = (-(-d // block), -(-h // block), -(-w // block))
    mn, mx = np.empty(grid, np.uint8), np.empty(grid, np.uint8)
    load().volrt_esl_minmax(_ptr(vol), d, h, w, block, _ptr(mn), _ptr(mx))
    return mn, mx


def histogram(volume: np.ndarray) -> np.ndarray:
    """Counts of each uint8 value, ``int64[256]``."""
    vol = np.ascontiguousarray(volume, np.uint8)
    bins = np.zeros(256, np.int64)
    load().volrt_histogram(_ptr(vol), vol.size, _ptr(bins))
    return bins


def quantize16(v16: np.ndarray, linear: bool = False) -> np.ndarray:
    """Gradient-weighted (or, with ``linear``, linear) 16 -> 8 bit quantise
    of a uint16 ``(D, H, W)`` volume, as ``volrt``'s native quantiser."""
    v = np.ascontiguousarray(v16, np.uint16)
    if v.ndim != 3 or v.size == 0:
        raise ValueError(f"need a non-empty 3-D volume, got shape {v.shape}")
    out = np.empty(v.shape, np.uint8)
    load().volrt_quantize16(_ptr(v), *v.shape, int(linear), _ptr(out))
    return out
