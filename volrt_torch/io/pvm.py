"""PVM / DDS / RAW volume file I/O.

A copy of ``volrt/io/pvm.py`` that imports nothing of ``volrt`` (importing
it would load jax). As in ``volrt``, the loader decodes DDS bodies and
quantises 16-bit voxels with the host C++ library (``volrt_torch.native``),
but with no fallback: the numpy pipelines below (:func:`dds_decode`,
:func:`quantize16_plain`) are the plain versions the tests and
``chip_smoke.py`` hold the library to, and nothing on the loader's path
takes them. ``tests/test_torch_pvm.py`` and ``tests/test_torch_native.py``
hold the two packages to the same bytes.

From-scratch reimplementation of the on-disk formats consumed by the
reference's vendored loader (Stefan Roettger's ddsbase, reference:
VolumeRendering/ddsbase.cpp). The DDS "differential data stream" container
(reference: ddsbase.cpp:187-245) is decoded with a different, numpy-native
pipeline: one sequential scan over run-length group headers, then bulk
vectorized bit extraction of all residuals, then cumulative-sum reconstruction
of the first/second-order predictor — rather than the reference's
byte-at-a-time accumulator loop.

Format summary (derived from the reference decoder's behavior):
  * DDS container: magic ``"DDS v3d\n"`` (v1) or ``"DDS v3e\n"`` (v2),
    followed by a big-endian bitstream: 2 bits ``skip-1``, 16 bits
    ``strip-1``, then groups of [7-bit count, 3-bit width code, count x
    width-bit residuals] until a zero count. Width code ``b`` means ``b+1``
    bits for ``b >= 1``, else 0. Each residual is ``value - 2**bits // 2``;
    bytes are reconstructed with a first-order predictor for the first
    ``strip+1`` bytes and a second-order strip predictor afterwards, all
    mod 256. The byte stream is then re-interleaved with period ``skip``
    (v2: in chunks of ``skip * 2**24`` bytes).
  * PVM payload: ``"PVM\n"``/``"PVM2\n"``/``"PVM3\n"`` header with dims,
    (v2/v3) scale, component count, raw voxel bytes, and (v3) four trailing
    NUL-terminated metadata strings.
  * 16-bit volumes (components == 2, big-endian) are quantized to 8 bits with
    the gradient-weighted non-linear mapping of the reference
    (reference: ddsbase.cpp:475-558).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from volrt_torch import native

DDS_MAGIC_V1 = b"DDS v3d\n"
DDS_MAGIC_V2 = b"DDS v3e\n"
DDS_INTERLEAVE_BLOCK = 1 << 24
DDS_RL_BITS = 7


# ---------------------------------------------------------------------------
# DDS bitstream decode
# ---------------------------------------------------------------------------


class _BitReader:
    """Sequential MSB-first bit reader over a byte buffer."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.nbits = len(data) * 8

    def read(self, bits: int) -> int:
        if bits == 0:
            return 0
        pos = self.pos
        self.pos = pos + bits
        byte0 = pos >> 3
        nbytes = ((pos & 7) + bits + 7) >> 3
        chunk = self.data[byte0 : byte0 + nbytes]
        val = int.from_bytes(chunk, "big")
        val >>= len(chunk) * 8 - (pos & 7) - bits
        return val & ((1 << bits) - 1)

    def skip(self, bits: int) -> None:
        self.pos += bits


def _extract_bits_bulk(
    data: np.ndarray, offsets: np.ndarray, widths: np.ndarray
) -> np.ndarray:
    """Extract values of ``widths`` bits (each <= 8) at arbitrary bit
    ``offsets`` from a uint8 buffer, vectorized. Returns int32."""
    # A value of <= 8 bits starting at bit offset o spans at most 2 bytes.
    byte_idx = offsets >> 3
    bit_in = (offsets & 7).astype(np.int32)
    padded = np.concatenate([data, np.zeros(2, np.uint8)])
    hi = padded[byte_idx].astype(np.int32)
    lo = padded[byte_idx + 1].astype(np.int32)
    word = (hi << 8) | lo
    shift = 16 - bit_in - widths
    mask = (1 << widths) - 1
    return (word >> shift) & mask


def _dds_width_code(code: int) -> int:
    """3-bit width code -> residual bit width (reference: ddsbase.cpp:118-119)."""
    return code + 1 if code >= 1 else code


def dds_decode(payload: bytes, block: int = 0) -> bytes:
    """Decode a DDS differential stream body (after the magic) with numpy:
    the plain version of ``native.dds_decode``, which :func:`read_dds`
    takes."""
    br = _BitReader(payload)
    skip = br.read(2) + 1
    strip = br.read(16) + 1

    data = np.frombuffer(payload, np.uint8)

    # Pass 1: sequential scan of group headers to locate residual runs.
    counts: list[int] = []
    widths: list[int] = []
    starts: list[int] = []
    while True:
        cnt1 = br.read(DDS_RL_BITS)
        if cnt1 == 0:
            break
        w = _dds_width_code(br.read(3))
        counts.append(cnt1)
        widths.append(w)
        starts.append(br.pos)
        br.skip(cnt1 * w)
        if br.pos > br.nbits + 32:
            raise ValueError("corrupt DDS stream: ran past end of buffer")

    if not counts:
        return b""

    counts_a = np.asarray(counts, np.int64)
    widths_a = np.asarray(widths, np.int64)
    starts_a = np.asarray(starts, np.int64)
    total = int(counts_a.sum())

    # Pass 2: bulk residual extraction.
    val_widths = np.repeat(widths_a, counts_a)
    # Per-value offsets: group start + index-within-group * width.
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts_a) - counts_a, counts_a
    )
    val_offsets = np.repeat(starts_a, counts_a) + within * val_widths
    values = _extract_bits_bulk(data, val_offsets, val_widths.astype(np.int32))
    deltas = values - ((1 << val_widths.astype(np.int64)) // 2).astype(np.int64)

    # Pass 3: predictor reconstruction (mod 256).
    out = _reconstruct(deltas, strip)

    # Pass 4: re-interleave with period `skip`.
    out = _interleave(out, skip, block)
    return out.tobytes()


def _reconstruct(deltas: np.ndarray, strip: int) -> np.ndarray:
    """Invert the DDS predictor: ``d[n] = d[n-1] + delta`` for the first
    ``strip+1`` bytes, then ``d[n] = d[n-1] + d[n-strip] - d[n-strip-1] +
    delta`` (all mod 256), vectorized with cumsums."""
    n = deltas.shape[0]
    if strip == 1 or n <= strip + 1:
        return (np.cumsum(deltas) % 256).astype(np.uint8)

    # Head: first strip+1 bytes are a plain cumulative sum.
    head = np.cumsum(deltas[: strip + 1]) % 256
    # e[n] := d[n] - d[n-strip] satisfies e[n] = e[n-1] + delta[n] for
    # n > strip, with e[strip] = d[strip] - d[0].
    e_seed = head[strip] - head[0]
    e_tail = (e_seed + np.cumsum(deltas[strip + 1 :])) % 256
    e = np.concatenate([head[strip:strip + 1] - head[0:1], e_tail]) % 256
    # d[r*strip + c] = d[(r-1)*strip + c] + e -> cumsum down columns of
    # the (rows, strip) layout of e, seeded by the head values.
    m = n - strip  # number of e entries, covering d[strip:]
    rows = -(-m // strip)
    e_pad = np.zeros(rows * strip, np.int64)
    e_pad[:m] = e
    e_mat = e_pad.reshape(rows, strip)
    seed = np.zeros(strip, np.int64)
    seed[:] = head[:strip]
    d_mat = (seed[None, :] + np.cumsum(e_mat, axis=0)) % 256
    d = np.empty(n, np.uint8)
    d[:strip] = head[:strip]
    d[strip:] = d_mat.reshape(-1)[:m].astype(np.uint8)
    return d


def _interleave(data: np.ndarray, skip: int, block: int) -> np.ndarray:
    """Restore byte interleaving: stored stream has all bytes congruent to 0
    mod skip first, then 1 mod skip, ... (reference: ddsbase.cpp:122-184)."""
    if skip <= 1:
        return data
    n = data.shape[0]
    if block == 0:
        return _interleave_chunk(data, skip)
    chunk = skip * block
    out = np.empty_like(data)
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        out[start:end] = _interleave_chunk(data[start:end], skip)
    return out


def _interleave_chunk(chunk: np.ndarray, skip: int) -> np.ndarray:
    n = chunk.shape[0]
    out = np.empty_like(chunk)
    src = 0
    for i in range(skip):
        cnt = len(range(i, n, skip))
        out[i::skip] = chunk[src : src + cnt]
        src += cnt
    return out


def read_dds(path: str) -> bytes | None:
    """Read a file, transparently decoding a DDS container if present.
    Returns None if the file does not exist."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        raw = f.read()
    if raw.startswith(DDS_MAGIC_V1):
        return native.dds_decode(raw[len(DDS_MAGIC_V1) :], block=0)
    if raw.startswith(DDS_MAGIC_V2):
        return native.dds_decode(
            raw[len(DDS_MAGIC_V2) :], block=DDS_INTERLEAVE_BLOCK
        )
    return raw


# ---------------------------------------------------------------------------
# DDS bitstream encode (new capability: the reference only decodes;
# format derived from the decoder above, reference: ddsbase.cpp:187-245)
# ---------------------------------------------------------------------------


class _BitWriter:
    """Sequential MSB-first bit writer (inverse of :class:`_BitReader`)."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int) -> None:
        if bits == 0:
            return
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def done(self) -> bytes:
        if self.nbits:
            self.buf.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.nbits = 0
        return bytes(self.buf)


def _dds_code_for_width(width: int) -> int:
    """Inverse of :func:`_dds_width_code` (widths 1 is unrepresentable:
    the 3-bit code space maps to {0, 2, 3, .., 8})."""
    return width - 1 if width >= 2 else 0


def _signed_deltas(data: np.ndarray, strip: int) -> np.ndarray:
    """Per-byte prediction residuals of the DDS strip predictor, mapped
    into signed [-128, 127] (mod-256 arithmetic matches
    :func:`_reconstruct`'s accumulator exactly)."""
    d = data.astype(np.int64)
    n = d.shape[0]
    deltas = np.empty(n, np.int64)
    deltas[0] = d[0]
    if strip == 1:
        # strip == 1 is the plain first-order accumulator throughout
        # (reference: ddsbase.cpp:213-235 `strip == 1 || cnt <= strip`).
        deltas[1:] = d[1:] - d[:-1]
    else:
        k = min(strip, n - 1)
        deltas[1:k + 1] = d[1:k + 1] - d[:k]
        if n > strip + 1:
            deltas[strip + 1:] = (d[strip + 1:] - d[strip:n - 1]
                                  - d[1:n - strip] + d[:n - strip - 1])
    return ((deltas + 128) % 256) - 128


def _width_for(lo: int, hi: int) -> int:
    """Smallest representable residual width covering [lo, hi]
    (stored value = residual + 2^(w-1), so w fits residuals in
    [-2^(w-1), 2^(w-1) - 1])."""
    if lo == 0 == hi:
        return 0
    for w in (2, 3, 4, 5, 6, 7, 8):
        half = 1 << (w - 1)
        if lo >= -half and hi <= half - 1:
            return w
    raise AssertionError("residual out of byte range")


def dds_encode(data: bytes, strip: int = 1) -> bytes:
    """Encode bytes as a DDS v3d differential stream body (no magic).

    Exact inverse of :func:`dds_decode` (``skip=1``, unblocked): the
    strip predictor's residuals are grouped into runs of <= 127 values,
    each with the narrowest representable bit width; long zero-residual
    runs become width-0 groups costing 10 bits per 127 bytes. ``strip``
    is the predictor period — the scanline width for volume data.
    """
    strip = max(1, min(int(strip), 1 << 16))
    bw = _BitWriter()
    bw.write(0, 2)            # skip - 1  (no interleave)
    bw.write(strip - 1, 16)   # strip - 1
    arr = np.frombuffer(data, np.uint8)
    n = arr.shape[0]
    if n:
        s = _signed_deltas(arr, strip)
        nz = np.flatnonzero(s)
        i = 0
        while i < n:
            # Zero run ahead? Emit width-0 groups for its whole length.
            k = np.searchsorted(nz, i)
            nxt = int(nz[k]) if k < nz.shape[0] else n
            if nxt - i >= 16 or nxt == n:
                run = nxt - i
                while run > 0:
                    cnt = min(run, 127)
                    bw.write(cnt, DDS_RL_BITS)
                    bw.write(0, 3)
                    run -= cnt
                i = nxt
                continue
            j = min(i + 127, n)
            chunk = s[i:j]
            w = _width_for(int(chunk.min()), int(chunk.max()))
            half = (1 << w) // 2
            bw.write(j - i, DDS_RL_BITS)
            bw.write(_dds_code_for_width(w), 3)
            for v in chunk + half:
                bw.write(int(v), w)
            i = j
    bw.write(0, DDS_RL_BITS)  # terminator group
    return bw.done()


def write_dds(path: str, data: bytes, strip: int = 1) -> None:
    """Write ``data`` as a DDS v3d container file."""
    with open(path, "wb") as f:
        f.write(DDS_MAGIC_V1)
        f.write(dds_encode(data, strip))


# ---------------------------------------------------------------------------
# PVM parsing
# ---------------------------------------------------------------------------


@dataclass
class PVMVolume:
    """Parsed PVM payload."""

    data: np.ndarray  # uint8 (D, H, W) after component handling
    width: int
    height: int
    depth: int
    components: int
    scale: tuple[float, float, float] = (1.0, 1.0, 1.0)
    description: str | None = None
    courtesy: str | None = None
    parameters: str | None = None
    comment: str | None = None
    raw_components: np.ndarray | None = field(default=None, repr=False)


def _parse_pvm_payload(payload: bytes) -> PVMVolume:
    """Parse a decoded PVM byte payload (reference: ddsbase.cpp:345-435)."""
    if len(payload) < 5:
        raise ValueError("PVM payload too short")

    scale = (1.0, 1.0, 1.0)
    if payload.startswith(b"PVM\n"):
        version = 1
        pos = 4
        # Skip comment lines starting with '#'.
        while payload[pos : pos + 1] == b"#":
            pos = payload.index(b"\n", pos) + 1
        line_end = payload.index(b"\n", pos)
        dims = payload[pos:line_end].split()
        width, height, depth = (int(x) for x in dims[:3])
        pos = line_end + 1
    elif payload.startswith(b"PVM2\n") or payload.startswith(b"PVM3\n"):
        version = 2 if payload.startswith(b"PVM2\n") else 3
        pos = 5
        line_end = payload.index(b"\n", pos)
        width, height, depth = (int(x) for x in payload[pos:line_end].split()[:3])
        pos = line_end + 1
        line_end = payload.index(b"\n", pos)
        sx, sy, sz = (float(x) for x in payload[pos:line_end].split()[:3])
        scale = (sx, sy, sz)
        pos = line_end + 1
    else:
        raise ValueError("not a PVM payload (missing PVM/PVM2/PVM3 magic)")

    if min(width, height, depth) < 1:
        raise ValueError(f"bad PVM dims {(width, height, depth)}")

    line_end = payload.index(b"\n", pos)
    components = int(payload[pos:line_end].split()[0])
    if components < 1:
        raise ValueError(f"bad PVM component count {components}")
    pos = line_end + 1

    nvox = width * height * depth * components
    voxels = np.frombuffer(payload, np.uint8, count=nvox, offset=pos)

    meta: list[str | None] = [None, None, None, None]
    if version == 3:
        tail = payload[pos + nvox :]
        cursor = 0
        for i in range(4):
            end = tail.index(b"\0", cursor)
            s = tail[cursor:end]
            meta[i] = s.decode("latin-1") if len(s) > 0 else None
            cursor = end + 1

    return PVMVolume(
        data=voxels.reshape(depth, height, width * components).copy(),
        width=width,
        height=height,
        depth=depth,
        components=components,
        scale=scale,
        description=meta[0],
        courtesy=meta[1],
        parameters=meta[2],
        comment=meta[3],
    )


def read_pvm(path: str) -> PVMVolume:
    """Read a PVM file (optionally DDS-compressed), returning the parsed
    volume with 16-bit data quantized down to 8 bits."""
    payload = read_dds(path)
    if payload is None:
        raise FileNotFoundError(path)
    vol = _parse_pvm_payload(payload)
    if vol.components > 2:
        raise ValueError(
            f"unsupported component count {vol.components} (1|2 allowed)"
        )
    if vol.components == 2:
        raw16 = vol.data.reshape(vol.depth, vol.height, vol.width, 2)
        vol.raw_components = raw16
        vol.data = quantize16(raw16)
        vol.components = 1
    else:
        vol.data = vol.data.reshape(vol.depth, vol.height, vol.width)
    return vol


def read_raw(
    path: str, dims: tuple[int, int, int], components: int = 1
) -> np.ndarray:
    """Read a headerless RAW volume as uint8 ``(D, H, W)`` given ``(W, H, D)``
    dims; 2-component (16-bit) data is quantized (reference: ModelBase.cpp:71-98)."""
    data = np.fromfile(path, np.uint8)
    w, h, d = dims
    expected = w * h * d * components
    if data.size != expected:
        raise ValueError(
            f"RAW size {data.size} != W*H*D*components {expected}"
        )
    if components == 1:
        return data.reshape(d, h, w)
    if components == 2:
        return quantize16(data.reshape(d, h, w, 2))
    raise ValueError(f"unsupported component count {components} (1|2 allowed)")


# ---------------------------------------------------------------------------
# 16 -> 8 bit non-linear quantization (reference: ddsbase.cpp:439-558)
# ---------------------------------------------------------------------------


def _voxels16(data: np.ndarray) -> np.ndarray:
    """Big-endian byte pairs ``(D, H, W, 2)`` -> uint16 ``(D, H, W)``."""
    return data[..., 0].astype(np.uint16) * 256 + data[..., 1].astype(np.uint16)


def quantize16(data: np.ndarray, linear: bool = False) -> np.ndarray:
    """Quantize big-endian 16-bit voxels ``(D, H, W, 2)`` to uint8
    ``(D, H, W)`` with the host library (``native.quantize16``), as
    ``volrt`` does when its library is built. :func:`quantize16_plain` is
    the same algorithm in numpy; the two round a voxel apart now and then
    (by 1), in ``volrt`` too."""
    return native.quantize16(_voxels16(data), linear=linear)


def quantize16_plain(data: np.ndarray, linear: bool = False) -> np.ndarray:
    """:func:`quantize16` in numpy (``volrt``'s numpy path).

    Non-linear mode weights each 16-bit value by the cube root of its summed
    gradient magnitudes, iteratively caps outliers, and integrates the result
    into a monotone 16->8 bit mapping — the same algorithm as the reference
    (reference: ddsbase.cpp:475-558), vectorized with numpy.
    """
    v = _voxels16(data)
    vmin, vmax = int(v.min()), int(v.max())

    if linear:
        err = 255.0 * np.arange(65536, dtype=np.float64) / max(vmax, 1)
        # (int)(x + 0.5) truncation semantics (not round-half-even)
        return np.floor(err[v] + 0.5).astype(np.uint8)

    grad = _gradient_magnitude(v.astype(np.float64))
    err = np.zeros(65536, np.float64)
    np.add.at(err, v.reshape(-1), np.sqrt(grad.reshape(-1)))
    err = np.power(err, 1.0 / 3.0)
    err[vmin] = 0.0
    err[vmax] = 0.0

    for _ in range(256):
        eint = err.sum()
        cap = eint / 256.0
        over = err > cap
        if not over.any():
            break
        err[over] = cap

    err = np.cumsum(err)
    if err[65535] > 0.0:
        err *= 255.0 / err[65535]

    return np.floor(err[v] + 0.5).astype(np.uint8)


def _gradient_magnitude(v: np.ndarray) -> np.ndarray:
    """Per-voxel gradient magnitude with central differences inside and
    one-sided differences at the borders (reference: ddsbase.cpp:444-472).
    ``v`` is (D, H, W) float."""
    out = np.zeros_like(v)
    for axis in range(3):
        g = np.zeros_like(v)
        n = v.shape[axis]
        if n > 1:
            sl = [slice(None)] * 3

            def ax(i):
                s = list(sl)
                s[axis] = i
                return tuple(s)

            g[ax(slice(1, n - 1))] = (
                v[ax(slice(2, n))] - v[ax(slice(0, n - 2))]
            ) / 2.0
            g[ax(0)] = v[ax(1)] - v[ax(0)]
            g[ax(n - 1)] = v[ax(n - 1)] - v[ax(n - 2)]
        out += g * g
    return np.sqrt(out)


# ---------------------------------------------------------------------------
# PVM writer (uncompressed PVM3) — new capability for asset generation
# ---------------------------------------------------------------------------


def write_pvm(
    path: str,
    data: np.ndarray,
    scale: tuple[float, float, float] = (1.0, 1.0, 1.0),
    description: str = "",
    courtesy: str = "",
    parameters: str = "",
    comment: str = "",
    dds: bool = False,
) -> None:
    """Write a PVM3 file from a uint8 ``(D, H, W)`` array.

    ``dds=True`` wraps the whole payload (header + voxels + metadata) in
    a DDS v3d differential container — the same layout as the
    reference's bundled ``Bucky.pvm`` — with the scanline width as the
    predictor strip."""
    data = np.asarray(data, np.uint8)
    d, h, w = data.shape
    header = (
        b"PVM3\n"
        + f"{w} {h} {d}\n".encode()
        + f"{scale[0]:g} {scale[1]:g} {scale[2]:g}\n".encode()
        + b"1\n"
    )
    payload = header + data.tobytes()
    for s in (description, courtesy, parameters, comment):
        payload += s.encode("latin-1") + b"\0"
    if dds:
        write_dds(path, payload, strip=w)
        return
    with open(path, "wb") as f:
        f.write(payload)


# ---------------------------------------------------------------------------
# Top-level loader (reference: ModelBase.cpp:35-109)
# ---------------------------------------------------------------------------


def load_volume(
    path: str,
    raw_dims: tuple[int, int, int] | None = None,
    raw_components: int = 1,
) -> tuple[np.ndarray, dict]:
    """Load a ``.pvm`` or ``.raw`` volume file.

    Returns ``(data, info)`` with ``data`` uint8 ``(D, H, W)`` and ``info``
    carrying dims/scale/metadata. RAW files need explicit ``raw_dims``
    (the reference prompts interactively, reference: ModelBase.cpp:78-88).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pvm":
        vol = read_pvm(path)
        info = {
            "dims": (vol.width, vol.height, vol.depth),
            "components": vol.components,
            "scale": vol.scale,
            "description": vol.description,
            "courtesy": vol.courtesy,
            "parameters": vol.parameters,
            "comment": vol.comment,
        }
        return vol.data, info
    if ext == ".raw":
        if raw_dims is None:
            raise ValueError("RAW files require raw_dims=(W, H, D)")
        data = read_raw(path, raw_dims, raw_components)
        return data, {"dims": raw_dims, "components": 1, "scale": (1.0, 1.0, 1.0)}
    raise ValueError(f"unsupported file extension {ext!r} (.raw|.pvm allowed)")
