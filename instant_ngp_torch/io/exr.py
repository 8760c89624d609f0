"""Minimal OpenEXR scanline reader/writer in pure Python (numpy + zlib),
a port of ``instant_ngp_tpu/io/exr.py``.

Replaces the reference's vendored tinyexr (src/tinyexr_wrapper.cu) for
the HDR image paths: half/float RGB(A) scanline images with NONE, ZIPS
(1-line) or ZIP (16-line) compression, which covers the reference's
shipped image (albert.exr, 1024² RGBA half, ZIP) and what the writer
here produces.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_MAGIC = 0x01312F76
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXEL_CODES = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}


def _read_header(data: bytes, pos: int):
    attrs = {}
    while True:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = end + 1
        if name == "":
            break
        end = data.index(b"\0", pos)
        typ = data[pos:end].decode()
        pos = end + 1
        size = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        attrs[name] = (typ, data[pos : pos + size])
        pos += size
    return attrs, pos


def _parse_chlist(raw: bytes):
    channels = []
    pos = 0
    while raw[pos] != 0:
        end = raw.index(b"\0", pos)
        name = raw[pos:end].decode()
        pos = end + 1
        ptype, _plinear, xs, ys = struct.unpack_from("<iBxxxii", raw, pos)
        pos += 16
        channels.append((name, ptype, xs, ys))
    return channels


def _unpredict_deinterleave(buf: bytes) -> np.ndarray:
    # delta-decode: out[0] = in[0]; out[i] = out[i-1] + in[i] - 128 (mod 256)
    dec0 = np.frombuffer(buf, np.uint8).astype(np.int64)
    dec0[1:] -= 128
    dec = (np.cumsum(dec0) % 256).astype(np.uint8)
    # deinterleave
    n = len(dec)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = dec[:half]
    out[1::2] = dec[half:]
    return out


def _predict_interleave(raw: np.ndarray) -> bytes:
    n = len(raw)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = raw[0::2]
    inter[half:] = raw[1::2]
    d = inter.astype(np.int16)
    delta = np.empty(n, np.int16)
    delta[0] = d[0]
    delta[1:] = d[1:] - d[:-1] + 128
    return (delta % 256).astype(np.uint8).tobytes()


def read_exr(path) -> np.ndarray:
    """Read a scanline EXR → (H, W, C) float32 array. Channels are
    returned in R,G,B,A order when those names exist, else file order."""
    data = Path(path).read_bytes()
    magic, _version = struct.unpack_from("<iI", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    attrs, pos = _read_header(data, 8)

    channels = _parse_chlist(attrs["channels"][1])
    compression = attrs["compression"][1][0]
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    width, height = xmax - xmin + 1, ymax - ymin + 1

    if compression == 0:
        lines_per_block = 1
    elif compression == 2:  # ZIPS
        lines_per_block = 1
    elif compression == 3:  # ZIP
        lines_per_block = 16
    else:
        raise NotImplementedError(f"EXR compression {compression} not supported")

    n_blocks = (height + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)

    dtypes = [_PIXEL_DTYPES[c[1]] for c in channels]
    out = {c[0]: np.empty((height, width), np.float32) for c in channels}

    for off in offsets:
        y, size = struct.unpack_from("<iI", data, off)
        raw = data[off + 8 : off + 8 + size]
        block_lines = min(lines_per_block, ymax - y + 1)
        expected = sum(np.dtype(dt).itemsize for dt in dtypes) * width * block_lines
        if compression in (2, 3) and size < expected:
            raw = _unpredict_deinterleave(zlib.decompress(raw)).tobytes()
        bpos = 0
        for line in range(block_lines):
            for (name, ptype, _, _), dt in zip(channels, dtypes):
                nbytes = np.dtype(dt).itemsize * width
                vals = np.frombuffer(raw, dt, width, bpos)
                out[name][y - ymin + line] = vals.astype(np.float32)
                bpos += nbytes

    order = [c for c in ("R", "G", "B", "A") if c in out]
    if not order:
        order = [c[0] for c in channels]
    return np.stack([out[c] for c in order], axis=-1)


def write_exr(path, img: np.ndarray, half: bool = True):
    """Write (H, W, C) array as scanline EXR with ZIP compression."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = ["R", "G", "B", "A"][:c] if c <= 4 else [f"C{i}" for i in range(c)]
    dt = np.float16 if half else np.float32
    ptype = _PIXEL_CODES[np.dtype(dt)]

    # channels must be stored alphabetically
    order = sorted(range(c), key=lambda i: names[i])

    def attr(name, typ, val):
        return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<I", len(val)) + val

    chlist = b""
    for i in order:
        chlist += names[i].encode() + b"\0" + struct.pack("<iBxxxii", ptype, 0, 1, 1)
    chlist += b"\0"

    header = b""
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([3]))
    header += attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", bytes([0]))
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    lines_per_block = 16
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    blocks = []
    for b in range(n_blocks):
        y0 = b * lines_per_block
        y1 = min(y0 + lines_per_block, h)
        parts = []
        for y in range(y0, y1):
            for i in order:
                parts.append(img[y, :, i].astype(dt).tobytes())
        raw = b"".join(parts)
        comp = zlib.compress(_predict_interleave(np.frombuffer(raw, np.uint8)))
        if len(comp) >= len(raw):
            comp = raw
        blocks.append((y0, comp))

    base = 8 + len(header) + 8 * n_blocks
    offsets = []
    cur = base
    for y0, comp in blocks:
        offsets.append(cur)
        cur += 8 + len(comp)

    with open(path, "wb") as f:
        f.write(struct.pack("<iI", _MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for (y0, comp) in blocks:
            f.write(struct.pack("<iI", y0, len(comp)))
            f.write(comp)
