"""A minimal PNG codec in numpy and ``zlib``, so that scenes load and save
without PIL or imageio.

Reads 8- and 16-bit gray, gray+alpha, RGB and RGBA images, not
interlaced, with any of the five row filters (None, Sub, Up, Average,
Paeth), the forms that PIL, imageio and ``io/synthetic.py`` write (depth
maps are 16-bit gray). Any other PNG (palette or sub-byte samples, Adam7
interlacing) raises ``ValueError``. Writes the same four colour types at 8
bits (uint8 pixels) or 16 (uint16 pixels, big-endian samples) with zlib's
default level, every row with filter 0 unless the caller names another.

None, Sub and Up run a row at a time in numpy (Sub is a cumulative sum
modulo 256 along the row). Average and Paeth depend on the reconstructed
byte to their left, so a row that uses them is reconstructed a byte at a
time in Python.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels, for the colour types this codec reads
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError("PNG: truncated chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        yield kind, body
        pos += 12 + length


def _average_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((left + prior[i]) >> 1)) & 0xFF
    return out


def _paeth_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """(height, 1 + stride) filtered scanlines → (height, stride) uint8."""
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, filt = int(raw[y, 0]), raw[y, 1:]
        if ftype == 0:
            row = filt
        elif ftype == 1:
            row = np.cumsum(filt.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            row = filt + prior
        elif ftype == 3:
            row = np.frombuffer(_average_row(filt.tobytes(), prior.tobytes(), bpp), np.uint8)
        elif ftype == 4:
            row = np.frombuffer(_paeth_row(filt.tobytes(), prior.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {ftype} in row {y}")
        out[y] = row
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, C) uint8 (8-bit) or uint16 (16-bit), C = 1
    (gray), 2 (gray+alpha), 3 (RGB) or 4 (RGBA)."""
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color_type, compression, filter_method, interlace = header
    if depth not in (8, 16) or color_type not in _CHANNELS:
        raise ValueError(f"PNG: bit depth {depth}, colour type {color_type} is not supported "
                         "(8- or 16-bit gray, gray+alpha, RGB or RGBA only)")
    if compression != 0 or filter_method != 0 or interlace != 0:
        raise ValueError(f"PNG: compression {compression}, filter method {filter_method}, "
                         f"interlace {interlace} is not supported")
    channels = _CHANNELS[color_type]
    bpp = channels * depth // 8  # the filters' byte distance: one pixel
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG: {raw.size} bytes of scanlines for a {width}x{height} image")
    pixels = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    return pixels.reshape(height, width, channels)


def _filter_rows(a: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """(H, stride) uint8 → the rows filtered with ``ftype``; the encoder
    knows every original byte, so each filter is one numpy pass."""
    x = a.astype(np.int16)
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    up_left = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    elif ftype == 4:
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    else:
        raise ValueError(f"PNG: unknown filter type {ftype}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(pixels: np.ndarray, filter_type: int = 0) -> bytes:
    """(H, W) or (H, W, C) uint8 or uint16, C in 1..4 → an 8- or 16-bit
    PNG's bytes, every row with ``filter_type`` (0-4)."""
    a = np.asarray(pixels)
    if a.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG: uint8 or uint16 pixels expected, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"PNG: cannot write an image of shape {a.shape}")
    height, width, channels = a.shape
    depth = 8 * a.dtype.itemsize
    row_bytes = a.astype(a.dtype.newbyteorder(">")).view(np.uint8).reshape(height, -1)
    rows = np.concatenate([np.full((height, 1), filter_type, np.uint8),
                           _filter_rows(row_bytes, filter_type, channels * a.dtype.itemsize)],
                          axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, _COLOR_TYPE[channels], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())


def write_png(path, pixels: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(pixels))
