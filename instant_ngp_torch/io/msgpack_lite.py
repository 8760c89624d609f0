"""A small msgpack codec in pure Python, for ``.ingp`` snapshots.

``packb`` encodes as ``msgpack.packb(obj, use_bin_type=True)`` does, byte
for byte, for the types that snapshots hold: None, bool, int in the
smallest form that holds it, float as float64 (``inf`` and ``-inf``
included), str, bytes as bin8/16/32, list and tuple as arrays, and dict as a
map in insertion order. Anything else raises ``TypeError``.

``unpackb`` decodes to what ``msgpack.unpackb(data, raw=False,
strict_map_key=False)`` gives: str as ``str``, bin as ``bytes``, arrays as
lists and maps as dicts. It covers the type codes that snapshots use —
nil, bool, int and uint of every width, float32/64, str8/16/32,
bin8/16/32, array16/32, map16/32 and the fix* forms — and raises
``ValueError`` on anything else (ext types, the reserved 0xc1) and on
truncated or trailing data.
"""

from __future__ import annotations

import struct

_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated data at byte {self.pos}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def value(self):
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.map_(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return [self.value() for _ in range(code & 0x0F)]
        if 0xA0 <= code <= 0xBF:
            return self.str_(code & 0x1F)
        if code == 0xC0:
            return None
        if code == 0xC2:
            return False
        if code == 0xC3:
            return True
        if code in _FIXED:
            return self.unpack(_FIXED[code])
        if code in _STR:
            return self.str_(self.unpack(_STR[code]))
        if code in _BIN:
            return bytes(self.take(self.unpack(_BIN[code])))
        if code in _ARRAY:
            return [self.value() for _ in range(self.unpack(_ARRAY[code]))]
        if code in _MAP:
            return self.map_(self.unpack(_MAP[code]))
        raise ValueError(f"msgpack: unsupported type code 0x{code:02x} at byte {self.pos - 1}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes):
    """Decode one msgpack object that spans all of ``data``."""
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} trailing bytes")
    return obj


# (limit, type code, struct format) of the sized forms, smallest first
_UINTS = ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I"),
          (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"))
_INTS = ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"), (-0x80000000, 0xD2, ">i"),
         (-0x8000000000000000, 0xD3, ">q"))
_STR_HEADS = ((0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"), (0xFFFFFFFF, 0xDB, ">I"))
_BIN_HEADS = ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"), (0xFFFFFFFF, 0xC6, ">I"))
_ARRAY_HEADS = ((0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I"))
_MAP_HEADS = ((0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I"))


def _sized(out: list, n: int, forms, what: str) -> None:
    for limit, code, fmt in forms:
        if n <= limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: {what} of {n} is too large")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -0x20 <= obj < 0:  # positive and negative fixint
            out.append(struct.pack(">b" if obj < 0 else ">B", obj))
        elif obj >= 0:
            _sized(out, obj, _UINTS, "int")
        else:
            for limit, code, fmt in _INTS:
                if obj >= limit:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
            else:
                raise ValueError(f"msgpack: int {obj} is too large")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        if len(raw) < 32:
            out.append(bytes([0xA0 | len(raw)]))
        else:
            _sized(out, len(raw), _STR_HEADS, "str")
        out.append(raw)
    elif type(obj) in (bytes, bytearray, memoryview):
        raw = bytes(obj)
        _sized(out, len(raw), _BIN_HEADS, "bin")
        out.append(raw)
    elif type(obj) in (list, tuple):
        if len(obj) < 16:
            out.append(bytes([0x90 | len(obj)]))
        else:
            _sized(out, len(obj), _ARRAY_HEADS, "array")
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        if len(obj) < 16:
            out.append(bytes([0x80 | len(obj)]))
        else:
            _sized(out, len(obj), _MAP_HEADS, "map")
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode ``obj`` as ``msgpack.packb(obj, use_bin_type=True)`` does."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)
