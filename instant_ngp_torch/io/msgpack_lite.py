"""A small msgpack decoder in pure Python, for reading ``.ingp`` snapshots.

It decodes to what ``msgpack.unpackb(data, raw=False,
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
