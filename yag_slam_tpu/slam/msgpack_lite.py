"""The subset of MessagePack that checkpoints use, with no dependency.

`packb` writes the same bytes as msgpack-python's `packb` with its default
options (`use_bin_type=True`, doubles for every float) for the types
`slam.serde` emits: None, bool, int, float, str, bytes, list/tuple and
dict.  `unpackb` reads what msgpack-python's `unpackb` reads with its
default options (`raw=False`: str stays str, arrays become lists), minus
extension types.  So checkpoints stay byte-compatible with the reference's
msgpack/zlib files (reference yag_slam/graph_slam.py:77-105) whether
or not msgpack-python is installed.
"""
from __future__ import annotations

import struct

_INT_FORMATS = (
    # (lower bound, upper bound, type byte, struct format), tried in order
    (0, 0xFF, 0xCC, ">B"),
    (0, 0xFFFF, 0xCD, ">H"),
    (0, 0xFFFFFFFF, 0xCE, ">I"),
    (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
    (-0x80, -1, 0xD0, ">b"),
    (-0x8000, -1, 0xD1, ">h"),
    (-0x80000000, -1, 0xD2, ">i"),
    (-0x8000000000000000, -1, 0xD3, ">q"),
)


def _pack_len(out, n, fix_tag, fix_max, tags):
    """Length header: a fix form below `fix_max`, else the 8/16/32-bit form
    from `tags` (None where the format has no 8-bit form)."""
    if n < fix_max:
        out.append(fix_tag | n)
        return
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (0x100, 0x10000,
                                                           1 << 32)):
        if tag is not None and n < limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object too large: {n}")


def _pack(obj, out):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if -32 <= obj < 128:
            out += struct.pack(">b", obj) if obj < 0 else bytes((obj,))
            return
        for lo, hi, tag, fmt in _INT_FORMATS:
            if lo <= obj <= hi:
                out.append(tag)
                out += struct.pack(fmt, obj)
                return
        raise OverflowError(f"integer out of msgpack range: {obj}")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), 0, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {
    # type byte -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {
    # type byte -> (kind, length-field format, size)
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n):
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        chunk = self.buf[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt, n):
        return struct.unpack(fmt, self.take(n))[0]

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self._map(b & 0x0F)
        if b < 0xA0:
            return [self.read() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _LEN:
            kind, fmt, size = _LEN[b]
            n = self.unpack(fmt, size)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.read() for _ in range(n)]
            return self._map(n)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"map key of type {type(k).__name__}")
            out[k] = self.read()
        return out


def unpackb(data):
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError("extra data after the msgpack object")
    return obj
