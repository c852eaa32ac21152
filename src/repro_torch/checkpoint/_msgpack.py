"""The subset of MessagePack that checkpoint arrays files use, in pure
Python (the card machine has no ``msgpack`` package).

:func:`packb` writes what ``msgpack.packb(obj, use_bin_type=True)`` writes,
byte for byte, for nil, bools, ints (-2**63 to 2**64 - 1), floats (always
float 64, msgpack's default), str, bytes (the bin family), lists and tuples
(arrays) and dicts (maps): each value in its smallest encoding, ints
positive in the unsigned family and negative in the signed one, as
msgpack's packer chooses.  :func:`unpackb` reads every one of those
encodings (float 32 and the raw str 8 too), strings decoded as UTF-8 and
arrays as lists, as ``msgpack.unpackb(raw=False)``; it raises
``ValueError`` on truncated data, trailing bytes and the types it does not
cover (ext, timestamps).
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

_B, _H, _I, _Q = (struct.Struct(">" + c) for c in "BHIQ")
_b, _h, _i, _q = (struct.Struct(">" + c) for c in "bhiq")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")
#: the length header of each bin, str, array and map code past the fix
#: forms, and the struct of each fixed-width scalar code
_LENGTHS = {0xc4: _B, 0xc5: _H, 0xc6: _I, 0xd9: _B, 0xda: _H, 0xdb: _I,
            0xdc: _H, 0xdd: _I, 0xde: _H, 0xdf: _I}
_SCALARS = {0xca: _F32, 0xcb: _F64, 0xcc: _B, 0xcd: _H, 0xce: _I, 0xcf: _Q,
            0xd0: _b, 0xd1: _h, 0xd2: _i, 0xd3: _q}


def _head(out: List[bytes], n: int, fix: int, fix_max: int,
          codes: Tuple[int, ...]) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    lengths (``codes``; a ``0`` code means that width is not used)."""
    if n < fix_max:
        out.append(_B.pack(fix | n))
    elif codes[0] and n < 1 << 8:
        out.append(bytes((codes[0], n)))
    elif n < 1 << 16:
        out.append(bytes((codes[1],)) + _H.pack(n))
    elif n < 1 << 32:
        out.append(bytes((codes[2],)) + _I.pack(n))
    else:
        raise ValueError(f"length {n} too long for MessagePack")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        if obj < -(1 << 5):
            if obj < -(1 << 63):
                raise OverflowError(f"int {obj} too small for MessagePack")
            if obj < -(1 << 31):
                out.append(b"\xd3" + _q.pack(obj))
            elif obj < -(1 << 15):
                out.append(b"\xd2" + _i.pack(obj))
            elif obj < -(1 << 7):
                out.append(b"\xd1" + _h.pack(obj))
            else:
                out.append(b"\xd0" + _b.pack(obj))
        elif obj < 1 << 7:
            out.append(_b.pack(obj))
        elif obj < 1 << 8:
            out.append(b"\xcc" + _B.pack(obj))
        elif obj < 1 << 16:
            out.append(b"\xcd" + _H.pack(obj))
        elif obj < 1 << 32:
            out.append(b"\xce" + _I.pack(obj))
        elif obj < 1 << 64:
            out.append(b"\xcf" + _Q.pack(obj))
        else:
            raise OverflowError(f"int {obj} too large for MessagePack")
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), 0, 0, (0xc4, 0xc5, 0xc6))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (0, 0xdc, 0xdd))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (0, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the covered types."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated MessagePack data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def obj(self) -> Any:
        c = self.unpack(_B)
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if c < 0x90:
            return self.map(c & 0x0f)
        if c < 0xa0:
            return self.array(c & 0x0f)
        if c < 0xc0:
            return self.text(c & 0x1f)
        if c == 0xc0:
            return None
        if c in (0xc2, 0xc3):
            return c == 0xc3
        if c in _LENGTHS:
            n = self.unpack(_LENGTHS[c])
            if c <= 0xc6:
                return bytes(self.take(n))
            if c <= 0xdb:
                return self.text(n)
            return self.array(n) if c <= 0xdd else self.map(n)
        if c in _SCALARS:
            return self.unpack(_SCALARS[c])
        raise ValueError(f"unsupported MessagePack type byte 0x{c:02x}")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the covered types."""
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after "
                         "the MessagePack object")
    return obj
