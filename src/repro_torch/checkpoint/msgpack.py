"""A small MessagePack codec: the part of the format that checkpoints use.

``packb(obj)`` gives the bytes ``msgpack.packb(obj)`` gives at msgpack
1.x's defaults (``use_bin_type=True``, floats as float64) for nil, bools,
ints, floats, str, bytes, lists and tuples (arrays) and dicts (maps, in
their own key order); ``unpackb(data)`` reads them back as
``msgpack.unpackb(data, strict_map_key=False)`` does: arrays as lists, str
as str, bin as bytes, and map keys of any type.  Ints use the smallest
form that holds them (fixints, then uint8..64 for positive values and
int8..64 for negative ones), str the fixstr, str8, str16 or str32 form, bin
bin8, bin16 or bin32, arrays and maps their fix, 16 or 32 form.

A value the format cannot hold raises: an int outside [-2^63, 2^64 - 1]
(``OverflowError``, as msgpack's), or a str, bin, array or map of 2^32
items or bytes or more (``ValueError``).  Nothing is split or widened.
"""
from __future__ import annotations

import struct
from typing import Any, List

_BIN_KINDS = (bytes, bytearray, memoryview)
_LEN32 = 1 << 32


def _length(n: int, what: str) -> int:
    if n >= _LEN32:
        raise ValueError(f"{what} of {n} items or bytes: MessagePack holds "
                         f"at most {_LEN32 - 1}")
    return n


def _int(x: int, out: List[bytes]) -> None:
    if x < -32:
        if x < -(1 << 15):
            if x < -(1 << 31):
                if x < -(1 << 63):
                    raise OverflowError("Integer value out of range")
                out.append(struct.pack(">Bq", 0xD3, x))
            else:
                out.append(struct.pack(">Bi", 0xD2, x))
        elif x < -(1 << 7):
            out.append(struct.pack(">Bh", 0xD1, x))
        else:
            out.append(struct.pack(">Bb", 0xD0, x))
    elif x < 128:
        out.append(struct.pack(">b", x))
    elif x < (1 << 8):
        out.append(struct.pack(">BB", 0xCC, x))
    elif x < (1 << 16):
        out.append(struct.pack(">BH", 0xCD, x))
    elif x < (1 << 32):
        out.append(struct.pack(">BI", 0xCE, x))
    elif x < (1 << 64):
        out.append(struct.pack(">BQ", 0xCF, x))
    else:
        raise OverflowError("Integer value out of range")


def _header(n: int, fix: int, fix_max: int, codes, out: List[bytes],
            what: str) -> None:
    """The length header of a str, bin, array or map: its fix form below
    ``fix_max`` (when it has one), else the 8-, 16- or 32-bit form of
    ``codes`` (an 8-bit code of None means the kind has none)."""
    _length(n, what)
    c8, c16, c32 = codes
    if n < fix_max:
        out.append(bytes((fix | n,)))
    elif c8 is not None and n < (1 << 8):
        out.append(struct.pack(">BB", c8, n))
    elif n < (1 << 16):
        out.append(struct.pack(">BH", c16, n))
    else:
        out.append(struct.pack(">BI", c32, n))


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(int(obj), out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out, "str")
        out.append(raw)
    elif isinstance(obj, _BIN_KINDS):
        raw = obj if isinstance(obj, bytes) else bytes(obj)
        _header(len(raw), 0, 0, (0xC4, 0xC5, 0xC6), out, "bin")
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out, "array")
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out, "map")
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` in MessagePack, byte for byte ``msgpack.packb(obj)``."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("MessagePack data ends inside a value")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# Fixed-width codes: code -> struct format of the value that follows.
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# Sized codes: code -> (kind, struct format of its length).
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(r: _Reader) -> Any:
    code = r.take(1)[0]
    if code <= 0x7F:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code == 0xC0:
        return None
    elif code in (0xC2, 0xC3):
        return code == 0xC3
    elif code in _SCALARS:
        return r.unpack(_SCALARS[code])
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"MessagePack code 0x{code:02x} is not supported "
                         "(extension types and the reserved code)")
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        key = _unpack(r)
        out[key] = _unpack(r)
    return out


def unpackb(data) -> Any:
    """The object that ``data`` holds, as ``msgpack.unpackb(data,
    strict_map_key=False)`` reads it; raises on trailing bytes."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the "
                         "MessagePack value")
    return obj
