"""The msgpack subset that ``CLF_XATTR`` blobs use, without msgpack.

Record extensions carry a msgpack blob (records.py, ``CLF_XATTR``).  The
port must write the bytes ``msgpack.packb(obj)`` writes and read back
what ``msgpack.unpackb(blob)`` reads, so its journals and wire frames
stay byte-identical to the reference's — but the port may not depend on
the ``msgpack`` package.  The subset is the JSON-like one: dict, list
(and tuple, packed as an array), str, bytes (and bytearray/memoryview,
packed as bin), int, float, bool and None.

Encoding follows msgpack's defaults exactly: the smallest integer
format for the value, float64 for floats, ``str8`` and ``bin`` formats
on (``use_bin_type=True``), maps in insertion order.  Decoding follows
``unpackb``'s defaults: strings decode as UTF-8, arrays become lists,
map keys must be str or bytes, trailing bytes are an error.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


def _pack_int(v: int, out: bytearray) -> None:
    if v < -(1 << 5):
        if v < -(1 << 15):
            if v < -(1 << 31):
                if v < -(1 << 63):
                    raise OverflowError("Integer value out of range")
                out += b"\xd3" + _q.pack(v)
            else:
                out += b"\xd2" + _i.pack(v)
        elif v < -(1 << 7):
            out += b"\xd1" + _h.pack(v)
        else:
            out += b"\xd0" + _b.pack(v)
    elif v < (1 << 7):
        out += _B.pack(v & 0xFF)                   # fixint, both signs
    elif v < (1 << 16):
        out += (b"\xcc" + _B.pack(v)) if v < (1 << 8) else \
            (b"\xcd" + _H.pack(v))
    elif v < (1 << 32):
        out += b"\xce" + _I.pack(v)
    elif v < (1 << 64):
        out += b"\xcf" + _Q.pack(v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_cap: int, codes: Tuple[int, ...],
              out: bytearray) -> None:
    """Length prefix of a str/bin/array/map: the fix form when it fits,
    else the 8/16/32-bit forms in ``codes`` (``None`` = form absent)."""
    if fix is not None and n < fix_cap:
        out.append(fix | n)
        return
    c8, c16, c32 = codes
    if c8 is not None and n < (1 << 8):
        out += bytes((c8, n))
    elif n < (1 << 16):
        out += bytes((c16,)) + _H.pack(n)
    elif n < (1 << 32):
        out += bytes((c32,)) + _I.pack(n)
    else:
        raise ValueError("object too large for msgpack")


def _pack(o: Any, out: bytearray) -> None:
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        _pack_int(int(o), out)
    elif isinstance(o, float):
        out += b"\xcb" + _d.pack(o)
    elif isinstance(o, (bytes, bytearray, memoryview)):
        b = bytes(o)
        _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += b
    elif isinstance(o, str):
        b = o.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += b
    elif isinstance(o, dict):
        _pack_len(len(o), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(o, (list, tuple)):
        _pack_len(len(o), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in o:
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(o).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj)`` for the subset above, byte for byte."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _unpack(buf, pos: int) -> Tuple[Any, int]:
    try:
        c = buf[pos]
    except IndexError:
        raise ValueError("truncated msgpack data") from None
    pos += 1
    if c <= 0x7F:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c <= 0xBF:
        return _str(buf, pos, c & 0x1F)
    if 0x90 <= c <= 0x9F:
        return _array(buf, pos, c & 0x0F)
    if 0x80 <= c <= 0x8F:
        return _map(buf, pos, c & 0x0F)
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    fixed = _FIXED.get(c)
    if fixed is not None:
        st = fixed
        _need(buf, pos, st.size)
        return st.unpack_from(buf, pos)[0], pos + st.size
    sized = _SIZED.get(c)
    if sized is None:
        raise ValueError(f"msgpack type byte {c:#04x} is outside the "
                         "supported subset")
    kind, st = sized
    _need(buf, pos, st.size)
    n = st.unpack_from(buf, pos)[0]
    pos += st.size
    if kind == "str":
        return _str(buf, pos, n)
    if kind == "bin":
        _need(buf, pos, n)
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "array":
        return _array(buf, pos, n)
    return _map(buf, pos, n)


def _need(buf, pos: int, n: int) -> None:
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")


def _str(buf, pos: int, n: int) -> Tuple[str, int]:
    _need(buf, pos, n)
    return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n


def _array(buf, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _map(buf, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        if type(k) not in (str, bytes):
            raise ValueError(f"{type(k).__name__} is not allowed for map "
                             "key when strict_map_key=True")
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


_FIXED = {0xCA: _f, 0xCB: _d, 0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
          0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
_SIZED = {0xC4: ("bin", _B), 0xC5: ("bin", _H), 0xC6: ("bin", _I),
          0xD9: ("str", _B), 0xDA: ("str", _H), 0xDB: ("str", _I),
          0xDC: ("array", _H), 0xDD: ("array", _I),
          0xDE: ("map", _H), 0xDF: ("map", _I)}


def unpackb(blob) -> Any:
    """``msgpack.unpackb(blob)`` for the subset above."""
    buf = memoryview(blob).cast("B") if not isinstance(blob, bytes) \
        else blob
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError("extra data after the msgpack object")
    return obj
