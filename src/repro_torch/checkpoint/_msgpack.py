"""The subset of MessagePack a checkpoint manifest needs: map, array,
str, int, float, bool and nil.

The reference writes its manifests with the ``msgpack`` package, which
the card's machine does not have; this module writes the same bytes
(``msgpack.packb``'s defaults: the smallest int encoding, floats as
float64, str as UTF-8 str) and reads what ``msgpack.packb`` writes for
those types (float32 included), so each package reads the other's
files. Anything else (bin, ext, timestamps) raises.
"""

from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True:
        out.append(0xc3)
    elif obj is False:
        out.append(0xc2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xa0 | n)
        else:
            _header(n, out, (0xd9, 0xda, 0xdb), with_8bit=True)
        out += data
    elif isinstance(obj, (list, tuple)):
        _length(len(obj), out, 0x90, (0xdc, 0xdd))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _length(len(obj), out, 0x80, (0xde, 0xdf))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} "
                        f"(map, array, str, int, float, bool, nil only)")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xff)
    elif v >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit 64 bits")
    else:
        for code, fmt, bottom in ((0xd0, ">b", -(1 << 7)),
                                  (0xd1, ">h", -(1 << 15)),
                                  (0xd2, ">i", -(1 << 31)),
                                  (0xd3, ">q", -(1 << 63))):
            if v >= bottom:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit 64 bits")


def _header(n: int, out: bytearray, codes, with_8bit: bool) -> None:
    sizes = ((">B", 1 << 8), (">H", 1 << 16), (">I", 1 << 32))
    if not with_8bit:
        sizes = sizes[1:]
    for code, (fmt, top) in zip(codes, sizes):
        if n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit 32 bits")


def _length(n: int, out: bytearray, fix: int, codes) -> None:
    if n < 16:
        out.append(fix | n)
    else:
        _header(n, out, codes, with_8bit=False)


def unpackb(data: bytes):
    obj, end = _unpack(memoryview(bytes(data)), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes")
    return obj


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}


def _unpack(buf: memoryview, i: int):
    code = buf[i]
    i += 1
    if code < 0x80:
        return code, i
    if code >= 0xe0:
        return code - 0x100, i
    if 0x80 <= code <= 0x8f:
        return _map(buf, i, code & 0x0f)
    if 0x90 <= code <= 0x9f:
        return _array(buf, i, code & 0x0f)
    if 0xa0 <= code <= 0xbf:
        return _str(buf, i, code & 0x1f)
    if code == 0xc0:
        return None, i
    if code in (0xc2, 0xc3):
        return code == 0xc3, i
    if code in _FIXED:
        fmt = _FIXED[code]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if code in (0xd9, 0xda, 0xdb):
        n, i = _size(buf, i, code - 0xd9)
        return _str(buf, i, n)
    if code in (0xdc, 0xdd):
        n, i = _size(buf, i, code - 0xdc + 1)
        return _array(buf, i, n)
    if code in (0xde, 0xdf):
        n, i = _size(buf, i, code - 0xde + 1)
        return _map(buf, i, n)
    raise ValueError(f"unsupported MessagePack type byte 0x{code:02x}")


def _size(buf, i, which):
    fmt = (">B", ">H", ">I")[which]
    return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)


def _str(buf, i, n):
    return bytes(buf[i:i + n]).decode("utf-8"), i + n


def _array(buf, i, n):
    out = []
    for _ in range(n):
        item, i = _unpack(buf, i)
        out.append(item)
    return out, i


def _map(buf, i, n):
    out = {}
    for _ in range(n):
        key, i = _unpack(buf, i)
        out[key], i = _unpack(buf, i)
    return out, i
