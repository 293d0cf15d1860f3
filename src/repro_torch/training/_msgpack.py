"""A pure-Python codec for the msgpack subset that checkpoints use.

The card's machine has no `msgpack` package, so the port carries its
own encoder and decoder for map, array, str, int, bin, nil, bool and
float64. `packb(obj)` gives the bytes of `msgpack.packb(obj,
use_bin_type=True)` (every value in its shortest form, str as str8 and
up, bytes as bin), and `unpackb(data)` reads what `msgpack.unpackb(data,
raw=False)` reads: arrays become lists, str becomes str, bin becomes
bytes.
"""
from __future__ import annotations

import struct


def _head(small: int, tags: tuple, n: int, small_limit: int) -> bytes:
    """Header of a sized type: fix form below `small_limit`, else the
    first of `tags` (8, 16, 32-bit length; None where the form does not
    exist) whose length field holds `n`."""
    if n < small_limit:
        return bytes([small | n])
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"),
                               (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: size {n} too large")


def _int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for tag, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                (0xce, ">I", 1 << 32),
                                (0xcf, ">Q", 1 << 64)):
            if v < limit:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        for tag, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                (0xd2, ">i", 1 << 31),
                                (0xd3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes([tag]) + struct.pack(fmt, v)
    raise OverflowError(f"msgpack: int {v} out of range")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_head(0xa0, (0xd9, 0xda, 0xdb), len(b), 32))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_head(0, (0xc4, 0xc5, 0xc6), len(b), 0))
        out.append(b)
    elif isinstance(obj, dict):
        out.append(_head(0x80, (None, 0xde, 0xdf), len(obj), 16))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(0x90, (None, 0xdc, 0xdd), len(obj), 16))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int):
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def read(self):
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xe0:
            return t - 0x100
        if t < 0x90:
            return self.map(t & 0x0f)
        if t < 0xa0:
            return self.array(t & 0x0f)
        if t < 0xc0:
            return self.str(t & 0x1f)
        if t == 0xc0:
            return None
        if t in (0xc2, 0xc3):
            return t == 0xc3
        sized = {0xc4: (">B", 1, "bin"), 0xc5: (">H", 2, "bin"),
                 0xc6: (">I", 4, "bin"), 0xd9: (">B", 1, "str"),
                 0xda: (">H", 2, "str"), 0xdb: (">I", 4, "str"),
                 0xdc: (">H", 2, "array"), 0xdd: (">I", 4, "array"),
                 0xde: (">H", 2, "map"), 0xdf: (">I", 4, "map")}
        if t in sized:
            fmt, n, kind = sized[t]
            size = self.unpack(fmt, n)
            if kind == "bin":
                return bytes(self.take(size))
            return getattr(self, kind)(size)
        scalars = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1),
                   0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
                   0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4),
                   0xd3: (">q", 8)}
        if t in scalars:
            return self.unpack(*scalars[t])
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data):
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: extra data after the object")
    return obj
