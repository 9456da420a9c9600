"""Read and write the ``params.msgpack`` files of flax, on the standard library.

``flax.serialization.to_bytes(variables)`` (the JAX package's
``UNetModel.save_pretrained``) writes a msgpack map of maps whose leaves are
msgpack ext values: type 1 holds an ndarray, type 3 a numpy scalar, and the
payload of each is itself a msgpack array ``[shape, dtype name, C-order
bytes]``.  This module covers what such files hold (maps, arrays, strings,
ints, floats, bools, nil, bin and those two ext types), so the port loads and
saves the JAX package's bundles unchanged.  ``to_bytes`` picks the same
encodings as msgpack-python, so a tree written here is byte-identical to one
flax writes with the same key order.

``bfloat16`` leaves are read as float32 (exact); numpy has no bfloat16.
Chunked leaves (flax splits arrays above 1 GiB) are refused.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if out.get("__msgpack_chunked_array__"):
            raise ValueError("chunked (> 1 GiB) flax array leaves are not "
                             "supported")
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        arr = _ndarray_from_payload(payload)
        return arr[()] if code == EXT_NPSCALAR else arr


def _ndarray_from_payload(payload: bytes) -> np.ndarray:
    reader = _Reader(payload)
    shape, name, buf = reader.obj()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":  # bf16 bits are the top half of a float32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def from_bytes(data: bytes) -> Any:
    """The tree (dicts, lists, numpy arrays and scalars) held in ``data``."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _pack_uint(n: int) -> bytes:
    if n <= 0x7F:
        return struct.pack("B", n)
    for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                             (0xCE, ">I", 0xFFFFFFFF),
                             (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
        if n <= limit:
            return struct.pack("B", code) + struct.pack(fmt, n)
    raise OverflowError(f"{n} does not fit msgpack's uint64")


def _pack_int(n: int) -> bytes:
    if n >= 0:
        return _pack_uint(n)
    if n >= -32:
        return struct.pack("b", n)
    for code, fmt, limit in ((0xD0, ">b", 0x80), (0xD1, ">h", 0x8000),
                             (0xD2, ">i", 0x80000000),
                             (0xD3, ">q", 0x8000000000000000)):
        if n >= -limit:
            return struct.pack("B", code) + struct.pack(fmt, n)
    raise OverflowError(f"{n} does not fit msgpack's int64")


def _pack_len(n: int, fix_base: int, fix_max: int, codes) -> bytes:
    if fix_base is not None and n <= fix_max:
        return struct.pack("B", fix_base | n)
    for code, fmt, limit in codes:
        if n <= limit:
            return struct.pack("B", code) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack object of length {n} is too large")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARR = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    if n in _FIXEXT:
        head = struct.pack("B", _FIXEXT[n])
    else:
        head = _pack_len(n, None, 0, _EXT)
    return head + struct.pack("b", code) + payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not supported")
    return _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj: Any) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, np.ndarray):
        return _pack_ext(EXT_NDARRAY, _ndarray_payload(obj))
    if isinstance(obj, np.generic):
        return _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_len(len(raw), 0xA0, 31, _STR) + raw
    if isinstance(obj, (bytes, bytearray)):
        return _pack_len(len(obj), None, 0, _BIN) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return (_pack_len(len(obj), 0x90, 15, _ARR)
                + b"".join(_pack(v) for v in obj))
    if isinstance(obj, dict):
        return (_pack_len(len(obj), 0x80, 15, _MAP)
                + b"".join(_pack(k) + _pack(v) for k, v in obj.items()))
    raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def to_bytes(tree: Any) -> bytes:
    """msgpack bytes of a tree of dicts (str keys) with numpy array leaves,
    laid out as ``flax.serialization.to_bytes`` lays it out."""
    return _pack(tree)


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return from_bytes(f.read())


def save(path: str, tree: Any) -> None:
    with open(path, "wb") as f:
        f.write(to_bytes(tree))
