"""Flax's msgpack format in Python and numpy alone: the JAX package's
``.msgpack`` generator exports (``flax.serialization.msgpack_serialize`` of
the param tree, ``ircolor_tpu/train/checkpoint.py:33-72``) without flax,
jax or the ``msgpack`` package, which the card's machine does not have.

What flax 0.12.3 writes and reads: maps (str keys; ``msgpack_serialize``
rebuilds a tree's dicts with sorted keys, and so does this one), str,
bin, int, float (float64), bool, nil and arrays, and two extension types:
1, an ndarray, whose data is the msgpack array ``(shape, dtype name, C
bytes)``; 3, a numpy scalar in the same form. ``bfloat16`` leaves decode
to float32 (exact: numpy has no bfloat16). Flax splits a leaf over 2^30
bytes into chunks (``__msgpack_chunked_array__``); that form raises
``ValueError`` here (no generator leaf comes near it).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ encode --

def _len_header(n: int, fix: int | None, fix_max: int, codes: tuple, what: str) -> bytes:
    """The header of a str, bin, array or map of length ``n``: the fix form
    below ``fix_max`` (where the type has one), else the first of the 8-
    (str, bin), 16- and 32-bit length forms ``codes`` that holds ``n``."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, (nbytes, fmt) in zip(codes, ((1, ">B"), (2, ">H"), (4, ">I"))[-len(codes):]):
        if n < 1 << (8 * nbytes):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {what} of length {n} is too long")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _len_header(n, None, 0, (0xC7, 0xC8, 0xC9), "ext")
    return head + struct.pack(">b", code) + data


def _ndarray_data(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not serializable")
    return msgpack_serialize([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj: Any, out: list) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_pack_int(obj))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        data = obj.encode("utf-8")
        out.append(_len_header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), "str") + data)
    elif t in (bytes, bytearray):
        out.append(_len_header(len(obj), None, 0, (0xC4, 0xC5, 0xC6), "bin") + bytes(obj))
    elif t in (list, tuple):
        out.append(_len_header(len(obj), 0x90, 16, (0xDC, 0xDD), "array"))
        for v in obj:
            _pack(v, out)
    elif t is dict:
        out.append(_len_header(len(obj), 0x80, 16, (0xDE, 0xDF), "map"))
        keys = sorted(obj) if all(type(k) is str for k in obj) else list(obj)
        for k in keys:
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, np.ndarray):
        out.append(_pack_ext(_EXT_NDARRAY, _ndarray_data(obj)))
    elif isinstance(obj, np.generic):
        out.append(_pack_ext(_EXT_NPSCALAR, _ndarray_data(np.asarray(obj))))
    else:
        raise TypeError(f"msgpack: cannot serialize {t.__name__}")


def msgpack_serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize``: ``tree`` (dicts, lists,
    Python scalars, str, bytes, numpy arrays and scalars) as flax's bytes."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# ------------------------------------------------------------------ decode --

def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = _unpackb(data)
    if name == "bfloat16":  # the high half of a float32
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        chunk = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        fmts = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in fmts:
            v = self.unpack(fmts[c])
            return float(v) if c in (0xCA, 0xCB) else v
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                0xC9: ">I"}
        if c in lens:
            n = self.unpack(lens[c])
            if c in (0xC4, 0xC5, 0xC6):
                return self.take(n)
            if c in (0xD9, 0xDA, 0xDB):
                return self.take(n).decode("utf-8")
            if c in (0xDC, 0xDD):
                return [self.read() for _ in range(n)]
            if c in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(n)
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"msgpack: extension type {code} is not one of flax's array types")


def _unpackb(data: bytes) -> Any:
    """The object of msgpack bytes (ndarray leaves read-only, as flax's)."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the object")
    return obj


def _no_chunks(tree: Any) -> None:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError(f"msgpack: a chunked array leaf ({_CHUNKED}, flax's form for leaves "
                             "over 2^30 bytes) is not supported")
        for v in tree.values():
            _no_chunks(v)


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of ``data``."""
    tree = _unpackb(data)
    _no_chunks(tree)
    return tree
