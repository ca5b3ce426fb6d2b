"""A small msgpack codec for the subset that flax's checkpoint files use.

comic_tpu writes compact checkpoints with ``flax.serialization.to_bytes``:
a msgpack map of str keys whose leaves are arrays encoded as ext type 1
(ndarray) or ext type 3 (numpy scalar), each holding a msgpack array
``[shape, dtype_name, raw_bytes]`` (C order, native little-endian). This
module reads and writes that subset — maps, arrays, str, bin, ints, floats,
nil, bool and ext types 1 and 3 — so the port needs neither msgpack nor
flax. Arrays decode to numpy; flax's chunked form for leaves above 1 GiB is
refused.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# --- encoding -------------------------------------------------------------

def _pack_uint_len(out: bytearray, n: int, fix_base: int, fix_max: int,
                   codes: Tuple[int, int, int]) -> None:
    """Header of a str/bin/array/map of length n (codes for 8/16/32-bit
    lengths; a code of 0 means that width does not exist for the type)."""
    if fix_max and n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    else:
        out.append(codes[2])
        out += struct.pack(">I", n)


def _pack_int(out: bytearray, n: int) -> None:
    """The narrowest encoding, as msgpack's own packer (and so flax)
    writes it: a file the port writes is byte for byte comic_tpu's."""
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, bits in ((0xCC, ">B", 8), (0xCD, ">H", 16),
                                (0xCE, ">I", 32), (0xCF, ">Q", 64)):
            if n < 1 << bits:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit msgpack")
    else:
        for code, fmt, bits in ((0xD0, ">b", 8), (0xD1, ">h", 16),
                                (0xD2, ">i", 32), (0xD3, ">q", 64)):
            if n >= -(1 << (bits - 1)):
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += bytes((0xC7, n))
    elif n < 1 << 16:
        out.append(0xC8)
        out += struct.pack(">H", n)
    else:
        out.append(0xC9)
        out += struct.pack(">I", n)
    out.append(code)
    out += data


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise ValueError(f"dtype {arr.dtype} cannot be serialized")
    arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_uint_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_uint_len(out, len(obj), 0, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_uint_len(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for x in obj:
            _pack(out, x)
    elif isinstance(obj, dict):
        _pack_uint_len(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        for key, x in obj.items():
            _pack(out, key)
            _pack(out, x)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """obj (nested dict/list of the supported leaves) -> msgpack bytes."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# --- decoding -------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos: self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED_EXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {  # code -> (kind, length format)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


def _decode_array(payload: bytes, scalar: bool):
    shape, dtype_name, raw = unpackb(payload)
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported by this codec")
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)
    return arr[()] if scalar else arr.copy()


def _read(r: _Reader) -> Any:
    code = r.unpack(">B")
    if code <= 0x7F:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0x80 <= code <= 0x8F:
        return _read_map(r, code & 0x0F)
    if 0x90 <= code <= 0x9F:
        return [_read(r) for _ in range(code & 0x0F)]
    if 0xA0 <= code <= 0xBF:
        return str(r.take(code & 0x1F), "utf-8")
    if code == 0xC0:
        return None
    if code in (0xC2, 0xC3):
        return code == 0xC3
    if code in _NUMBERS:
        return r.unpack(_NUMBERS[code])
    if code in _FIXED_EXT or code in _SIZED and _SIZED[code][0] == "ext":
        n = (_FIXED_EXT[code] if code in _FIXED_EXT
             else r.unpack(_SIZED[code][1]))
        ext = r.unpack(">B")
        payload = bytes(r.take(n))
        if ext in (EXT_NDARRAY, EXT_NPSCALAR):
            return _decode_array(payload, scalar=ext == EXT_NPSCALAR)
        raise ValueError(f"unsupported msgpack ext type {ext}")
    if code in _SIZED:
        kind, fmt = _SIZED[code]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return str(r.take(n), "utf-8")
        if kind == "array":
            return [_read(r) for _ in range(n)]
        return _read_map(r, n)
    raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    if "__msgpack_chunked_array__" in out:
        raise ValueError("chunked (>1 GiB) arrays are not supported")
    return out


def unpackb(data: bytes) -> Any:
    """msgpack bytes -> nested dict/list with numpy array leaves."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj
