"""A standard-library MessagePack writer, the counterpart of
``msgpack_reader.py``: ``packb(obj)`` gives the bytes of
``msgpack.packb(obj, use_bin_type=True)`` for what the live frame stream and
the GPS channel carry — None, bool, int, Python float (always float64,
``0xcb``), str, bytes, list, tuple and dict (in insertion order) — so the
port speaks the JAX package's wire format without ``msgpack`` installed.

Integers take their smallest encoding, as ``msgpack`` picks it; ``str`` is
UTF-8 ``str`` and ``bytes`` is ``bin``. A list or tuple of floats, and a
float64 ndarray (packed as the list of its values), go out as one numpy
structured array of (``0xcb``, big-endian float64) pairs instead of a Python
loop: a frame's local map is 3 x N floats.
"""
from __future__ import annotations

import struct

import numpy as np

_FLOAT_PAIR = np.dtype([("tag", "u1"), ("value", ">f8")])
_BULK = 16          # lists at least this long try the structured-array path

# (upper bound exclusive, prefix, struct format) for non-negative integers
_UINTS = ((1 << 8, 0xcc, ">B"), (1 << 16, 0xcd, ">H"), (1 << 32, 0xce, ">I"),
          (1 << 64, 0xcf, ">Q"))
# (lower bound inclusive, prefix, struct format) for negative integers
_INTS = ((-(1 << 7), 0xd0, ">b"), (-(1 << 15), 0xd1, ">h"),
         (-(1 << 31), 0xd2, ">i"), (-(1 << 63), 0xd3, ">q"))


def _int(v: int, out: list):
    if 0 <= v < 0x80:
        out.append(bytes((v,)))
        return
    if -0x20 <= v < 0:
        out.append(bytes((v & 0xff,)))
        return
    if v >= 0:
        for bound, prefix, fmt in _UINTS:
            if v < bound:
                out.append(bytes((prefix,)) + struct.pack(fmt, v))
                return
    else:
        for bound, prefix, fmt in _INTS:
            if v >= bound:
                out.append(bytes((prefix,)) + struct.pack(fmt, v))
                return
    raise OverflowError(f"integer {v} does not fit MessagePack's 64 bits")


def _header(n: int, small: int, fix_limit: int, wide: tuple, out: list):
    """A length header: fix-format below ``fix_limit``, else the first of
    ``wide`` = ((limit, prefix, fmt), ...) that holds ``n``."""
    if n < fix_limit:
        out.append(bytes((small | n,)))
        return
    for limit, prefix, fmt in wide:
        if n < limit:
            out.append(bytes((prefix,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} is too large for MessagePack")


_STR = ((1 << 8, 0xd9, ">B"), (1 << 16, 0xda, ">H"), (1 << 32, 0xdb, ">I"))
_BIN = ((1 << 8, 0xc4, ">B"), (1 << 16, 0xc5, ">H"), (1 << 32, 0xc6, ">I"))
_ARRAY = ((1 << 16, 0xdc, ">H"), (1 << 32, 0xdd, ">I"))
_MAP = ((1 << 16, 0xde, ">H"), (1 << 32, 0xdf, ">I"))


def _floats(values: np.ndarray, out: list):
    """An array header and one (0xcb, big-endian f8) pair per value."""
    _header(len(values), 0x90, 16, _ARRAY, out)
    pairs = np.empty(len(values), _FLOAT_PAIR)
    pairs["tag"] = 0xcb
    pairs["value"] = values
    out.append(pairs.tobytes())


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _header(len(b), 0xa0, 32, _STR, out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _header(len(b), 0, 0, _BIN, out)
        out.append(b)
    elif isinstance(obj, np.ndarray) and obj.dtype == np.float64 \
            and obj.ndim == 1:
        _floats(obj, out)
    elif isinstance(obj, (list, tuple)):
        if len(obj) >= _BULK and all(type(v) is float for v in obj):
            _floats(np.array(obj, np.float64), out)
            return
        _header(len(obj), 0x90, 16, _ARRAY, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} to "
                        "MessagePack")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the types above."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)
