"""A standard-library MessagePack reader, enough for the blobs
``flax.serialization.to_bytes`` writes (the JAX package's checkpoints), so
the port reads them with neither ``msgpack`` nor ``flax`` installed.

``unpackb`` decodes the whole format (nil, booleans, integers, floats, str,
bin, arrays, maps and ext types); ``ext_hook(code, data)`` turns an ext
payload into a value. ``restore_flax`` adds flax's own layer on top: ext 1
(ndarray) and ext 3 (numpy scalar) as ``msgpack((shape, dtype name,
bytes))``, and the chunked arrays ``{'__msgpack_chunked_array__': True,
'shape', 'chunks'}`` that flax writes for leaves over its
``MAX_CHUNK_SIZE``. Arrays view the blob's bytes (read-only, no copy).
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1       # flax.serialization._MsgpackExtType.ndarray
EXT_NPSCALAR = 3      # flax.serialization._MsgpackExtType.npscalar
CHUNKED = "__msgpack_chunked_array__"

# fixed-width formats by first byte: (struct format, width)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# length-prefixed kinds by first byte: (kind, width of the length)
_SIZED = {0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4),
          0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4),
          0xde: ("map", 2), 0xdf: ("map", 4)}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data, ext_hook):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated MessagePack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.container("map", b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.container("array", b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if 0xd4 <= b <= 0xd8:                  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xd4))
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.unpack(_LEN[width], width)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "ext":
                return self.ext(n)
            return self.container(kind, n)
        raise ValueError(f"byte 0x{b:02x} starts no MessagePack value")

    def ext(self, n: int):
        code = self.unpack(">b", 1)
        return self.ext_hook(code, self.take(n))

    def container(self, kind: str, n: int):
        if kind == "array":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data, ext_hook=None):
    """Decode one MessagePack value; bin values come back as memoryviews
    of ``data``. An ext type without a hook raises."""
    def no_hook(code, payload):
        raise ValueError(f"MessagePack ext type {code} has no decoder")

    r = _Reader(data, ext_hook or no_hook)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the value")
    return out


def _ndarray(payload) -> np.ndarray:
    shape, dtype_name, raw = unpackb(payload)
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported")
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)


def _flax_ext(code: int, payload):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"flax MessagePack ext type {code} is not supported")


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``, returning a new tree; its
    tuples are maps keyed '0', '1', ..."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED):
        def seq(d):
            return [d[str(i)] for i in range(len(d))]
        shape = tuple(int(s) for s in seq(tree["shape"]))
        return np.concatenate(seq(tree["chunks"])).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore_flax(blob):
    """``flax.serialization.msgpack_restore`` without flax: the state dict
    of a ``to_bytes`` blob, with numpy leaves."""
    return _unchunk(unpackb(blob, _flax_ext))
