"""A reader of the msgpack files that flax's ``msgpack_serialize`` writes
(the ``sls_tpu`` checkpoints), in pure Python: no msgpack package and no
flax.

What it reads: msgpack maps (string keys), arrays (as lists), str, bin,
ints, floats, nil and bool, and flax's extension types:

- ext 1, an ndarray: a packed ``(shape, dtype name, bytes)``, returned as
  a read-only numpy array over the file's bytes, or, for ``bfloat16``
  (which numpy lacks), as a torch tensor;
- ext 2, a Python complex: a packed ``(real, imag)``;
- ext 3, a numpy scalar: an ndarray of shape ().

Maps that flax wrote for arrays too large for one msgpack object
(``__msgpack_chunked_array__``) are joined back into the array.
Anything else (other extension types, non-string keys, trailing bytes)
raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

_FIXED = {  # type byte -> (struct format, size) of fixed-width numbers
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """One pass over a msgpack buffer.  ``raw`` keeps strings as bytes and
    bin as a view of the buffer (flax's ndarray payloads are read so,
    without copying their data)."""

    def __init__(self, buf, raw: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def text(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def obj(self) -> Any:
        t = self.uint(1)
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.text(t & 0x1F)
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in (0xC4, 0xC5, 0xC6):
            b = self.take(self.uint(1 << (t - 0xC4)))
            return b if self.raw else bytes(b)
        if t in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (t - 0xC7))
            return self.ext(struct.unpack(">b", self.take(1))[0], self.take(n))
        if t in _FIXED:
            fmt, n = _FIXED[t]
            return struct.unpack(fmt, self.take(n))[0]
        if t in _FIXEXT:
            code = struct.unpack(">b", self.take(1))[0]
            return self.ext(code, self.take(_FIXEXT[t]))
        if t in (0xD9, 0xDA, 0xDB):
            return self.text(self.uint(1 << (t - 0xD9)))
        if t in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.uint(2 if t == 0xDC else 4))]
        if t in (0xDE, 0xDF):
            return self.map(self.uint(2 if t == 0xDE else 4))
        raise ValueError(f"msgpack: unknown type byte 0x{t:02x} at {self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack: map key of type {type(key).__name__}")
            out[key] = self.obj()
        return out

    def ext(self, code: int, data: memoryview) -> Any:
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_COMPLEX:
            re_, im = unpack(data)
            return complex(re_, im)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"msgpack: unknown extension type {code}")


def _ndarray(data: memoryview):
    """flax's ndarray payload: (shape, dtype name, C-order bytes)."""
    shape, name, buf = unpack(data, raw=True)
    shape = tuple(shape)
    if name == b"bfloat16":
        if not len(buf):
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def unpack(data, raw: bool = False) -> Any:
    """The one object that ``data`` holds."""
    r = _Reader(data, raw)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return out


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if torch.is_tensor(chunks[0]):  # bfloat16
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(d: Any) -> Any:
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        return {k: _unchunk_tree(v) for k, v in d.items()}
    return d


def restore(data) -> Any:
    """The tree of a ``flax.serialization.msgpack_serialize`` blob, as
    ``flax.serialization.msgpack_restore`` gives it (bfloat16 leaves as
    torch tensors)."""
    return _unchunk_tree(unpack(data))


def read(path) -> Any:
    """``restore`` of a file."""
    with open(path, "rb") as f:
        return restore(f.read())

