"""Read a flax msgpack file (a JAX run's ``model_*.ckpt``) with neither
flax nor msgpack.

The JAX package saves a checkpoint with ``flax.serialization.to_bytes``
of the agent bundle (``takzero_tpu/utils/ckpt.py``): a msgpack map of
maps whose leaves are numpy arrays.  This module decodes the msgpack
formats flax writes (maps, arrays, strings, binaries, ints, floats,
bools, nil and the ext types) and flax's three ext types:

* 1 ``ndarray``: a nested msgpack ``(shape, dtype name, C-order bytes)``;
* 2 ``native_complex``: a nested ``(real, imag)``, a Python complex;
* 3 ``npscalar``: an ndarray of shape ``()``, returned as its scalar.

Arrays over flax's ``MAX_CHUNK_SIZE`` (2**30 bytes) are saved as
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
maps; :func:`restore` joins them back, as ``flax.serialization.msgpack_restore``
does.  ``bfloat16`` leaves (numpy has no such dtype without ``ml_dtypes``)
come back widened exactly to float32.

:func:`restore` returns what ``msgpack_restore`` returns, leaf for leaf;
``takzero_torch/bridge.py`` turns it into the port's checkpoint entries.
"""

from __future__ import annotations

import struct

import numpy as np

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Bytes that are not a whole msgpack object of the formats above."""


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # strings as bytes (flax's nested ndarray header)

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError(f"truncated msgpack: {n} bytes wanted at offset {self.pos} of {len(self.data)}")
        out = self.data[self.pos : end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, code: int, n: int):
        return _ext(code, bytes(self.take(n)))

    def value(self):
        t = self.unpack("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.text(t & 0x1F)
        if t in _FIXED:
            return _FIXED[t]
        if t in _SCALARS:
            return self.unpack(_SCALARS[t])
        if t in _BIN:
            return bytes(self.take(self.unpack(_BIN[t])))
        if t in _STR:
            return self.text(self.unpack(_STR[t]))
        if t in _ARRAY:
            return [self.value() for _ in range(self.unpack(_ARRAY[t]))]
        if t in _MAP:
            return self.map(self.unpack(_MAP[t]))
        if t in _FIXEXT:
            return self.ext(self.unpack(">b"), _FIXEXT[t])
        if t in _EXT:
            n = self.unpack(_EXT[t])
            return self.ext(self.unpack(">b"), n)
        raise MsgpackError(f"msgpack type byte 0x{t:02x} at offset {self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def unpackb(data: bytes, raw: bool = False):
    """The one msgpack object that ``data`` holds, flax's ext types decoded
    (``msgpack.unpackb(data, ext_hook=flax's, raw=raw)``)."""
    r = _Reader(data, raw)
    out = r.value()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data, raw=True)
    if name == b"bfloat16":  # the upper half of a float32's bits
        wide = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return wide.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape)


def _ext(code: int, data: bytes):
    if code == _NDARRAY:
        return _ndarray(data)
    if code == _COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == _NPSCALAR:
        return _ndarray(data)[()]
    raise MsgpackError(f"msgpack ext type {code} is not one of flax's")


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        return {k: _unchunk_leaves(v) for k, v in d.items()}
    return d


def restore(data: bytes):
    """``flax.serialization.msgpack_restore(data)`` without flax: the state
    dict with numpy leaves, chunked arrays joined."""
    return _unchunk_leaves(unpackb(data))


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file starting with ``head`` may be a msgpack map (flax's
    state dict; a torch.save file starts with a zip header)."""
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in _MAP)
