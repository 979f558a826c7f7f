"""The JAX package's ``<stage>.ckpt``, read with the standard library.

The JAX package writes a checkpoint as ``flax.serialization.
msgpack_serialize({"params": ..., "batch_stats": ...})`` beside a JSON
sidecar ``<stage>.ckpt.json`` (the spec and the run's extras).  Neither
``msgpack`` nor ``flax`` is on the GPU machine, so this module decodes the
subset of msgpack that flax writes:

- nil, bool, ints (fixint, uint8-64, int8-64), float32 / float64, str,
  bin, arrays and maps;
- flax's extension types: 1 ``ndarray`` and 3 ``npscalar``, each a nested
  msgpack ``(shape, dtype name, row-major bytes)`` (a scalar is the 0-d
  array's value), and 2 ``native_complex``, a nested ``(real, imag)``;
- flax's chunked form of an array above 2**30 bytes (a map with
  ``__msgpack_chunked_array__``), joined back as flax joins it.

A ``bfloat16`` array (numpy has no such dtype) comes back as a
``torch.bfloat16`` tensor; every other array as a numpy array, read-only
as flax's ``np.frombuffer`` gives it.  An extension type outside these
three, a byte that starts no msgpack object and a file that ends inside
an object raise ``ValueError`` with what was found: nothing is guessed.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """One msgpack stream; ``raw`` keeps str as bytes (flax decodes the
    ndarray payload so)."""

    def __init__(self, data: bytes, raw: bool = False, what: str = "ckpt"):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.what = what

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(
                f"{self.what}: truncated: an object needs {n} bytes at "
                f"offset {self.pos}, {len(self.data) - self.pos} remain")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)), self.what)

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", self.bin), 0xC5: (">H", self.bin),
                 0xC6: (">I", self.bin), 0xC7: (">B", self.ext),
                 0xC8: (">H", self.ext), 0xC9: (">I", self.ext),
                 0xD9: (">B", self.str), 0xDA: (">H", self.str),
                 0xDB: (">I", self.str), 0xDC: (">H", self.array),
                 0xDD: (">I", self.array), 0xDE: (">H", self.map),
                 0xDF: (">I", self.map)}
        if b in sized:
            fmt, fn = sized[b]
            return fn(self.unpack(fmt))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:                       # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"{self.what}: byte 0x{b:02x} at offset "
                         f"{self.pos - 1} starts no msgpack object")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))


def _one(data: bytes, raw: bool, what: str) -> Any:
    r = _Reader(data, raw=raw, what=what)
    out = r.read()
    if r.pos != len(data):
        raise ValueError(f"{what}: {len(data) - r.pos} bytes after the "
                         "object")
    return out


def _array(payload: bytes, what: str):
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    shape, name, buf = _one(payload, raw=True, what=f"{what} ndarray")
    name = name.decode("ascii")
    if name == "bfloat16":
        import torch
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape,
                                                            order="C")


def _ext(code: int, payload: bytes, what: str):
    if code == EXT_NDARRAY:
        return _array(payload, what)
    if code == EXT_NPSCALAR:
        return _array(payload, what)[()]
    if code == EXT_NATIVE_COMPLEX:
        real, imag = _one(payload, raw=False, what=f"{what} complex")
        return complex(real, imag)
    raise ValueError(f"{what}: msgpack extension type {code} is none of "
                     "flax's (1 ndarray, 2 native_complex, 3 npscalar)")


def _unchunk(node):
    """flax's ``_unchunk_array_leaves_in_place``, on the decoded tree."""
    if isinstance(node, dict):
        if CHUNKED in node:
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        for k, v in node.items():
            if isinstance(v, dict):
                node[k] = _unchunk(v)
    return node


def msgpack_restore(data: bytes, what: str = "ckpt") -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` gives."""
    return _unchunk(_one(bytes(data), raw=False, what=what))


def load_checkpoint(path: str) -> Tuple[Dict, Dict, Dict]:
    """``(params, batch_stats, meta)`` of the JAX package's ``.ckpt`` at
    ``path`` (``meta``: its ``.ckpt.json`` sidecar, {} without one), as
    the JAX package's ``checkpoints.io.load_checkpoint`` returns them."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read(), what=path)
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path}: not a JAX package checkpoint (a map "
                         "with 'params')")
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return payload["params"], payload.get("batch_stats", {}), meta
