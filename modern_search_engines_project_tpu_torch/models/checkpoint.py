"""Encoder checkpoints: read ``config.json`` and ``params.msgpack``.

Counterpart of the reference package's ``models/checkpoint.py``
(``load_encoder``, ``latest_step_dir``).  A checkpoint directory holds the
encoder's config as JSON and its parameter tree as msgpack bytes, in the
form the reference's serializer writes: nested maps of str keys whose
leaves are arrays packed as msgpack ext type 1 (an inner msgpack array of
shape, dtype name and raw C-order bytes), numpy scalars as ext type 3,
and arrays over 2^30 bytes split into ``__msgpack_chunked_array__`` maps.

The reader here is pure Python over a ``memoryview`` of the file: array
leaves are numpy views of the file's bytes (no copy), and half-precision
leaves are restored to f32, as the reference restores them.  It needs
neither the reference's serializer nor the ``msgpack`` package.
Writing checkpoints (``save_encoder``) waits for training.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional, Tuple

import numpy as np

from modern_search_engines_project_tpu_torch.models.encoder import EncoderConfig

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Decoder of the msgpack subset the reference's serializer writes:
    nil, bools, ints, floats, str, bin, arrays, maps and ext types 1 and
    3.  ``bin`` payloads come back as memoryview slices."""

    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        a = self.pos
        if a + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        self.pos = a + n
        return self.buf[a : a + n]

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return self._take(self._unpack(">" + "BHI"[b - 0xC4]))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            n = self._unpack(">" + "BHI"[b - 0xC7])
            return self._ext(self._unpack(">b"), n)
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        if 0xCC <= b <= 0xD3:  # uint 8..64, int 8..64
            return self._unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(self._unpack(">b"), 1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self._str(self._unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, name, raw = _Reader(data).value()
        if isinstance(name, memoryview):
            name = str(name, "ascii")
        arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    """Join ``__msgpack_chunked_array__`` maps back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = tree["chunks"]
        flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data) -> dict:
    """msgpack bytes in the reference's checkpoint form -> nested dict of
    numpy leaves (views of ``data`` where no chunk had to be joined)."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes after the tree")
    return _unchunk(tree)


def _f16_to_f32(tree):
    if isinstance(tree, dict):
        return {k: _f16_to_f32(v) for k, v in tree.items()}
    if getattr(tree, "dtype", None) == np.float16:
        return np.asarray(tree).astype(np.float32)
    return tree


def load_encoder(path: str) -> Tuple[dict, EncoderConfig]:
    """(parameter tree, config) of the checkpoint in ``path``; f16 leaves
    come back as f32, every other leaf as stored."""
    with open(os.path.join(path, "config.json")) as f:
        enc_cfg = EncoderConfig(**json.load(f))
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        blob = f.read()
    return _f16_to_f32(restore(blob)), enc_cfg


def latest_step_dir(root: str) -> Optional[str]:
    if not os.path.isdir(root):
        return None
    steps = [
        d for d in os.listdir(root)
        if d.startswith("step_") and d[5:].isdigit()
    ]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=lambda d: int(d[5:])))
