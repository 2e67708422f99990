"""Checkpoints: write and read ``config.json`` and ``params.msgpack``.

Counterpart of the reference package's ``models/checkpoint.py``
(``save_encoder``, ``load_encoder``, ``latest_step_dir``) and of the
writers and readers in its ``models/cross_encoder.py`` and
``models/decoder.py``, which use the same form.  A checkpoint directory
holds the model's config as JSON and its
parameter tree as msgpack bytes, in the form the reference's serializer
writes: nested maps of str keys whose leaves are arrays packed as msgpack
ext type 1 (an inner msgpack array of shape, dtype name and raw C-order
bytes), numpy scalars as ext type 3, and arrays over 2^30 bytes split
into ``__msgpack_chunked_array__`` maps.

The reader here is pure Python over a ``memoryview`` of the file: array
leaves are numpy views of the file's bytes (no copy), and half-precision
leaves are restored to f32, as the reference restores them.  The writer
is its mirror and writes the bytes the reference's serializer writes for
the same tree: maps in the tree's own key order, each header in the
shortest form msgpack allows.  Neither needs the reference's serializer
nor the ``msgpack`` package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import tempfile
from typing import Iterator, Optional, Tuple

import numpy as np

from modern_search_engines_project_tpu_torch.models.encoder import EncoderConfig

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
# arrays above this many bytes are written as chunked maps (msgpack limits
# one object to 2^32 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30


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


# ---- the writer --------------------------------------------------------------

# msgpack's integer forms, shortest first: (low, high, struct format)
_INT_FORMS = (
    (0, 0x7F, ">B"), (-0x20, -1, ">b"),
    (0x80, 0xFF, ">BB", 0xCC), (-0x80, -0x21, ">Bb", 0xD0),
    (0x100, 0xFFFF, ">BH", 0xCD), (-0x8000, -0x81, ">Bh", 0xD1),
    (0x10000, 0xFFFFFFFF, ">BI", 0xCE), (-0x80000000, -0x8001, ">Bi", 0xD2),
    (0x100000000, 0xFFFFFFFFFFFFFFFF, ">BQ", 0xCF),
    (-0x8000000000000000, -0x80000001, ">Bq", 0xD3),
)


def _int(n: int) -> bytes:
    for form in _INT_FORMS:
        if form[0] <= n <= form[1]:
            if len(form) == 3:  # fixint: the value is the byte
                return struct.pack(form[2], n)
            return struct.pack(form[2], form[3], n)
    raise OverflowError(f"msgpack: integer {n} out of range")


def _header(n: int, fix: Optional[int], fix_max: int, codes) -> bytes:
    """Length header: a fix form for n <= fix_max where there is one,
    then the 8-, 16- and 32-bit forms (``codes``, None where msgpack has
    no such form)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    tops = (0xFF, 0xFFFF, 0xFFFFFFFF)
    for code, fmt, top in zip(codes, ("B", "H", "I"), tops):
        if code is not None and n <= top:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"msgpack: length {n} too large")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _header(len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB)) + b


def _ndarray_payload(arr: np.ndarray) -> list:
    """(shape, dtype name, C-order bytes) as a msgpack array."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes not supported")
    raw = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    shape = _header(arr.ndim, 0x90, 0x0F, (None, 0xDC, 0xDD))
    return [bytes([0x93]), shape + b"".join(_int(d) for d in arr.shape),
            _str(arr.dtype.name),
            _header(raw.nbytes, None, 0, (0xC4, 0xC5, 0xC6)), raw]


def _ext(code: int, parts: list) -> list:
    n = sum(len(p) if isinstance(p, bytes) else p.nbytes for p in parts)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fixed[n]]) if n in fixed
            else _header(n, None, 0, (0xC7, 0xC8, 0xC9)))
    return [head + struct.pack(">b", code), *parts]


def _chunked(arr: np.ndarray) -> dict:
    """The reference's map for an array over ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i : i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(x) -> Iterator:
    """msgpack parts (bytes and memoryviews) of one value of a tree."""
    if isinstance(x, dict):
        yield _header(len(x), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map key {k!r} is not a str")
            yield _str(k)
            if isinstance(v, np.ndarray) and v.nbytes > MAX_CHUNK_SIZE:
                v = _chunked(v)
            yield from _pack(v)
    elif isinstance(x, np.ndarray):
        yield from _ext(_EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        yield from _ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif isinstance(x, bool):
        yield b"\xc3" if x else b"\xc2"
    elif isinstance(x, int):
        yield _int(x)
    elif isinstance(x, str):
        yield _str(x)
    else:
        raise TypeError(f"msgpack: cannot write {type(x).__name__}")


def to_bytes(tree: dict) -> bytes:
    """msgpack bytes of a nested dict of numpy leaves, as the reference's
    serializer writes them (its ``to_bytes``): the mirror of ``restore``."""
    return b"".join(bytes(p) for p in _pack(tree))


def _cast_sorted(tree, dtype):
    """Every leaf cast to ``dtype``, each map rebuilt with its keys sorted:
    the reference casts with a tree map, which rebuilds maps so."""
    if isinstance(tree, dict):
        return {k: _cast_sorted(tree[k], dtype) for k in sorted(tree)}
    return np.asarray(tree).astype(dtype)


def write_checkpoint(tree: dict, conf: dict, path: str,
                     dtype: Optional[str] = None) -> None:
    """Write ``params.msgpack`` (atomically: a temporary file in ``path``,
    then a rename) and ``config.json`` into ``path``.  With ``dtype``
    (e.g. "float16") every leaf is cast first, as the reference casts it.
    The inverse of ``read_checkpoint``."""
    if dtype is not None:
        tree = _cast_sorted(tree, dtype)
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path)
    with os.fdopen(fd, "wb") as f:
        f.writelines(_pack(tree))
    os.replace(tmp, os.path.join(path, "params.msgpack"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(conf, f)


def save_encoder(params: dict, enc_cfg: EncoderConfig, path: str,
                 dtype: Optional[str] = None) -> None:
    """Save a bi-encoder's reference-form tree (``params_to_reference``)
    and config.  ``dtype="float16"`` halves the file (the flagship
    12L/768d is ~600 MB in f32); ``load_encoder`` restores f32."""
    write_checkpoint(params, dataclasses.asdict(enc_cfg), path, dtype)


# ---- the reader's helpers -----------------------------------------------------


def _f16_to_f32(tree):
    if isinstance(tree, dict):
        return {k: _f16_to_f32(v) for k, v in tree.items()}
    if getattr(tree, "dtype", None) == np.float16:
        return np.asarray(tree).astype(np.float32)
    return tree


def read_checkpoint(path: str) -> Tuple[dict, dict]:
    """(parameter tree, config dict) of the checkpoint in ``path``; f16
    leaves come back as f32, every other leaf as stored.  Encoder,
    cross-encoder and decoder checkpoints share this form."""
    with open(os.path.join(path, "config.json")) as f:
        conf = json.load(f)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        blob = f.read()
    return _f16_to_f32(restore(blob)), conf


def load_encoder(path: str) -> Tuple[dict, EncoderConfig]:
    """(parameter tree, config) of the encoder checkpoint in ``path``."""
    tree, conf = read_checkpoint(path)
    return tree, EncoderConfig(**conf)


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
