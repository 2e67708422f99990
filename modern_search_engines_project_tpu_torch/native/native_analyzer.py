"""ctypes bridge to the C++ analyzer (``native/analyzer.cpp``).

``load()`` builds ``libmse_analyzer.so`` with g++ at first use into
``<checkout>/build/native/<hash of source and flags>/`` and returns a
``NativeAnalyzer``.  The build is keyed by content, so an edited source
gets a new library, and concurrent builders each write a private file and
rename it into place.  A failed build raises with g++'s output: callers
that asked for the native route never fall back to the Python one
silently (the two routes disagree outside Latin-1).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional

from modern_search_engines_project_tpu_torch.native import build_lib

SRC = Path(__file__).resolve().parent / "analyzer.cpp"
BUILD_ROOT = build_lib.BUILD_ROOT
LIB_NAME = "libmse_analyzer.so"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_cached: Optional["NativeAnalyzer"] = None


def library_path() -> Path:
    return build_lib.library_path(BUILD_ROOT, SRC, LIB_NAME, GXX_FLAGS)


def build() -> Path:
    """Compile ``analyzer.cpp`` unless its library exists; raises
    ``RuntimeError`` with g++'s output when the build fails."""
    return build_lib.build(BUILD_ROOT, SRC, LIB_NAME, GXX_FLAGS,
                           "native analyzer")


class NativeAnalyzer:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.msetpu_analyze.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.msetpu_analyze.restype = ctypes.c_void_p
        lib.msetpu_analyze_counts.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.msetpu_analyze_counts.restype = ctypes.c_void_p
        lib.msetpu_free.argtypes = [ctypes.c_void_p]
        lib.msetpu_free.restype = None
        lib.msetpu_hash_tokenize.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_longlong,
        ]
        lib.msetpu_hash_tokenize.restype = ctypes.POINTER(ctypes.c_longlong)

    def _text_call(self, fn, text: str) -> str:
        data = text.encode("utf-8")
        ptr = fn(data, len(data))
        if not ptr:
            return ""
        try:
            raw = ctypes.cast(ptr, ctypes.c_char_p).value or b""
        finally:
            self._lib.msetpu_free(ptr)
        return raw.decode("utf-8")

    def analyze(self, text: str) -> List[str]:
        out = self._text_call(self._lib.msetpu_analyze, text)
        return out.split("\n")[:-1] if out else []

    def analyze_counts(self, text: str) -> dict:
        """term -> count aggregated in C ("term\\tcount" lines): the BM25
        build only needs counts."""
        out = {}
        for line in self._text_call(
            self._lib.msetpu_analyze_counts, text
        ).splitlines():
            term, _, cnt = line.rpartition("\t")
            out[term] = int(cnt)
        return out

    def hash_tokenize(self, text: str, vocab_size: int):
        """(ids [n] int64, offsets [n, 2] int64 code-point spans), numpy
        arrays copied out of the C buffer before it is freed."""
        import numpy as np

        data = text.encode("utf-8")
        ptr = self._lib.msetpu_hash_tokenize(data, len(data), vocab_size)
        try:
            n = int(ptr[0])
            flat = np.ctypeslib.as_array(ptr, shape=(1 + 3 * n,))
            rows = flat[1:].reshape(n, 3).copy()
        finally:
            self._lib.msetpu_free(ptr)
        return rows[:, 0], rows[:, 1:]


def load() -> NativeAnalyzer:
    """The process-wide native analyzer, built at first use."""
    global _cached
    with _lock:
        if _cached is None:
            _cached = NativeAnalyzer(ctypes.CDLL(str(build())))
        return _cached
