"""ctypes bridge to the native host finishing pass (``native/finish.cpp``).

``Finisher`` holds one index's side of the pass (the result permutation,
the per-doc domain and base-url codes, each doc's first window) and
finishes a whole batch of ranked candidate rows in one foreign call.
``load()`` builds ``libmse_finish.so`` with g++ at first use, as
``native_analyzer.py`` builds its library (``build_lib``), and raises with
g++'s output when the build fails.  The library is loaded with
``ctypes.CDLL``, so the interpreter lock is released for the whole call
and another thread runs Python meanwhile.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from modern_search_engines_project_tpu_torch.native import build_lib

SRC = Path(__file__).resolve().parent / "finish.cpp"
BUILD_ROOT = build_lib.BUILD_ROOT
LIB_NAME = "libmse_finish.so"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_ERRORS = {
    1: "a domain or base-url code outside its table",
    2: "more rows selected than the output holds",
    3: "a backfill with no row kept",
}


def library_path() -> Path:
    return build_lib.library_path(BUILD_ROOT, SRC, LIB_NAME, GXX_FLAGS)


def build() -> Path:
    """Compile ``finish.cpp`` unless its library exists; raises
    ``RuntimeError`` with g++'s output when the build fails."""
    return build_lib.build(BUILD_ROOT, SRC, LIB_NAME, GXX_FLAGS,
                           "native finish")


def load() -> ctypes.CDLL:
    """The process-wide library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, p = ctypes.c_int64, ctypes.c_void_p
            lib.msetpu_finish_batch.argtypes = [
                i64, i64, p, p, p, p, p,  # n_rows, k_ret, doc..valid
                p, i64, p, i64, p, i64,  # perm, domain and base codes
                p, i64, i64,  # doc_chunk_start, n_docs_real, n_wins
                i64, ctypes.c_double, ctypes.c_int, i64,  # top_k .. width
                p, p, p, p, p,  # out_count, out_doc, out_score, out_old, out_win
            ]
            lib.msetpu_finish_batch.restype = ctypes.c_int
            _lib = lib
        return _lib


class Finished(NamedTuple):
    """One finished batch: query b selected ``count[b]`` rows, the first
    entries of row b of each [n, width] array, in final order."""

    count: np.ndarray  # [n] int64
    doc: np.ndarray  # [n, width] int64, artifact doc index
    score: np.ndarray  # [n, width] float64, after any backfill shift
    old: np.ndarray  # [n, width] float32, normalised BM25
    win: np.ndarray  # [n, width] int32, global window index


def _codes(codes, n_docs: int, name: str):
    codes = np.ascontiguousarray(codes, np.int64)
    if codes.ndim != 1 or codes.size < n_docs:
        raise ValueError(f"{name}: {codes.shape} codes for {n_docs} docs")
    if codes.size and codes.min() < 0:
        raise ValueError(f"{name}: negative code")
    return codes, int(codes.max()) + 1 if codes.size else 0


class Finisher:
    """The finishing pass over one index (``SearchEngine``'s): dedup by
    query-stripped url, then two-tier domain diversification, for every
    query of a batch at once.  Keeps no state between calls, so threads
    may call ``run`` at once."""

    def __init__(self, perm, domain_codes, base_codes, doc_chunk_start,
                 n_docs_real: int, n_wins: int):
        self._lib = load()
        self.n_docs = int(n_docs_real)
        self.n_wins = int(n_wins)
        self._perm = (None if perm is None
                      else np.ascontiguousarray(perm, np.int64))
        self._dom, self._n_dom = _codes(domain_codes, self.n_docs,
                                        "domain codes")
        self._base, self._n_base = _codes(base_codes, self.n_docs,
                                          "base-url codes")
        self._start = np.ascontiguousarray(doc_chunk_start, np.int32)
        if self._start.size < self.n_docs:
            raise ValueError("doc_chunk_start shorter than the docs")

    def run(self, raw, n_real: int, top_k: int, threshold: float,
            diversification: bool, first_window: bool) -> Finished:
        """Finish the first ``n_real`` queries of ``raw`` = (doc, fused,
        bm25_norm, win, valid), each [B, k_ret] as ``rank_batch`` returns
        them.  ``first_window``: a window outside the index becomes its
        doc's first (the data plane's fragments are per window)."""
        doc, vals, old, win, valid = raw
        shape = np.shape(doc)
        if len(shape) != 2 or any(np.shape(x) != shape
                                  for x in (vals, old, win, valid)):
            raise ValueError(f"finish: ragged batch {[np.shape(x) for x in raw]}")
        if not 0 <= n_real <= shape[0]:
            raise ValueError(f"finish: {n_real} queries of {shape[0]} rows")
        k_ret = shape[1]
        ins = (np.ascontiguousarray(doc, np.int32),
               np.ascontiguousarray(vals, np.float32),
               np.ascontiguousarray(old, np.float32),
               np.ascontiguousarray(win, np.int32),
               np.ascontiguousarray(valid, np.bool_).view(np.uint8))
        width = min(top_k, k_ret) if top_k >= 0 else k_ret
        out = Finished(np.zeros(n_real, np.int64),
                       np.empty((n_real, width), np.int64),
                       np.empty((n_real, width), np.float64),
                       np.empty((n_real, width), np.float32),
                       np.empty((n_real, width), np.int32))
        perm = self._perm
        rc = self._lib.msetpu_finish_batch(
            n_real, k_ret, *(a.ctypes.data for a in ins),
            None if perm is None else perm.ctypes.data,
            0 if perm is None else perm.size,
            self._dom.ctypes.data, self._n_dom,
            self._base.ctypes.data, self._n_base,
            self._start.ctypes.data if first_window else None,
            self.n_docs, self.n_wins,
            int(top_k), float(threshold), int(bool(diversification)), width,
            *(a.ctypes.data for a in out),
        )
        if rc != 0:
            raise RuntimeError(f"native finish: {_ERRORS.get(rc, rc)}")
        return out
