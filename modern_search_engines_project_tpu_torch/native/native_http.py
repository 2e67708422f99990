"""ctypes bridge to the C++ data plane (``native/http_server.cpp``).

Counterpart of the reference package's ``native/native_http.py``.
``load_lib()`` builds ``libmse_http.so`` with g++ at first use into
``<checkout>/build/native/<hash of source and flags>/`` (the pattern of
``native_analyzer.py``: keyed by content, written privately and renamed
into place) and raises with g++'s output when the build fails.

``FastHttpServer`` wraps the C ABI: create -> load_fragments ->
(set_stub | set_rank_fn) -> start -> ... -> stop.  The rank callback
crosses into Python holding the GIL (ctypes CFUNCTYPE acquires it); the
engine's device waits release it, so ``pipeline`` dispatcher threads keep
that many batches in flight.

``client_bench`` is the epoll load generator (run it from a separate
process, so client and server do not share an interpreter).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import threading
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from modern_search_engines_project_tpu_torch.native import build_lib
from modern_search_engines_project_tpu_torch.utils.timing import (
    StageTimes,
    stage_timer,
)

SRC = Path(__file__).resolve().parent / "http_server.cpp"
BUILD_ROOT = build_lib.BUILD_ROOT
LIB_NAME = "libmse_http.so"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

RANK_CB = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_char_p),  # queries
    ctypes.c_int,  # n
    ctypes.c_int,  # top_k
    ctypes.POINTER(ctypes.c_int32),  # out_idx [n*top_k]
    ctypes.POINTER(ctypes.c_float),  # out_scores [n*top_k]
    ctypes.POINTER(ctypes.c_int32),  # out_counts [n]
    ctypes.c_void_p,  # user
)


def library_path() -> Path:
    return build_lib.library_path(BUILD_ROOT, SRC, LIB_NAME, GXX_FLAGS)


def build() -> Path:
    """Compile ``http_server.cpp`` unless its library exists; raises
    ``RuntimeError`` with g++'s output when the build fails."""
    return build_lib.build(BUILD_ROOT, SRC, LIB_NAME, GXX_FLAGS,
                           "native http")


def load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.msetpu_http_create.argtypes = [ctypes.c_int] * 5
        lib.msetpu_http_create.restype = ctypes.c_void_p
        lib.msetpu_http_set_rank_callback.argtypes = [
            ctypes.c_void_p, RANK_CB, ctypes.c_void_p,
        ]
        lib.msetpu_http_set_pipeline.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.msetpu_http_set_stub.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.msetpu_http_load_fragments.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
        ]
        lib.msetpu_http_start.argtypes = [ctypes.c_void_p]
        lib.msetpu_http_start.restype = ctypes.c_int
        lib.msetpu_http_stop.argtypes = [ctypes.c_void_p]
        lib.msetpu_http_destroy.argtypes = [ctypes.c_void_p]
        lib.msetpu_http_stats_json.argtypes = [ctypes.c_void_p]
        lib.msetpu_http_stats_json.restype = ctypes.c_void_p
        lib.msetpu_http_free.argtypes = [ctypes.c_void_p]
        lib.msetpu_http_client_bench.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.msetpu_http_client_bench.restype = ctypes.c_void_p
        lib.msetpu_http_client_bench_multi.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_long,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int,
        ]
        lib.msetpu_http_client_bench_multi.restype = ctypes.c_void_p
        _lib = lib
        return lib


def _take_json(lib, ptr) -> dict:
    if not ptr:
        return {}
    try:
        raw = ctypes.cast(ptr, ctypes.c_char_p).value or b"{}"
    finally:
        lib.msetpu_http_free(ptr)
    return json.loads(raw.decode("utf-8", "replace"))


class FastHttpServer:
    """C++ epoll server for POST /api/search + GET /api/health."""

    def __init__(
        self,
        port: int,
        n_threads: int = 1,
        max_batch: int = 64,
        batch_window_us: int = 200,
        default_top_k: int = 100,
        pipeline: int = 1,
    ):
        """``pipeline`` = concurrent dispatcher threads; >1 keeps that many
        device batches in flight (the rank callback's device wait releases
        the GIL, so the next batch preps and launches during the wait)."""
        self._lib = load_lib()
        self._h = self._lib.msetpu_http_create(
            port, n_threads, max_batch, batch_window_us, default_top_k
        )
        if pipeline and pipeline > 1:
            self._lib.msetpu_http_set_pipeline(self._h, int(pipeline))
        self.port = port
        self._cb_refs: list = []  # keep every CFUNCTYPE object alive
        self._frag_buf = None

    def load_fragments(self, fragments: Sequence[bytes]) -> None:
        """fragments[chunk_idx] = pre-escaped inner JSON bytes
        (b'\"url\": ..., \"title\": ..., ..., \"doc_id\": \"7\"')."""
        arr = (ctypes.c_char_p * len(fragments))(*fragments)
        self._frag_buf = arr  # C++ copies, but keep until the call returns
        self._lib.msetpu_http_load_fragments(self._h, arr, len(fragments))

    def set_stub(self, idx: Sequence[int], scores: Sequence[float]) -> None:
        k = len(idx)
        ia = (ctypes.c_int32 * k)(*idx)
        sa = (ctypes.c_float * k)(*scores)
        self._lib.msetpu_http_set_stub(self._h, ia, sa, k)

    def set_rank_fn(
        self,
        fn: Callable[[List[str], int], List[List[tuple]]],
        times: Optional[Callable[[], StageTimes]] = None,
    ) -> None:
        """fn(queries, top_k) -> per-query list of (chunk_idx, score).
        ``times()``, where given, is the registry at each batch (an
        engine's ``times``, which its owner may replace): the copy of the
        batch's rows into the plane's arrays is span ``plane_copy_out``
        there, and that registry reports ``stage_counters``."""

        def registry() -> StageTimes:
            reg = times()
            reg.add_source("plane", self.stage_counters)
            return reg

        if times is not None:
            registry()  # the counters read from the start

        def cb(qptr, n, top_k, out_idx, out_scores, out_counts, _user):
            try:
                queries = [
                    qptr[i].decode("utf-8", "replace") for i in range(n)
                ]
                results = fn(queries, top_k)
                with (contextlib.nullcontext() if times is None
                      else stage_timer("plane_copy_out", registry())):
                    for i, rows in enumerate(results):
                        c = min(len(rows), top_k)
                        base = i * top_k
                        for j in range(c):
                            ci, sc = rows[j]
                            out_idx[base + j] = int(ci)
                            out_scores[base + j] = float(sc)
                        out_counts[i] = c
                return 0
            except Exception:
                import traceback

                traceback.print_exc()
                return 1

        # keep EVERY installed trampoline alive: set_rank_fn may be called
        # again at run time (index reload) while a dispatcher batch is still
        # executing the previous callback; freeing it mid-call would be a
        # use-after-free.  One closure per reload is a negligible leak.
        ref = RANK_CB(cb)
        self._cb_refs.append(ref)
        self._lib.msetpu_http_set_rank_callback(self._h, ref, None)

    def start(self) -> None:
        rc = self._lib.msetpu_http_start(self._h)
        if rc != 0:
            raise OSError(f"msetpu_http_start failed: {rc}")

    def stats(self) -> dict:
        """Counters since start: ``served``, ``batches``,
        ``batched_queries``, ``bad_requests``, ``health``; ``queued``
        (requests taken into a batch), ``queue_wait_us`` (summed, parsed
        to taken, the batch window included), ``host_us`` (summed over
        replies, parsed to reply handed to the event thread);
        ``host_p50_ms``, ``host_p95_ms``, ``host_p99_ms`` (each within
        ~4.4%).  Empty once stopped."""
        if not self._h:
            return {}
        return _take_json(self._lib, self._lib.msetpu_http_stats_json(self._h))

    def stage_counters(self) -> dict:
        """The request timing as ``StageTimes`` counters (seconds, count):
        ``plane_queue_wait`` over the requests taken, ``plane_host`` over
        the replies."""
        st = self.stats()
        if not st:
            return {}
        return {"plane_queue_wait": (st["queue_wait_us"] / 1e6, st["queued"]),
                "plane_host": (st["host_us"] / 1e6, st["served"])}

    def stop(self) -> None:
        if self._h:
            self._lib.msetpu_http_destroy(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


def client_bench(
    port: int,
    n_conns: int = 64,
    total_requests: int = 10000,
    body: Optional[str] = None,
    timeout_s: int = 120,
    bodies: Optional[Sequence[str]] = None,
) -> dict:
    """Epoll load generator against 127.0.0.1:port (GIL released for the
    duration; run it in a separate process for honest numbers).

    ``bodies`` rotates requests over a pool of payloads (distinct queries
    per device batch drive the batcher and the U-dedup shapes as real
    traffic does); ``body`` sends one payload."""
    lib = load_lib()
    if bodies:
        enc = [b.encode("utf-8") for b in bodies]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        ptr = lib.msetpu_http_client_bench_multi(
            port, n_conns, total_requests, arr, len(enc), timeout_s
        )
    else:
        ptr = lib.msetpu_http_client_bench(
            port,
            n_conns,
            total_requests,
            (body or '{"query": "bench query tübingen"}').encode("utf-8"),
            timeout_s,
        )
    return _take_json(lib, ptr)
