"""Native data plane: the C++ HTTP server wired to a SearchEngine.

Counterpart of the reference package's ``serving/fastpath.py``.  The
asyncio app (``serving/api.py``) is the full-featured control plane; this
module runs the C++ epoll server (``native/http_server.cpp``) for the hot
path, POST /api/search and GET /api/health, with the ranking delivered by

  * the real engine (``attach_engine``): the C++ batcher coalesces
    concurrent requests and calls ``engine.search_batch_indices`` once per
    batch through a ctypes trampoline, on the engine's own device, or
  * a canned stub (``attach_stub``): the host path's ceiling with the
    device out of the loop.

Response bodies match ``serving/api.py``'s /api/search schema: per-result
url/title/snippet/domain/doc_id come from pre-escaped JSON fragments built
once per index load, one per chunk, so each result's snippet is its
query-specific most relevant window.

Run both planes side by side:
    python -m modern_search_engines_project_tpu_torch.serving --port 5000 \\
        --fastpath-port 5001
"""

from __future__ import annotations

import contextlib
import json
import logging
from typing import Optional

import torch

from modern_search_engines_project_tpu_torch.native.native_http import (
    FastHttpServer,
)
from modern_search_engines_project_tpu_torch.serving.topic import (
    extract_domain_topic,
)

log = logging.getLogger("serving.fastpath")


def build_fragments(art) -> list:
    """Per-chunk pre-escaped inner-JSON fragments for the C++ doc table.

    fragment[w] covers the chunk at global window index w:
      "url": ..., "title": ..., "snippet": <window text, 200 chars>,
      "domain": ..., "doc_id": ...
    (the same static fields serving/api.py caches per (doc, window)).
    ``art.window_texts`` is read by index and ``len`` only."""
    frags = []
    chunk_doc = art.chunk_doc
    texts = art.window_texts
    for w in range(len(texts)):
        text = texts[w]
        d = int(chunk_doc[w])
        url = art.urls[d]
        snippet = (text[:200] + "...") if len(text) > 200 else text
        inner = json.dumps(
            {
                "url": url,
                "title": art.titles[d] or "No Title",
                "snippet": snippet or "No content available",
                "domain": extract_domain_topic(url),
                "doc_id": str(art.doc_ids[d]),
            },
            ensure_ascii=False,
        )[1:-1]
        frags.append(inner.encode("utf-8"))
    return frags


def make_server(
    port: int,
    *,
    n_threads: int = 1,
    max_batch: int = 64,
    batch_window_us: int = 200,
    default_top_k: int = 100,
    pipeline: int = 1,
) -> FastHttpServer:
    return FastHttpServer(
        port,
        n_threads=n_threads,
        max_batch=max_batch,
        batch_window_us=batch_window_us,
        default_top_k=default_top_k,
        pipeline=pipeline,
    )


def attach_engine(server: FastHttpServer, engine, fragments=None) -> None:
    """Wire the real ranking path: fragments from the engine's artifacts
    (``fragments``, when given, is ``build_fragments(engine.art)`` built
    before) + a batch rank callback.  The callback runs on a C++
    dispatcher thread, whose current CUDA device is whatever that thread
    last set, so it selects the engine's device (``engine.device``) for
    every batch.  The engine's ``times``, as it is at each batch, gets the
    callback's copy-out span (``plane_copy_out``) and reports the plane's
    request timing (``FastHttpServer.stage_counters``)."""
    server.load_fragments(
        build_fragments(engine.art) if fragments is None else fragments
    )
    dev = getattr(engine, "device", None)

    def on_device():
        if dev is not None and torch.device(dev).type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def rank(queries, top_k):
        with on_device():
            return engine.search_batch_indices(queries, top_k=top_k)

    server.set_rank_fn(rank, times=lambda: engine.times)


def attach_stub(
    server: FastHttpServer, n_chunks: int, k: int = 100
) -> None:
    """Canned ranking (host-ceiling load tests): top-k = the first k
    chunks with descending scores."""
    k = min(k, n_chunks)
    server.set_stub(
        list(range(k)), [1.0 - i / (k + 1) for i in range(k)]
    )


def serve_fastpath(
    engine,
    port: int,
    *,
    n_threads: int = 1,
    max_batch: Optional[int] = None,
    pipeline: int = 2,
    fragments=None,
) -> FastHttpServer:
    """Start (and return) the native data plane for ``engine``.

    ``pipeline`` dispatcher threads keep that many device batches in
    flight (see FastHttpServer); 2 hides one full device round trip.
    ``fragments``: ``build_fragments(engine.art)`` built before, if any."""
    srv = make_server(
        port,
        n_threads=n_threads,
        max_batch=max_batch
        or getattr(engine.cfg, "query_batch_size", 64),
        default_top_k=engine.cfg.top_k_reranking,
        pipeline=pipeline,
    )
    attach_engine(srv, engine, fragments)
    srv.start()
    log.info("native fast path serving on 127.0.0.1:%d", port)
    return srv
