"""HTTP control plane: the reference's Flask API, on the torch engine.

Counterpart of the reference package's ``serving/api.py``, with the same
16 routes and response bodies (byte for byte where they are built by
hand), served by ``serving/http.py`` (asyncio, standard library) in place
of aiohttp:

  POST /api/search            {query, top_k?, query_id?} ->
                              {llm_response, documents:[{query_id, rank,
                               url, score, title, snippet, domain, doc_id}]}
  POST /api/batch_search      runs queries.txt -> {total_queries,
                              total_results, results:[{query_num, rank, url,
                              score, formatted_line}], queries_processed,
                              processing_time}
  POST /api/batch_search_file same, saved to batch_search_results.txt
  POST /api/generate_summary  {most_relevant_windows, query} -> {response}
  POST /rerank, /api/rerank   stage-1 candidates -> DocumentScore rows
  POST /api/reload            rebuild the engine from the index directory
  POST /api/profile           a torch.profiler trace of one search batch
  GET  /api/health, /api/stats, /api/terms/{term},
       /api/document/{doc_id}/terms, /api/config, /api/rate-limit-status,
       /api/timings
  GET  /                      the bubble UI (repo-root ui/)

Device calls run in a single-worker executor so the event loop stays
responsive while queries batch up (``serving/batcher.py``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import re
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

from modern_search_engines_project_tpu_torch.eval.batch import (
    parse_queries_file,
)
from modern_search_engines_project_tpu_torch.serving import http as web
from modern_search_engines_project_tpu_torch.serving.assistant import (
    ExtractiveSummarizer,
    Summarizer,
)
from modern_search_engines_project_tpu_torch.serving.batcher import QueryBatcher
from modern_search_engines_project_tpu_torch.serving.rate_limiter import (
    RateLimiter,
)
from modern_search_engines_project_tpu_torch.serving.topic import (
    extract_domain_topic,
)
from modern_search_engines_project_tpu_torch.utils.timing import device_trace

log = logging.getLogger("serving")

UI_DIR = Path(__file__).resolve().parent.parent.parent / "ui"

__all__ = ["SearchService", "UI_DIR", "extract_domain_topic"]


class SearchService:
    """Wraps a SearchEngine + Summarizer behind the HTTP handlers."""

    def __init__(
        self,
        engine,
        summarizer: Optional[Summarizer] = None,
        queries_path: str = "queries.txt",
        results_path: str = "batch_search_results.txt",
        rate_limiter: Optional[RateLimiter] = None,
        engine_factory=None,
        query_cache_size: int = 1024,
        trace_root: str = "/tmp/msetpu_profile",
        admin_token: Optional[str] = None,
    ):
        self.engine = engine
        # zero-downtime index refresh: POST /api/reload rebuilds an engine
        # via this factory (re-reading the index directory) and swaps it in
        # between device batches
        self.engine_factory = engine_factory
        self.summarizer = summarizer or ExtractiveSummarizer()
        self.queries_path = Path(queries_path)
        self.results_path = Path(results_path)
        # disabled by default, like the reference reranker config
        self.rate_limiter = rate_limiter or RateLimiter(enabled=False)
        # profiler traces only ever land under this root; clients pick a
        # label, never a path (an open HTTP surface must not write to
        # arbitrary directories)
        self.trace_root = Path(trace_root)
        # when set, the mutating admin endpoints (/api/reload,
        # /api/profile) require the X-Admin-Token header to match
        self.admin_token = admin_token
        # bumped by /api/reload: a cache-miss search that raced a reload
        # must not insert results from the old engine into the new cache
        self._generation = 0
        # called with the new engine after every successful /api/reload:
        # sibling serving planes (the C++ data plane) re-attach through it
        self.reload_listeners: list = []
        # one worker: device calls serialize, host work stays async
        self._pool = ThreadPoolExecutor(max_workers=1)
        # pre-escaped JSON fragments for the static per-result fields
        # (url/title/snippet/domain/doc_id)
        self._doc_json: dict = {}
        # LRU of (query, top_k) -> (ranked, summary); results are pure
        # functions of the index, so caching is sound until /api/reload,
        # which clears it.  0 disables.
        self._query_cache_size = max(0, int(query_cache_size))
        self._query_cache: dict = {}
        self._cache_hits = 0
        self._cache_misses = 0
        # concurrent online queries coalesce into one device batch
        self.batcher = QueryBatcher(
            engine,
            self._pool,
            max_batch=getattr(engine.cfg, "query_batch_size", 64),
        )

    # --- handlers -----------------------------------------------------------

    async def search(self, request: web.Request) -> web.Response:
        t0 = time.time()
        if not await self.rate_limiter.acquire():
            return web.json_response(
                {"error": "Rate limit exceeded"}, status=429
            )
        try:
            data = await request.json()
        except Exception:
            return web.json_response({"error": "Query is required"}, status=400)
        query = (data.get("query") or "").strip()
        if not query:
            return web.json_response({"error": "Query is required"}, status=400)
        top_k = int(data.get("top_k") or self.engine.cfg.top_k_reranking)
        query_id = data.get("query_id", uuid.uuid4().hex)

        loop = asyncio.get_running_loop()
        cache_key = (query, top_k)
        generation = self._generation
        cached = self._query_cache.get(cache_key)
        if cached is not None:
            self._cache_hits += 1
            # re-insert for LRU recency (dicts preserve insertion order)
            self._query_cache.pop(cache_key, None)
            self._query_cache[cache_key] = cached
            ranked, summary = cached
        else:
            self._cache_misses += 1
            ranked, summary = await self.batcher.search(query, top_k=top_k), None

        qid_json = json.dumps(query_id)
        frags = []
        for i, doc in enumerate(ranked, start=1):
            static = self._doc_json.get((doc.doc_id, doc.window_index))
            if static is None:
                content = doc.window_text or ""
                head = json.dumps({"url": doc.url})[1:-1]
                tail = json.dumps(
                    {
                        "title": doc.title or "No Title",
                        "snippet": (
                            content[:200] + "..."
                            if len(content) > 200
                            else content
                        )
                        or "No content available",
                        "domain": extract_domain_topic(doc.url),
                        "doc_id": str(doc.doc_id),
                    }
                )[1:-1]
                static = (head, tail)
                if len(self._doc_json) > 500_000:
                    self._doc_json.clear()
                self._doc_json[(doc.doc_id, doc.window_index)] = static
            score = float(doc.similarity_score)
            if not math.isfinite(score):
                # repr(nan/inf) is not valid JSON and would break clients
                score = 0.0
            frags.append(
                f'{{"query_id": {qid_json}, "rank": {i}, {static[0]}, '
                f'"score": {score!r}, {static[1]}}}'
            )
        windows = [d.window_text for d in ranked[:10] if d.window_text]
        llm_response = summary or ""
        if windows and summary is None:
            llm_response = await loop.run_in_executor(
                None, lambda: self.summarizer.generate_summary(query, windows)
            )
        if (
            cached is None
            and self._query_cache_size
            and generation == self._generation
        ):
            if len(self._query_cache) >= self._query_cache_size:
                self._query_cache.pop(next(iter(self._query_cache)))
            self._query_cache[cache_key] = (ranked, llm_response)
        log.info(
            "search %r -> %d docs in %.3fs", query, len(frags),
            time.time() - t0,
        )
        body = (
            f'{{"llm_response": {json.dumps(llm_response)}, '
            f'"documents": [{",".join(frags)}]}}'
        )
        return web.Response(text=body, content_type="application/json")

    async def _run_batch(self):
        if not self.queries_path.exists():
            return None
        queries = parse_queries_file(
            self.queries_path.read_text(encoding="utf-8")
        )
        if not queries:
            return None
        t0 = time.time()
        loop = asyncio.get_running_loop()

        def run():
            texts = [q for _, q in queries]
            return self.engine.search_batch(texts, top_k=100)

        ranked_lists = await loop.run_in_executor(self._pool, run)
        all_results = []
        for (qn, _qt), ranked in zip(queries, ranked_lists):
            for rank, doc in enumerate(ranked, start=1):
                all_results.append(
                    {
                        "query_num": str(qn),
                        "rank": rank,
                        "url": doc.url,
                        "score": f"{doc.similarity_score:.3f}",
                        "formatted_line": (
                            f"{qn}\t{rank}\t{doc.url}\t"
                            f"{doc.similarity_score:.3f}"
                        ),
                    }
                )
        return {
            "total_queries": len(queries),
            "total_results": len(all_results),
            "results": all_results,
            "queries_processed": [
                {"query_num": str(qn), "query_text": qt} for qn, qt in queries
            ],
            "processing_time": f"{time.time() - t0:.2f}s",
        }

    async def batch_search(self, request: web.Request) -> web.Response:
        data = await self._run_batch()
        if data is None:
            return web.json_response(
                {"error": "queries.txt file not found"}, status=404
            )
        return web.json_response(data)

    async def batch_search_file(self, request: web.Request) -> web.Response:
        data = await self._run_batch()
        if data is None:
            return web.json_response(
                {"error": "queries.txt file not found"}, status=404
            )
        with open(self.results_path, "w", encoding="utf-8") as f:
            for row in data["results"]:
                f.write(row["formatted_line"] + "\n")
        return web.json_response(
            {
                "message": f"Results saved to {self.results_path}",
                "total_queries": data["total_queries"],
                "total_results": data["total_results"],
                "output_file": str(self.results_path),
                "format": "query_num<tab>rank<tab>url<tab>score per line",
            }
        )

    async def rerank(self, request: web.Request) -> web.Response:
        """Standalone rerank endpoint (reference reranker sidecar parity,
        POST /rerank, reranker_api.py:336-417): the caller supplies
        stage-1 candidates {doc_ids, similarities, query}; the response
        carries document_scores + top_windows in the DocumentScore
        schema."""
        from modern_search_engines_project_tpu_torch.retrieval.rerank import (
            rerank_candidates,
        )

        try:
            data = await request.json()
        except Exception:
            return web.json_response({"error": "invalid json"}, status=400)
        doc_ids = data.get("doc_ids") or []
        sims = data.get("similarities") or []
        query = (data.get("query") or "").strip()
        if not doc_ids or len(doc_ids) != len(sims) or not query:
            return web.json_response(
                {"error": "doc_ids, similarities and query are required"},
                status=400,
            )
        try:
            doc_ids = [int(d) for d in doc_ids]
            sims = [float(s) for s in sims]
        except (TypeError, ValueError):
            return web.json_response(
                {"error": "doc_ids must be integers and similarities "
                          "numbers"},
                status=400,
            )
        eng = self.engine
        top_k = int(data.get("top_k") or eng.cfg.top_k_reranking)
        loop = asyncio.get_running_loop()
        ranked = await loop.run_in_executor(
            self._pool,
            lambda: rerank_candidates(
                eng.art,
                eng.encoder,
                query,
                doc_ids,
                sims,
                top_k=top_k,
                smoothing=eng.cfg.smoothing,
                diversification=eng.cfg.diversification,
                relevance_threshold=eng.cfg.diversification_threshold,
            ),
        )
        if not ranked:
            return web.json_response(
                {"error": "No documents found for the provided doc_ids"},
                status=401,  # reference status (reranker_api.py:349)
            )

        def window(doc):
            return {
                "text": doc.window_text,
                "similarity_score": doc.similarity_score,
                "doc_id": str(doc.doc_id),
                "title": doc.title,
                "window_index": doc.window_index,
            }

        return web.json_response(
            {
                "document_scores": [
                    {
                        "doc_id": str(d.doc_id),
                        "title": d.title,
                        "url": d.url,
                        "similarity_score": d.similarity_score,
                        "original_similarity": d.original_similarity,
                        "most_relevant_window": window(d),
                    }
                    for d in ranked
                ],
                "top_windows": [window(d) for d in ranked[:top_k]],
                "total_documents": len(ranked),
                "total_windows": top_k,
            }
        )

    async def generate_summary(self, request: web.Request) -> web.Response:
        """Reference assistant endpoint parity
        (search_assistant/main.py:35-76)."""
        try:
            data = await request.json()
        except Exception:
            return web.json_response({"error": "invalid json"}, status=400)
        windows = data.get("most_relevant_windows") or []
        query = data.get("query") or ""
        loop = asyncio.get_running_loop()
        text = await loop.run_in_executor(
            None, lambda: self.summarizer.generate_summary(query, windows)
        )
        return web.json_response({"response": text})

    async def reload_index(self, request: web.Request) -> web.Response:
        """Rebuild the engine from the (possibly re-indexed) on-disk index
        and swap it in atomically; serving never stops.  In-flight device
        batches finish on the old engine; the swap happens on the event
        loop between batches (single-threaded, no lock needed)."""
        denied = self._check_admin(request)
        if denied is not None:
            return denied
        if self.engine_factory is None:
            return web.json_response(
                {"error": "serving was started without a reloadable index"},
                status=409,
            )
        loop = asyncio.get_running_loop()
        t0 = time.time()
        try:
            new_engine = await loop.run_in_executor(
                self._pool, self.engine_factory
            )
        except Exception as exc:
            log.exception("index reload failed")
            return web.json_response(
                {"error": f"reload failed: {exc}"}, status=500
            )
        self.engine = new_engine
        self.batcher.engine = new_engine
        # sibling planes (e.g. the native data plane) re-attach to the new
        # engine; a failing listener must not fail the reload itself
        for cb in self.reload_listeners:
            try:
                cb(new_engine)
            except Exception:
                log.exception("reload listener failed")
        # window indices / snippets / rankings may differ in the new index.
        # Bump the generation FIRST: any in-flight cache-miss search holds
        # the old generation and will decline to insert old-engine results
        # into the cleared cache.
        self._generation += 1
        self._doc_json.clear()
        self._query_cache.clear()
        art = getattr(new_engine, "art", None)
        return web.json_response(
            {
                "status": "reloaded",
                "n_docs": getattr(art, "n_docs", None),
                "n_chunks": getattr(art, "n_chunks", None),
                "seconds": round(time.time() - t0, 2),
            }
        )

    def _check_admin(self, request: web.Request) -> Optional[web.Response]:
        """403 unless the request carries the configured admin token (no-op
        when serving was started without one)."""
        if self.admin_token is None:
            return None
        if request.headers.get("X-Admin-Token") == self.admin_token:
            return None
        return web.json_response({"error": "admin token required"}, status=403)

    async def profile(self, request: web.Request) -> web.Response:
        """Capture a ``torch.profiler`` trace (host activity, and the card's
        kernels when the engine is on one) around a real search batch.
        Body: {queries?: [...], label?: str}.  The Chrome trace lands under
        the server-configured ``trace_root`` (client-supplied paths are
        never honored); the response reports the wall time and the trace
        directory."""
        denied = self._check_admin(request)
        if denied is not None:
            return denied
        try:
            data = await request.json()
        except Exception:
            data = {}
        queries = data.get("queries") or ["profile probe tübingen"]
        label = re.sub(r"[^A-Za-z0-9_-]", "", str(data.get("label") or ""))
        out_dir = str(self.trace_root / label[:64] if label else self.trace_root)
        if not isinstance(queries, list) or not all(
            isinstance(q, str) for q in queries
        ):
            return web.json_response(
                {"error": "queries must be a list of strings"}, status=400
            )
        loop = asyncio.get_running_loop()
        eng = self.engine

        def run():
            t0 = time.time()
            with device_trace(out_dir, getattr(eng, "device", None)):
                eng.search_batch(queries[:64])
            return time.time() - t0

        try:
            wall = await loop.run_in_executor(self._pool, run)
        except Exception as exc:
            log.exception("profile capture failed")
            return web.json_response(
                {"error": f"profiling failed: {exc}"}, status=500
            )
        return web.json_response(
            {
                "trace_dir": out_dir,
                "queries": len(queries[:64]),
                "wall_seconds": round(wall, 4),
                "view": "load the trace_*.json in ui.perfetto.dev or "
                        "chrome://tracing",
            }
        )

    async def health(self, request: web.Request) -> web.Response:
        return web.json_response(
            {"status": "healthy", "search_engine_ready": self.engine is not None}
        )

    async def stats(self, request: web.Request) -> web.Response:
        """Index introspection (reference get_index_stats + /database/stats
        role, bm25_indexer.py:546-568, reranker_api.py:440-466)."""
        art = getattr(self.engine, "art", None)
        payload = art.index_stats() if art is not None else {}
        return web.json_response(payload)

    async def term_stats(self, request: web.Request) -> web.Response:
        """Per-term stats over HTTP (BM25.get_term_stats parity,
        bm25_indexer.py:516-531)."""
        term = request.match_info["term"]
        art = getattr(self.engine, "art", None)
        stats = art.get_term_stats(term) if art is not None else None
        if stats is None:
            return web.json_response(
                {"error": f"term {term!r} not in the index"}, status=404
            )
        return web.json_response(stats)

    async def document_terms(self, request: web.Request) -> web.Response:
        """Highest-impact terms of one document
        (BM25.get_document_terms parity, bm25_indexer.py:533-544)."""
        try:
            doc_id = int(request.match_info["doc_id"])
        except ValueError:
            return web.json_response(
                {"error": "doc_id must be an integer"}, status=400
            )
        try:
            top_n = min(100, int(request.query.get("top_n", 20)))
        except ValueError:
            return web.json_response(
                {"error": "top_n must be an integer"}, status=400
            )
        art = getattr(self.engine, "art", None)
        loop = asyncio.get_running_loop()
        terms = await loop.run_in_executor(
            None, lambda: art.get_document_terms(doc_id, top_n=top_n)
        )
        if not terms:
            return web.json_response(
                {"error": f"document {doc_id} not in the index"}, status=404
            )
        return web.json_response({"doc_id": doc_id, "terms": terms})

    async def config_view(self, request: web.Request) -> web.Response:
        """Serving config with nothing secret to redact (reference /config
        redacts api keys, reranker_api.py:518-526)."""
        cfg = self.engine.cfg
        return web.json_response({k: v for k, v in cfg.__dict__.items()})

    async def rate_limit_status(self, request: web.Request) -> web.Response:
        return web.json_response(self.rate_limiter.status())

    async def timings(self, request: web.Request) -> web.Response:
        """Per-stage wall times, the batcher's coalescing and the query
        cache."""
        times = getattr(self.engine, "times", None)
        payload = times.report() if times else {}
        payload["online_batching"] = self.batcher.stats()
        payload["query_cache"] = {
            "size": len(self._query_cache),
            "capacity": self._query_cache_size,
            "hits": self._cache_hits,
            "misses": self._cache_misses,
        }
        return web.json_response(payload)

    async def index(self, request: web.Request) -> web.Response:
        page = UI_DIR / "templates" / "index.html"
        if not page.exists():
            return web.Response(text="UI not built", status=404)
        return web.FileResponse(page)

    # --- app ----------------------------------------------------------------

    def build_app(self) -> web.Application:
        async def cors(request, handler):
            # the reference enables CORS on the Flask app (search_api.py:19)
            if request.method == "OPTIONS":
                resp = web.Response()
            else:
                resp = await handler(request)
            resp.headers["Access-Control-Allow-Origin"] = "*"
            resp.headers["Access-Control-Allow-Headers"] = "Content-Type"
            resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
            return resp

        app = web.Application(
            client_max_size=16 * 1024 * 1024, middlewares=[cors]
        )
        app.add_post("/api/search", self.search)
        app.add_post("/api/batch_search", self.batch_search)
        app.add_post("/api/batch_search_file", self.batch_search_file)
        app.add_post("/api/generate_summary", self.generate_summary)
        app.add_post("/rerank", self.rerank)  # reference sidecar path
        app.add_post("/api/rerank", self.rerank)
        app.add_post("/api/reload", self.reload_index)
        app.add_post("/api/profile", self.profile)
        app.add_get("/api/health", self.health)
        app.add_get("/api/stats", self.stats)
        app.add_get("/api/terms/{term}", self.term_stats)
        app.add_get("/api/document/{doc_id}/terms", self.document_terms)
        app.add_get("/api/config", self.config_view)
        app.add_get("/api/rate-limit-status", self.rate_limit_status)
        app.add_get("/api/timings", self.timings)
        app.add_get("/", self.index)
        static = UI_DIR / "static"
        if static.exists():
            app.add_static("/static/", static)
        return app

    def run(self, host: str = "0.0.0.0", port: int = 5000):
        web.run_app(self.build_app(), host=host, port=port)
