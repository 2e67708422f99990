"""The torch port's HTTP control plane (``serving/api.py`` on
``serving/http.py``) against the reference's aiohttp app, on the CPU.

Both services are driven over real sockets on 127.0.0.1 with the same
requests: the reference app through aiohttp's test client on the JAX
engine (``use_pallas=True``, interpret mode), the port's through
``http.client`` on the port engine (``device="cpu"``), the two engines
built from the same corpus.  Bodies must be equal: every key and string
equal, numbers within 1e-5 (the engines' float sums differ in their last
bits), wall-time fields not compared.  Also: the query cache and reload
semantics, the batcher's coalescing and result equality, the HTTP layer's
framing limits, a static-path traversal refused, ``/api/profile``'s trace,
and two threads calling ``search_batch_indices`` at once.

Every socket has a timeout and every server is stopped in a finaliser.
"""

import asyncio
import http.client
import itertools
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from corpus_util import make_corpus
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.models import HashingEncoder as RefEncoder
from modern_search_engines_project_tpu.retrieval import SearchEngine as RefEngine
from modern_search_engines_project_tpu.serving import (
    SearchService as RefService,
)
from modern_search_engines_project_tpu.serving.rate_limiter import (
    RateLimiter as RefLimiter,
)
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import IndexBuilder
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.retrieval import SearchEngine
from modern_search_engines_project_tpu_torch.serving import (
    SearchService,
    extract_domain_topic,
)
from modern_search_engines_project_tpu_torch.serving.batcher import QueryBatcher
from modern_search_engines_project_tpu_torch.serving.http import ServerThread
from modern_search_engines_project_tpu_torch.serving.rate_limiter import (
    RateLimiter,
)

CFG = dict(embedding_dim=32, window_size=32, step_size=25,
           top_k_retrieval=20, top_k_reranking=10, max_query_terms=8)
ATOL = 1e-5
TIMEOUT = 30
WALL_KEYS = {"processing_time", "seconds", "wall_seconds"}


def _docs(n_docs=40, seed=3):
    return make_corpus(n_docs=n_docs, seed=seed, min_len=40, max_len=120)


def port_engine(n_docs=40, seed=3):
    enc = HashingEncoder(dim=32)
    art = IndexBuilder(enc, Config(**CFG)).build(_docs(n_docs, seed))
    return SearchEngine(art, enc, Config(**CFG), device="cpu")


def ref_engine(n_docs=40, seed=3):
    enc = RefEncoder(dim=32)
    art = RefBuilder(enc, RefConfig(**CFG)).build(_docs(n_docs, seed))
    return RefEngine(art, enc, RefConfig(**CFG), use_pallas=True)


class PortClient:
    """One keep-alive ``http.client`` connection to a port service."""

    def __init__(self, port):
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=TIMEOUT)

    def call(self, method, path, payload=None, headers=None, raw=None):
        body = raw if raw is not None else (
            None if payload is None else json.dumps(payload))
        self.conn.request(method, path, body, headers or {})
        r = self.conn.getresponse()
        return r.status, r.read().decode("utf-8"), r

    def json(self, method, path, payload=None, headers=None):
        status, text, _ = self.call(method, path, payload, headers)
        return status, json.loads(text)

    def close(self):
        self.conn.close()


@pytest.fixture
def serve():
    """serve(service) -> a PortClient; the server stops in a finaliser."""
    servers, clients = [], []

    def start(service):
        srv = ServerThread(service.build_app()).start()
        servers.append(srv)
        cl = PortClient(srv.port)
        clients.append(cl)
        return cl

    yield start
    for cl in clients:
        cl.close()
    for srv in servers:
        srv.stop()


def ref_calls(service, calls):
    """Run ``calls`` [(method, path, payload, headers)] against the
    reference app; returns [(status, text)]."""

    async def runner():
        client = TestClient(TestServer(service.build_app()))
        await client.start_server()
        out = []
        try:
            for method, path, payload, headers in calls:
                kw = {"headers": headers or {}}
                if payload is not None:
                    kw["json"] = payload
                r = await client.request(method, path, **kw)
                out.append((r.status, await r.text()))
        finally:
            await client.close()
        return out

    return asyncio.run(runner())


def assert_same(a, b, where="body"):
    """Same keys, lists and strings; numbers within ATOL; wall-time
    fields skipped."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, a, b)
        for k in a:
            if k not in WALL_KEYS:
                assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, bool) or a is None or isinstance(a, str):
        assert a == b, (where, a, b)
    elif isinstance(a, (int, float)):
        assert isinstance(b, (int, float)) and abs(a - b) <= ATOL, (where, a, b)
    else:
        raise AssertionError((where, type(a)))


@pytest.fixture(scope="module")
def engines():
    return port_engine(), ref_engine()


@pytest.fixture(scope="module")
def qfile(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving")
    q = tmp / "queries.txt"
    q.write_text("1\tresearch law\n2\tforest library\n")
    return tmp


def _services(engines, qfile, **kw):
    port, ref = engines
    paths = dict(queries_path=str(qfile / "queries.txt"),
                 results_path=str(qfile / "results.txt"),
                 trace_root=str(qfile / "traces"))
    return (SearchService(port, **paths, **kw),
            RefService(ref, **paths, **{
                k: (RefLimiter(v.rpm, v.enabled) if k == "rate_limiter"
                    else v) for k, v in kw.items()}))


def _same_calls(serve, engines, qfile, calls, **kw):
    port_svc, ref_svc = _services(engines, qfile, **kw)
    cl = serve(port_svc)
    want = ref_calls(ref_svc, calls)
    for (method, path, payload, headers), (ref_status, ref_text) in zip(
            calls, want):
        status, text, _ = cl.call(method, path, payload, headers)
        assert status == ref_status, (path, status, ref_status, text)
        assert_same(json.loads(text), json.loads(ref_text), path)
    return want


def test_same_bodies_on_data_routes(serve, engines, qfile):
    port, _ = engines
    stage1 = port.bm25_search("research law", top_k=10, augment=False)
    term = next(iter(port.art.vocab.term_to_id))
    doc_id = port.art.doc_ids[0]
    calls = [
        ("POST", "/api/search", {"query": "research law faculty",
                                 "top_k": 5, "query_id": "q-1"}, None),
        ("POST", "/api/search", {"query": "forest library", "query_id": 7},
         None),
        ("POST", "/api/search", {"query": "tübingen castle",
                                 "query_id": 'q"x'}, None),
        ("POST", "/api/batch_search", None, None),
        ("POST", "/api/batch_search_file", None, None),
        ("POST", "/rerank", {"doc_ids": [r["doc_id"] for r in stage1],
                             "similarities": [r["score"] for r in stage1],
                             "query": "research law"}, None),
        ("POST", "/api/rerank", {"doc_ids": [r["doc_id"] for r in stage1],
                                 "similarities": [r["score"] for r in stage1],
                                 "query": "research law", "top_k": 3}, None),
        ("POST", "/api/generate_summary", {
            "most_relevant_windows": ["The Neckar river flows through the "
                                      "old town daily."],
            "query": "neckar river"}, None),
        ("GET", "/api/stats", None, None),
        ("GET", f"/api/terms/{term}", None, None),
        ("GET", "/api/terms/t%C3%BCbingen", None, None),
        ("GET", f"/api/document/{doc_id}/terms?top_n=5", None, None),
        ("GET", f"/api/document/{doc_id}/terms", None, None),
        ("GET", "/api/health", None, None),
        ("GET", "/api/config", None, None),
        ("GET", "/api/rate-limit-status", None, None),
    ]
    want = _same_calls(serve, engines, qfile, calls)
    # the percent-encoded term is decoded, and not indexed in this form
    assert [s for s, _ in want] == [200] * 10 + [404] + [200] * 5
    assert len(json.loads(want[0][1])["documents"]) == 5
    assert json.loads(want[3][1])["total_results"] > 0


def test_same_bodies_on_error_routes(serve, engines, qfile, tmp_path):
    calls = [
        ("POST", "/api/search", {"query": "  "}, None),  # 400
        ("POST", "/rerank", {"query": "x"}, None),  # 400
        ("POST", "/rerank", {"doc_ids": ["abc"], "similarities": [0.5],
                             "query": "x"}, None),  # 400
        ("POST", "/rerank", {"doc_ids": [123456], "similarities": [1.0],
                             "query": "x"}, None),  # 401
        ("GET", "/api/document/notanint/terms", None, None),  # 400
        ("GET", "/api/document/1/terms?top_n=x", None, None),  # 400
        ("GET", "/api/document/99999999/terms", None, None),  # 404
        ("GET", "/api/terms/zzzznotaterm", None, None),  # 404
        ("POST", "/api/reload", None, None),  # 403 without the token
        ("POST", "/api/profile", {}, None),  # 403
        ("POST", "/api/reload", None, {"X-Admin-Token": "s3cret"}),  # 409
        ("POST", "/api/profile", {"queries": [1, 2]},
         {"X-Admin-Token": "s3cret"}),  # 400
    ]
    want = _same_calls(serve, engines, qfile, calls, admin_token="s3cret")
    assert [s for s, _ in want] == [400, 400, 400, 401, 400, 400, 404, 404,
                                    403, 403, 409, 400]
    # 404 for a missing queries file, 429 past the rate limit
    calls = [("POST", "/api/batch_search", None, None)]
    port_svc, ref_svc = (
        SearchService(engines[0], queries_path=str(tmp_path / "none.txt")),
        RefService(engines[1], queries_path=str(tmp_path / "none.txt")))
    (ref_status, ref_text), = ref_calls(ref_svc, calls)
    status, text, _ = serve(port_svc).call("POST", "/api/batch_search")
    assert status == ref_status == 404 and json.loads(text) == json.loads(
        ref_text)
    calls = [("POST", "/api/search", {"query": "research law",
                                      "query_id": "a"}, None)] * 2
    want = _same_calls(serve, engines, qfile, calls,
                       rate_limiter=RateLimiter(1, enabled=True))
    assert [s for s, _ in want] == [200, 429]


def test_invalid_json_and_unknown_paths(serve, engines, qfile):
    port_svc, _ = _services(engines, qfile)
    cl = serve(port_svc)
    status, text, _ = cl.call("POST", "/api/search", raw=b"not json")
    assert status == 400 and json.loads(text) == {"error": "Query is required"}
    assert cl.call("GET", "/api/nope")[0] == 404
    assert cl.call("GET", "/api/search")[0] == 405
    status, _, r = cl.call("OPTIONS", "/api/search")
    assert status == 200
    assert r.getheader("Access-Control-Allow-Origin") == "*"
    assert r.getheader("Access-Control-Allow-Methods") == "GET, POST, OPTIONS"


def test_timings_and_ui(serve, engines, qfile):
    port_svc, _ = _services(engines, qfile)
    cl = serve(port_svc)
    cl.json("POST", "/api/search", {"query": "research law"})
    status, data = cl.json("GET", "/api/timings")
    assert status == 200
    assert data["online_batching"]["requests"] == 1
    assert data["query_cache"] == {"size": 1, "capacity": 1024, "hits": 0,
                                   "misses": 1}
    assert {"query_prep", "device_rank", "format_diversify"} <= set(data)
    status, text, r = cl.call("GET", "/")
    assert status == 200 and "<html" in text.lower()
    assert r.getheader("Content-Type").startswith("text/html")
    status, text, _ = cl.call("GET", "/static/main.js")
    assert status == 200 and "fetch" in text


def test_static_traversal_refused(serve, engines, qfile, tmp_path):
    port_svc, _ = _services(engines, qfile)
    cl = serve(port_svc)
    for path in ("/static/../../modern_search_engines_project_tpu_torch/"
                 "config.py", "/static/..%2F..%2FREADME.md",
                 "/static/%2e%2e/templates/index.html", "/static/"):
        status, text, _ = cl.call("GET", path)
        assert status in (403, 404), (path, status)
        assert "dataclass" not in text and "<html" not in text.lower()
    # a symlink inside the static root that leads out of it
    from modern_search_engines_project_tpu_torch.serving import http as web

    root = tmp_path / "static"
    root.mkdir()
    (root / "ok.txt").write_text("inside")
    (tmp_path / "secret.txt").write_text("outside")
    (root / "leak.txt").symlink_to(tmp_path / "secret.txt")
    app = web.Application()
    app.add_static("/static/", root)
    srv = ServerThread(app).start()
    try:
        c = PortClient(srv.port)
        assert c.call("GET", "/static/ok.txt")[:2] == (200, "inside")
        status, text, _ = c.call("GET", "/static/leak.txt")
        assert status == 403 and "outside" not in text
        c.close()
    finally:
        srv.stop()


def _raw(port, data):
    s = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    try:
        s.sendall(data)
        s.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        s.close()


def test_http_framing(serve, engines, qfile):
    """Chunked bodies get 411, bodies over 16 MB 413, malformed requests
    400; keep-alive and pipelined requests on one connection."""
    port_svc, _ = _services(engines, qfile)
    cl = serve(port_svc)
    port = cl.conn.port
    out = _raw(port, b"POST /api/search HTTP/1.1\r\nHost: x\r\n"
                     b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n")
    assert out.startswith(b"HTTP/1.1 411")
    out = _raw(port, b"POST /api/search HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: 20000000\r\n\r\n{}")
    assert out.startswith(b"HTTP/1.1 413")
    for bad in (b"GARBAGE\r\n\r\n", b"GET\r\n\r\n",
                b"POST /api/search HTTP/1.1\r\nContent-Length: -1\r\n\r\n",
                b"POST /api/search HTTP/1.1\r\nbad header\r\n\r\n"):
        assert _raw(port, bad).startswith(b"HTTP/1.1 400"), bad
    payload = json.dumps({"query": "research law", "top_k": 2}).encode()
    one = (b"POST /api/search HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n"
           b"\r\n" % len(payload) + payload)
    assert _raw(port, one * 3).count(b"HTTP/1.1 200 OK") == 3
    # Expect: 100-continue (curl sends it for bodies over 1 KB): the
    # interim answer comes before the body is sent
    c = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    try:
        c.sendall(b"POST /api/search HTTP/1.1\r\nHost: x\r\nExpect: "
                  b"100-continue\r\nContent-Length: %d\r\n\r\n"
                  % len(payload))
        assert c.recv(64) == b"HTTP/1.1 100 Continue\r\n\r\n"
        c.sendall(payload)
        assert c.recv(65536).startswith(b"HTTP/1.1 200 OK")
    finally:
        c.close()
    for i in range(5):  # keep-alive: one connection
        status, data = cl.json("POST", "/api/search",
                               {"query": f"law {i}", "top_k": 2})
        assert status == 200 and len(data["documents"]) <= 2
    assert cl.json("GET", "/api/health")[0] == 200


def test_profile_writes_a_trace(serve, engines, qfile, tmp_path):
    port_svc = SearchService(engines[0], trace_root=str(tmp_path))
    cl = serve(port_svc)
    status, data = cl.json("POST", "/api/profile", {
        "queries": ["research law"], "label": "tr/../ace",
        "out_dir": "/definitely/not/honored"})
    assert status == 200
    assert data["trace_dir"] == str(tmp_path / "trace")
    assert data["queries"] == 1 and data["wall_seconds"] > 0
    traces = list(Path(data["trace_dir"]).glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert events


class TestCacheAndReload:
    """The reference's semantics (tests/test_serving.py), on the port."""

    def test_reload_swaps_engine(self, serve):
        sizes = iter([20, 50])
        factory = lambda: port_engine(next(sizes))  # noqa: E731
        svc = SearchService(factory(), engine_factory=factory)
        cl = serve(svc)
        status, data = cl.json("POST", "/api/reload")
        assert status == 200
        assert data["status"] == "reloaded" and data["n_docs"] == 50
        assert cl.json("POST", "/api/search", {"query": "research law"})[0] \
            == 200
        assert svc.engine.art.n_docs == 50 and svc.batcher.engine is svc.engine

    def test_reload_failure_keeps_old_engine(self, serve):
        def boom():
            raise RuntimeError("disk gone")

        svc = SearchService(port_engine(20), engine_factory=boom)
        old = svc.engine
        status, data = serve(svc).json("POST", "/api/reload")
        assert status == 500 and data == {"error": "reload failed: disk gone"}
        assert svc.engine is old

    def test_reload_listeners_called(self, serve):
        factory = lambda: port_engine(20)  # noqa: E731
        svc = SearchService(factory(), engine_factory=factory)
        seen = []
        svc.reload_listeners.append(seen.append)
        svc.reload_listeners.append(lambda e: 1 / 0)  # must not fail it
        assert serve(svc).json("POST", "/api/reload")[0] == 200
        assert seen == [svc.engine]

    def test_query_cache_hits_skip_device(self, serve):
        factory = lambda: port_engine(30)  # noqa: E731
        svc = SearchService(factory(), engine_factory=factory)
        cl = serve(svc)
        _, r1 = cl.json("POST", "/api/search", {"query": "research law"})
        n = svc.batcher.device_batches
        _, r2 = cl.json("POST", "/api/search", {"query": "research law"})
        assert svc.batcher.device_batches == n and svc._cache_hits == 1

        def strip(d):
            return [{k: v for k, v in doc.items() if k != "query_id"}
                    for doc in d["documents"]]

        assert strip(r1) == strip(r2) and r1["llm_response"] == r2[
            "llm_response"]
        assert cl.json("POST", "/api/reload")[0] == 200
        assert len(svc._query_cache) == 0
        cl.json("POST", "/api/search", {"query": "research law"})
        assert svc.batcher.device_batches == n + 1

    def test_query_cache_disabled_and_lru(self, serve):
        svc = SearchService(port_engine(20), query_cache_size=0)
        cl = serve(svc)
        for _ in range(2):
            cl.json("POST", "/api/search", {"query": "research law"})
        assert svc._cache_hits == 0 and len(svc._query_cache) == 0
        svc = SearchService(port_engine(20), query_cache_size=2)
        cl = serve(svc)
        for q in ("a law", "b law", "c law"):
            cl.json("POST", "/api/search", {"query": q})
        assert len(svc._query_cache) == 2
        assert ("a law", 10) not in svc._query_cache

    def test_soak_search_with_concurrent_reloads(self, serve):
        """120 concurrent searches with 3 reloads mid-flight: every
        response is 200 and well formed (in-flight batches finish on the
        engine they started on)."""
        sizes = itertools.cycle([30, 40])
        factory = lambda: port_engine(next(sizes))  # noqa: E731
        svc = SearchService(factory(), engine_factory=factory,
                            query_cache_size=0)
        port = serve(svc).conn.port
        errs = []

        def client(i):
            c = PortClient(port)
            try:
                for j in range(6):
                    st, data = c.json("POST", "/api/search",
                                      {"query": f"research law {j % 7}"})
                    assert st == 200 and data["documents"], (st, data)
            except Exception as e:  # pragma: no cover
                errs.append(e)
            finally:
                c.close()

        def reloader():
            c = PortClient(port)
            try:
                for _ in range(3):
                    time.sleep(0.05)
                    assert c.json("POST", "/api/reload")[0] == 200
            except Exception as e:  # pragma: no cover
                errs.append(e)
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(20)] + [threading.Thread(target=reloader)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT * 4)
        assert not errs and not any(t.is_alive() for t in threads)


class StubEngine:
    """Fixed per-call latency, batch-size invariant (tests/test_batcher.py's
    stub)."""

    def __init__(self, call_latency_s=0.05):
        self.latency = call_latency_s
        self.calls = []

    def rank_batch(self, queries, augment=True):
        self.calls.append(list(queries))
        time.sleep(self.latency)
        return list(queries)

    def finish_batch(self, raw, queries, top_k=10):
        assert raw == list(queries)
        return [[f"{q}::r{i}" for i in range(top_k)] for q in queries]


def run_concurrent(batcher, queries, top_k=5):
    async def body():
        return await asyncio.gather(*(batcher.search(q, top_k)
                                      for q in queries))

    return asyncio.run(body())


class TestBatcher:
    def test_coalesces_and_routes(self):
        eng = StubEngine()
        batcher = QueryBatcher(eng, ThreadPoolExecutor(max_workers=1),
                               max_batch=64, window_ms=3.0)
        queries = [f"query {i}" for i in range(64)]
        t0 = time.time()
        results = run_concurrent(batcher, queries, top_k=3)
        assert time.time() - t0 < 64 * eng.latency / 5
        assert len(eng.calls) <= 4
        assert batcher.stats()["coalescing_ratio"] >= 16
        for q, r in zip(queries, results):
            assert r == [f"{q}::r0", f"{q}::r1", f"{q}::r2"]

    def test_per_request_top_k_and_overflow(self):
        eng = StubEngine(0.01)
        batcher = QueryBatcher(eng, ThreadPoolExecutor(max_workers=1),
                               max_batch=8, window_ms=2.0)

        async def body():
            return await asyncio.gather(batcher.search("a", 2),
                                        batcher.search("b", 7))

        ra, rb = asyncio.run(body())
        assert len(ra) == 2 and len(rb) == 7
        run_concurrent(batcher, [f"q{i}" for i in range(20)])
        assert max(len(c) for c in eng.calls) <= 8

    def test_engine_failure_propagates(self):
        class Boom(StubEngine):
            def rank_batch(self, queries, augment=True):
                raise RuntimeError("device on fire")

        batcher = QueryBatcher(Boom(), ThreadPoolExecutor(max_workers=1),
                               max_batch=8, window_ms=1.0)
        with pytest.raises(RuntimeError, match="device on fire"):
            run_concurrent(batcher, ["a", "b"])

    def test_batched_matches_unbatched_real_engine(self):
        engine = port_engine(30, seed=5)
        batcher = QueryBatcher(engine, ThreadPoolExecutor(max_workers=1),
                               max_batch=16, window_ms=3.0)
        queries = ["research law", "forest library", "market festival"] * 3
        batched = run_concurrent(batcher, queries, top_k=5)
        assert batcher.device_batches < len(queries)
        for q, ranked in zip(queries, batched):
            direct = engine.search(q, top_k=5)
            assert [r.doc_id for r in ranked] == [r.doc_id for r in direct]
            np.testing.assert_allclose(
                [r.similarity_score for r in ranked],
                [r.similarity_score for r in direct], atol=1e-6)

    def test_concurrent_http_clients_coalesce(self, serve, engines, qfile):
        port_svc, _ = _services(engines, qfile, query_cache_size=0)
        port = serve(port_svc).conn.port
        want = engines[0].search_batch(["research law"], top_k=10)[0]
        errs = []

        def client(_):
            c = PortClient(port)
            try:
                st, data = c.json("POST", "/api/search",
                                  {"query": "research law"})
                assert st == 200
                assert [d["doc_id"] for d in data["documents"]] == [
                    str(r.doc_id) for r in want]
            except Exception as e:  # pragma: no cover
                errs.append(e)
            finally:
                c.close()

        with ThreadPoolExecutor(32) as ex:
            list(ex.map(client, range(32)))
        assert not errs
        assert port_svc.batcher.stats()["coalescing_ratio"] > 1


def test_two_threads_search_batch_indices_at_once(engines):
    """The data plane's pipeline=2 calls one engine from two threads: each
    call's answer equals the serial one."""
    eng = engines[0]
    batches = [[f"research law {i}", "forest library", "market"][: 1 + i % 3]
               for i in range(12)]
    serial = [eng.search_batch_indices(b, top_k=10) for b in batches]
    start = threading.Barrier(2)

    def worker(k):
        start.wait(TIMEOUT)
        return [eng.search_batch_indices(b, top_k=10)
                for b in batches[k::2]]

    with ThreadPoolExecutor(2) as ex:
        even, odd = ex.map(worker, (0, 1))
    got = [None] * len(batches)
    got[0::2], got[1::2] = even, odd
    assert got == serial


def test_extract_domain_topic():
    assert extract_domain_topic("https://www.tuebingen.de/x") == "tuebingen"
    assert extract_domain_topic("https://en.wikipedia.org/w") == "wikipedia"
    assert extract_domain_topic("https://uni-tuebingen.de/") == "uni-tuebingen"
    assert extract_domain_topic("") == extract_domain_topic("#") == "unknown"
