"""The torch port's C++ data plane (``native/http_server.cpp`` through
``native/native_http.py`` and ``serving/fastpath.py``), on the CPU.

The reference's data-plane tests (tests/test_native_http.py) that need no
accelerator, run against the port's build: the stub server's schema,
keep-alive, half-closed clients, the load generator, malformed input and
fuzz, the Python rank callback's round trip and pipelined dispatchers, and
the engine path against the port engine's ``search_batch`` (device="cpu").
Every socket has a timeout and every server is stopped in a finaliser."""

import http.client
import json
import socket
import threading

import pytest

from corpus_util import make_corpus
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import IndexBuilder
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.native import native_http
from modern_search_engines_project_tpu_torch.native.native_http import (
    FastHttpServer,
    client_bench,
)
from modern_search_engines_project_tpu_torch.retrieval import SearchEngine


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def post(port, path, payload, conn=None):
    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    c.request(
        "POST", path, json.dumps(payload),
        {"Content-Type": "application/json"},
    )
    r = c.getresponse()
    body = json.loads(r.read())
    if conn is None:
        c.close()
    return r.status, body


@pytest.fixture(scope="module")
def stub_server():
    srv = FastHttpServer(free_port(), n_threads=1)
    frags = [
        (
            f'"url": "https://d{i % 5}.de/p{i}", "title": "Doc {i}", '
            f'"snippet": "sn\\u00e9ppet {i}", "domain": "d{i % 5}", '
            f'"doc_id": "{i}"'
        ).encode()
        for i in range(50)
    ]
    srv.load_fragments(frags)
    srv.set_stub(list(range(20)), [0.95 - 0.01 * i for i in range(20)])
    srv.start()
    yield srv
    srv.stop()


class TestStubServer:
    def test_health(self, stub_server):
        c = http.client.HTTPConnection("127.0.0.1", stub_server.port, timeout=5)
        c.request("GET", "/api/health")
        r = c.getresponse()
        assert r.status == 200
        assert json.loads(r.read())["status"] == "healthy"
        c.close()

    def test_search_schema(self, stub_server):
        status, body = post(
            stub_server.port, "/api/search",
            {"query": "tübingen", "top_k": 5, "query_id": 'q"x\\y'},
        )
        assert status == 200
        assert body["llm_response"] == ""
        docs = body["documents"]
        assert len(docs) == 5
        assert [d["rank"] for d in docs] == [1, 2, 3, 4, 5]
        assert docs[0]["query_id"] == 'q"x\\y'  # escape round trip
        assert docs[0]["url"] == "https://d0.de/p0"
        assert docs[0]["score"] == pytest.approx(0.95, abs=1e-6)
        assert docs[1]["doc_id"] == "1"

    def test_missing_query_400(self, stub_server):
        status, body = post(stub_server.port, "/api/search", {})
        assert status == 400 and "error" in body

    def test_unknown_path_404(self, stub_server):
        status, _ = post(stub_server.port, "/nope", {"x": 1})
        assert status == 404

    def test_keep_alive_sequence(self, stub_server):
        c = http.client.HTTPConnection("127.0.0.1", stub_server.port, timeout=10)
        for i in range(20):
            status, body = post(
                stub_server.port, "/api/search",
                {"query": f"q{i}", "top_k": 3}, conn=c,
            )
            assert status == 200 and len(body["documents"]) == 3
        c.close()

    def test_concurrent_clients(self, stub_server):
        errs = []

        def worker(n):
            try:
                for i in range(10):
                    status, body = post(
                        stub_server.port, "/api/search",
                        {"query": f"w{n}-{i}"},
                    )
                    assert status == 200
            except Exception as exc:  # pragma: no cover
                errs.append(exc)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs
        stats = stub_server.stats()
        assert stats["served"] >= 80

    def test_half_closed_client_gets_full_response(self, stub_server):
        """A client that shuts down its write side after sending the
        request (half-close: EOF arrives before/with the request) must
        still receive the complete response before the server closes."""
        s = socket.create_connection(
            ("127.0.0.1", stub_server.port), timeout=10
        )
        payload = json.dumps({"query": "half", "top_k": 20}).encode()
        s.sendall(
            b"POST /api/search HTTP/1.1\r\n"
            b"Host: x\r\nContent-Type: application/json\r\n"
            + b"Content-Length: %d\r\n\r\n" % len(payload)
            + payload
        )
        s.shutdown(socket.SHUT_WR)  # EOF reaches the server early
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        s.close()
        head, _, body = data.partition(b"\r\n\r\n")
        assert b"200" in head.split(b"\r\n")[0]
        assert len(json.loads(body)["documents"]) == 20

    def test_half_closed_slow_reader_large_body(self):
        """Half-close + a body far larger than the kernel socket buffers,
        read slowly: the server must keep the connection open until its
        write buffer drains via EPOLLOUT.  Regression: the event loop
        closed half-closed conns as soon as the rank result landed,
        truncating partially-flushed bodies (and cleared-wbuf close on
        the first EPOLLOUT)."""
        import time

        srv = FastHttpServer(free_port(), n_threads=1)
        # ~64 KB per fragment x top_k 50 => ~3.2 MB response, far beyond
        # any default send buffer.
        big = "x" * 65536
        srv.load_fragments(
            [
                f'"url": "u{i}", "doc_id": "{i}", "pad": "{big}"'.encode()
                for i in range(50)
            ]
        )
        srv.set_stub(list(range(50)), [1.0 - 0.01 * i for i in range(50)])
        srv.start()
        try:
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
            s.connect(("127.0.0.1", srv.port))
            s.settimeout(10)
            payload = json.dumps({"query": "big", "top_k": 50}).encode()
            s.sendall(
                b"POST /api/search HTTP/1.1\r\n"
                b"Host: x\r\nContent-Type: application/json\r\n"
                + b"Content-Length: %d\r\n\r\n" % len(payload)
                + payload
            )
            s.shutdown(socket.SHUT_WR)
            time.sleep(0.2)  # let the server hit EAGAIN mid-body
            data = b""
            while True:
                chunk = s.recv(8192)
                if not chunk:
                    break
                data += chunk
                time.sleep(0.001)  # stay slower than the server's writes
            s.close()
            head, _, body = data.partition(b"\r\n\r\n")
            assert b"200" in head.split(b"\r\n")[0]
            assert len(json.loads(body)["documents"]) == 50
        finally:
            srv.stop()

    def test_client_bench(self, stub_server):
        out = client_bench(
            stub_server.port, n_conns=8, total_requests=500,
            body='{"query": "bench", "top_k": 10}',
        )
        assert out["requests"] == 500 and out["errors"] == 0
        assert out["qps"] > 100

    def test_client_bench_body_pool_rotates(self):
        """The multi-body load generator must actually rotate the pool:
        every distinct query reaches the rank callback (a single repeated
        body would flatter U-dedup/batching numbers — the reason the pool
        exists)."""
        srv = FastHttpServer(free_port(), n_threads=1, batch_window_us=500)
        srv.load_fragments(
            [f'"url": "u{i}", "doc_id": "{i}"'.encode() for i in range(4)]
        )
        seen = set()
        lock = threading.Lock()

        def rank(queries, top_k):
            with lock:
                seen.update(queries)
            return [[(0, 1.0)]] * len(queries)

        srv.set_rank_fn(rank)
        srv.start()
        try:
            bodies = [
                json.dumps({"query": f"pool query {i}", "top_k": 2})
                for i in range(7)
            ]
            out = client_bench(
                srv.port, n_conns=4, total_requests=100, bodies=bodies,
            )
            assert out["requests"] == 100 and out["errors"] == 0
            assert seen == {f"pool query {i}" for i in range(7)}
        finally:
            srv.stop()


class TestRobustness:
    """Hostile-input handling: the data plane parses HTTP from untrusted
    sockets, so malformed framing must never crash the server or
    desynchronize subsequent requests on other connections."""

    def _health_ok(self, port):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        c.request("GET", "/api/health")
        ok = c.getresponse().status == 200
        c.close()
        return ok

    def _raw(self, port, data, expect_reply=True):
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        s.sendall(data)
        s.shutdown(socket.SHUT_WR)
        out = b""
        try:
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                out += chunk
        except socket.timeout:
            pass
        s.close()
        return out

    def test_content_length_overflow_rejected(self, stub_server):
        """SIZE_MAX-ish and negative Content-Length values must get 413
        (not wrap `total` and misframe the stream)."""
        for bad in (b"18446744073709551615", b"-1", b"99999999999999999999"):
            out = self._raw(
                stub_server.port,
                b"POST /api/search HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: " + bad + b"\r\n\r\n{}",
            )
            assert b"413" in out.split(b"\r\n")[0]
            assert self._health_ok(stub_server.port)

    def test_oversized_declared_body_rejected(self, stub_server):
        out = self._raw(
            stub_server.port,
            b"POST /api/search HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: 20000000\r\n\r\n" + b"x" * 1024,
        )
        assert b"413" in out.split(b"\r\n")[0]
        assert self._health_ok(stub_server.port)

    def test_malformed_request_lines(self, stub_server):
        for req in (
            b"GARBAGE\r\n\r\n",
            b"GET\r\n\r\n",
            b"\r\n\r\n",
            b"POST /api/search HTTP/1.1\r\nContent-Length: abc\r\n\r\n",
            b"\x00\x01\x02\xff\xfe garbage \r\n\r\n",
        ):
            self._raw(stub_server.port, req)
            assert self._health_ok(stub_server.port)

    def test_truncated_then_closed(self, stub_server):
        # header promises a body that never arrives; client goes away
        s = socket.create_connection(("127.0.0.1", stub_server.port), 5)
        s.sendall(
            b"POST /api/search HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: 100\r\n\r\n{\"query\""
        )
        s.close()
        assert self._health_ok(stub_server.port)

    def test_pipelined_requests_one_write(self, stub_server):
        payload = json.dumps({"query": "pipe", "top_k": 2}).encode()
        one = (
            b"POST /api/search HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: %d\r\n\r\n" % len(payload) + payload
        )
        out = self._raw(stub_server.port, one * 5)
        assert out.count(b"HTTP/1.1 200") == 5

    def test_nul_and_unicode_in_query(self, stub_server):
        status, body = post(
            stub_server.port, "/api/search",
            {"query": "tübingen \x00 \U0001f600", "top_k": 2},
        )
        assert status == 200 and len(body["documents"]) == 2

    def test_random_fuzz_server_survives(self, stub_server):
        import random as _r

        rng = _r.Random(1234)
        pieces = [
            b"POST ", b"GET ", b"/api/search", b"/api/health", b" HTTP/1.1",
            b"\r\n", b"\n", b"Content-Length: ", b"0", b"5", b"-3",
            b"99999999999", b'{"query": "x"}', b"\x00\xff\xfe",
            b"A" * 333, b": ", b"Transfer-Encoding: chunked",
        ]
        for _ in range(120):
            blob = b"".join(
                rng.choice(pieces) for _ in range(rng.randint(1, 12))
            )
            try:
                self._raw(stub_server.port, blob)
            except (ConnectionResetError, BrokenPipeError):
                pass  # server may slam the door; it must not die
        assert self._health_ok(stub_server.port)
        # and still serves real traffic correctly afterwards
        status, body = post(
            stub_server.port, "/api/search", {"query": "after fuzz"},
        )
        assert status == 200 and body["documents"]


class TestPythonCallback:
    def test_rank_roundtrip_and_batching(self):
        srv = FastHttpServer(free_port(), n_threads=1, batch_window_us=2000)
        srv.load_fragments(
            [f'"url": "u{i}", "doc_id": "{i}"'.encode() for i in range(10)]
        )
        seen_batches = []

        def rank(queries, top_k):
            seen_batches.append(list(queries))
            # echo: query "qN" ranks chunk N first
            out = []
            for q in queries:
                n = int(q[1:]) % 10
                out.append([(n, 0.5), ((n + 1) % 10, 0.25)])
            return out

        srv.set_rank_fn(rank)
        srv.start()
        try:
            status, body = post(srv.port, "/api/search", {"query": "q3"})
            assert status == 200
            assert body["documents"][0]["url"] == "u3"
            assert body["documents"][1]["url"] == "u4"
            # unicode query crosses the boundary intact
            marker = []

            def rank2(queries, top_k):
                marker.append(queries[0])
                return [[(0, 1.0)]] * len(queries)

            srv.set_rank_fn(rank2)
            post(srv.port, "/api/search", {"query": "tübingen blaubeuren"})
            assert marker == ["tübingen blaubeuren"]
        finally:
            srv.stop()

    def test_pipelined_dispatchers_overlap_device_wait(self):
        """pipeline=3: three dispatcher threads keep three 'device' batches
        in flight.  A rank callback that sleeps 120 ms (time.sleep releases
        the GIL, as a device wait does) over 6 forced-batch-of-1
        requests must finish in ~2 rounds (~240 ms), not 6 serial rounds
        (~720 ms).  Also asserts responses still map to their own queries
        (per-conn ordering is by construction: one in-flight rank/conn)."""
        import time

        srv = FastHttpServer(
            free_port(), n_threads=2, max_batch=1, batch_window_us=0,
            pipeline=3,
        )
        srv.load_fragments(
            [f'"url": "u{i}", "doc_id": "{i}"'.encode() for i in range(10)]
        )

        def rank(queries, top_k):
            time.sleep(0.12)
            return [[(int(q[1:]) % 10, 0.9)] for q in queries]

        srv.set_rank_fn(rank)
        srv.start()
        try:
            results = {}

            def one(i):
                status, body = post(srv.port, "/api/search", {"query": f"q{i}"})
                results[i] = (status, body["documents"][0]["url"])

            threads = [
                threading.Thread(target=one, args=(i,)) for i in range(6)
            ]
            t0 = time.time()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            elapsed = time.time() - t0
            for i in range(6):
                assert results[i] == (200, f"u{i}")
            # serial would be >= 0.72 s; 3-deep pipelining bounds it by
            # ~2 rounds + overhead.  0.5 s keeps CI slack while still
            # PROVING overlap happened.
            assert elapsed < 0.5, f"no dispatch overlap: {elapsed:.2f}s"
            stats = srv.stats()
            assert stats["batches"] == 6
        finally:
            srv.stop()

    def test_rank_exception_yields_500(self):
        srv = FastHttpServer(free_port(), n_threads=1)
        srv.load_fragments([b'"url": "u0", "doc_id": "0"'])

        def rank(queries, top_k):
            raise RuntimeError("boom")

        srv.set_rank_fn(rank)
        srv.start()
        try:
            status, body = post(srv.port, "/api/search", {"query": "x"})
            assert status == 500 and "error" in body
        finally:
            srv.stop()


class TestEngineFastpath:
    def test_results_match_search_batch(self):
        """The native plane must rank exactly like the Python plane: same
        engine, same finishing — compare urls + scores for a few
        queries."""
        from modern_search_engines_project_tpu_torch.serving.fastpath import (
            attach_engine,
            make_server,
        )

        docs = make_corpus(n_docs=60, seed=5, min_len=40, max_len=120)
        cfg = Config(
            embedding_dim=32, window_size=32, step_size=25,
            top_k_retrieval=30, top_k_reranking=10, max_query_terms=8,
        )
        enc = HashingEncoder(dim=32)
        engine = SearchEngine(IndexBuilder(enc, cfg).build(docs), enc, cfg,
                              device="cpu")
        srv = make_server(free_port(), default_top_k=10)
        attach_engine(srv, engine)
        srv.start()
        try:
            for q in ("research law", "neckar river", "law"):
                status, body = post(
                    srv.port, "/api/search", {"query": q, "top_k": 7}
                )
                assert status == 200
                want = engine.search_batch([q], top_k=7)[0]
                got = body["documents"]
                assert [d["url"] for d in got] == [r.url for r in want]
                for d, r in zip(got, want):
                    assert d["score"] == pytest.approx(
                        r.similarity_score, rel=1e-4
                    )
                    assert d["snippet"].startswith(
                        (r.window_text or "")[:40]
                    ) or r.window_text == ""
        finally:
            srv.stop()

    @staticmethod
    def _engine(n_docs, seed):
        docs = make_corpus(n_docs=n_docs, seed=seed, min_len=40, max_len=120)
        cfg = Config(
            embedding_dim=32, window_size=32, step_size=25,
            top_k_retrieval=20, top_k_reranking=10, max_query_terms=8,
        )
        enc = HashingEncoder(dim=32)
        return SearchEngine(IndexBuilder(enc, cfg).build(docs), enc, cfg,
                            device="cpu")

    def test_reattach_under_load_swaps_index(self):
        """attach_engine on a RUNNING server (what /api/reload triggers via
        reload_listeners) must swap fragments + rank callback safely while
        concurrent requests are in flight, and answers must come from the
        new index afterwards."""
        from modern_search_engines_project_tpu_torch.serving.fastpath import (
            attach_engine,
            make_server,
        )

        e1 = self._engine(40, seed=5)
        e2 = self._engine(70, seed=11)
        srv = make_server(free_port(), default_top_k=10)
        attach_engine(srv, e1)
        srv.start()
        stop = threading.Event()
        errs = []

        def hammer():
            while not stop.is_set():
                try:
                    status, body = post(
                        srv.port, "/api/search", {"query": "research law"}
                    )
                    assert status == 200 and body["documents"]
                except Exception as exc:  # pragma: no cover
                    errs.append(exc)
                    return

        t = threading.Thread(target=hammer)
        t.start()
        try:
            import time as _t

            _t.sleep(0.1)
            attach_engine(srv, e2)  # the reload listener's exact call
            _t.sleep(0.1)
            stop.set()
            t.join(timeout=10)
            assert not errs
            _, body = post(
                srv.port, "/api/search", {"query": "research law", "top_k": 5}
            )
            want = e2.search_batch(["research law"], top_k=5)[0]
            assert [d["url"] for d in body["documents"]] == [
                r.url for r in want
            ]
        finally:
            stop.set()
            srv.stop()

    def test_reload_listener_keeps_planes_consistent(self):
        """SearchService.reload_listeners: after POST /api/reload the
        native plane serves the NEW engine's rankings (the serving CLI
        registers exactly this listener)."""
        from modern_search_engines_project_tpu_torch.serving.api import (
            SearchService,
        )
        from modern_search_engines_project_tpu_torch.serving.fastpath import (
            attach_engine,
            make_server,
        )
        from modern_search_engines_project_tpu_torch.serving.http import (
            ServerThread,
        )

        engines = iter([self._engine(40, seed=5), self._engine(70, seed=11)])
        factory = lambda: next(engines)  # noqa: E731
        svc = SearchService(factory(), engine_factory=factory)
        srv = make_server(free_port(), default_top_k=10)
        attach_engine(srv, svc.engine)
        svc.reload_listeners.append(
            lambda eng, _f=srv: attach_engine(_f, eng)
        )
        srv.start()
        ctl = ServerThread(svc.build_app()).start()
        try:
            assert post(ctl.port, "/api/reload", {})[0] == 200
            assert svc.engine.art.n_docs == 70
            _, resp = post(
                srv.port, "/api/search", {"query": "research law", "top_k": 5}
            )
            want = svc.engine.search_batch(["research law"], top_k=5)[0]
            assert [d["url"] for d in resp["documents"]] == [
                r.url for r in want
            ]
        finally:
            ctl.stop()
            srv.stop()


def test_library_builds_outside_the_package():
    """The library lands under build/native/<hash>/, never beside the
    source, and a failed build raises with g++'s output."""
    so = native_http.build()
    assert so == native_http.library_path() and so.exists()
    assert so.parent.parent == native_http.BUILD_ROOT
    assert not list(native_http.SRC.parent.glob("*.so"))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "http_server.cpp"
    bad.write_text("int main( {")
    monkeypatch.setattr(native_http, "SRC", bad)
    monkeypatch.setattr(native_http, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_http.build()


def test_stub_plane_times_each_request():
    """Every request taken into a batch is counted with its queue wait,
    which holds the batch window it was given; host time and the
    histogram's percentiles cover every reply."""
    window_us = 20_000
    srv = FastHttpServer(free_port(), n_threads=1, batch_window_us=window_us)
    srv.load_fragments([b'"url": "u0", "doc_id": "0"'])
    srv.set_stub([0], [1.0])
    srv.start()
    try:
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        for i in range(6):  # one at a time: each waits out the window
            assert post(srv.port, "/api/search", {"query": f"q{i}"},
                        conn=c)[0] == 200
        c.close()
        st = srv.stats()
    finally:
        srv.stop()
    assert st["queued"] == st["served"] == st["batched_queries"] == 6
    assert st["queue_wait_us"] >= 6 * window_us
    assert st["host_us"] >= st["queue_wait_us"]
    assert 0 < st["host_p50_ms"] <= st["host_p95_ms"] <= st["host_p99_ms"]
    assert st["host_p50_ms"] >= window_us / 1e3 * 0.95  # bucket precision
    assert srv.stats() == {}  # stopped


def test_engine_plane_records_copy_out_and_request_timing():
    """attach_engine hands the plane the engine's StageTimes: the
    callback's copy-out is one span a batch, and the plane's request
    timing reads as counters beside the engine's stages."""
    from modern_search_engines_project_tpu_torch.serving.fastpath import (
        attach_engine,
        make_server,
    )

    engine = TestEngineFastpath._engine(40, seed=5)
    srv = make_server(free_port(), default_top_k=10)
    attach_engine(srv, engine)
    srv.start()
    try:
        for q in ("research law", "neckar river", "law"):
            assert post(srv.port, "/api/search", {"query": q})[0] == 200
        st = srv.stats()
        r = engine.times.report()
    finally:
        srv.stop()
    assert r["plane_copy_out"]["count"] == st["batches"] == 3
    assert r["finish_indices"]["count"] == 3
    assert r["plane_queue_wait"]["count"] == st["queued"] == 3
    assert r["plane_queue_wait"]["total_s"] == pytest.approx(
        st["queue_wait_us"] / 1e6, abs=1e-4)
    assert r["plane_host"]["count"] == st["served"] == 3
    assert r["plane_host"]["mean_ms"] >= r["plane_copy_out"]["mean_ms"]
    assert "plane_queue_wait" not in engine.times.report()  # stopped


def test_engine_plane_follows_a_replaced_registry():
    """The copy-out span and the plane's counters go to the registry the
    engine holds at each batch, not to the one it held at attach time."""
    from modern_search_engines_project_tpu_torch.serving.fastpath import (
        attach_engine,
        make_server,
    )
    from modern_search_engines_project_tpu_torch.utils.timing import (
        StageTimes,
    )

    engine = TestEngineFastpath._engine(40, seed=5)
    srv = make_server(free_port(), default_top_k=10)
    attach_engine(srv, engine)
    srv.start()
    try:
        assert post(srv.port, "/api/search", {"query": "law"})[0] == 200
        old = engine.times
        engine.times = StageTimes()
        for q in ("research law", "neckar river"):
            assert post(srv.port, "/api/search", {"query": q})[0] == 200
        r, r_old = engine.times.report(), old.report()
    finally:
        srv.stop()
    assert r_old["plane_copy_out"]["count"] == 1
    assert r["plane_copy_out"]["count"] == r["device_rank"]["count"] == 2
    assert r["plane_queue_wait"]["count"] == 3  # the plane's, since start
