"""The load generator's schedule, lateness and percentile arithmetic,
against a small HTTP server on 127.0.0.1."""

from __future__ import annotations

import http.server
import json
import threading
import time

import numpy as np
import pytest

from benchmark import cells, queries, stats
from benchmark.loadgen import Reservoir
from benchmark.run import LoadGen


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    delay = 0.02
    fail_every = 0  # answer 500 to query q<i> where (i + 1) % n == 0
    seen = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        q = json.loads(body)["query"]
        _Handler.seen.append((time.monotonic(), q))
        time.sleep(self.delay)
        bad = self.fail_every and (int(q[1:]) + 1) % self.fail_every == 0
        out = json.dumps({"documents": [], "q": q}).encode()
        self.send_response(500 if bad else 200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


@pytest.fixture
def server():
    _Handler.seen = []
    _Handler.fail_every = 0
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        th.join(10)
        assert not th.is_alive()


def _run(port, header, n):
    gen = LoadGen(cells.ROOT)
    try:
        gen.prepare(dict(header, port=port),
                    [json.dumps({"query": f"q{i}"}) for i in range(n)])
        t0 = time.monotonic() + 0.2
        gen.go(t0)
        return t0, gen.result(timeout=60)
    finally:
        gen.kill()


def test_open_loop_keeps_its_schedule(server):
    offsets = queries.arrivals(7, 50.0, 1.0)
    t0, out = _run(server, {"loop": "open", "offsets": offsets.tolist(),
                            "max_connections": 64, "seconds": 1.0,
                            "drain_s": 5, "keep": [0, 3]}, len(offsets))
    rec = sorted(out["records"])
    assert [r[0] for r in rec] == list(range(len(offsets)))
    for r, off in zip(rec, offsets):
        assert r[1] == pytest.approx(t0 + off, abs=1e-9)  # due on schedule
        assert r[2] >= r[1]  # never sent early
        assert r[3] - r[1] >= _Handler.delay  # the reply came after the wait
    late = stats.lateness_ms(rec)
    assert max(late) < 50.0
    assert set(out["bodies"]) == {"0", "3"}
    assert json.loads(out["bodies"]["3"])["q"] == "q3"


def test_open_loop_counts_the_wait_behind_a_stall(server):
    """With one connection and 20 ms a reply, requests due every 5 ms
    queue: latency from the due time grows down the schedule."""
    offsets = np.arange(10) * 0.005
    _, out = _run(server, {"loop": "open", "offsets": offsets.tolist(),
                           "max_connections": 1, "seconds": 0.1,
                           "drain_s": 5, "keep": []}, 10)
    lat = stats.latencies_ms(sorted(out["records"]))
    assert lat[-1] > lat[0] + 100.0  # nine replies of 20 ms, less 45 ms
    assert lat == sorted(lat)


WORDS = [f"t{i}" for i in range(400)]


def _draw(seed=11):
    return {"seed": seed, "words": WORDS, "dfs": list(range(400, 0, -1)),
            "model": {"min_terms": 1, "max_terms": 3}, "exclude": []}


def test_closed_loop_sends_after_each_reply(server):
    _, out = _run(server, {"loop": "closed", "connections": 2, "sample": 4,
                           "draw": _draw(), "seconds": 0.5, "drain_s": 5}, 0)
    rec = out["records"]
    assert 10 < len(rec) < 60  # two connections of ~20 ms replies
    assert all(stats.ok(r) for r in rec)
    # a connection's next request leaves only after its previous reply
    sends = sorted(r[2] for r in rec)
    assert sum(1 for r in rec if r[2] < sends[0] + _Handler.delay) <= 2


def test_closed_loop_draws_fresh_queries_and_keeps_a_sample(server):
    """Every request a fresh query of the stream; the sample's replies
    answer the sample's requests."""
    _Handler.delay = 0.0
    try:
        _, out = _run(server, {"loop": "closed", "connections": 4,
                               "sample": 8, "draw": _draw(),
                               "seconds": 0.5, "drain_s": 5}, 0)
    finally:
        _Handler.delay = 0.02
    sent = [q for _, q in _Handler.seen]
    assert len(sent) == len(out["records"]) > 8
    assert len(set(sent)) == len(sent)
    assert len(out["keep"]) == 8
    for k in out["keep"]:
        q = json.loads(out["requests"][str(k)])["query"]
        assert json.loads(out["bodies"][str(k)])["q"] == q


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(100)
    for seed in range(400):
        r = Reservoir(10, seed)
        for i in range(100):
            r.offer(i)
        assert len(set(r.slots)) == 10
        counts[r.slots] += 1
    assert counts.min() > 15 and counts.max() < 70  # 40 expected each
    a, b = Reservoir(5, 3), Reservoir(5, 3)
    for i in range(50):
        assert a.offer(i) == b.offer(i)


def test_query_stream_never_runs_dry():
    """More queries than a block, all distinct, the excluded never, and
    the same from the same seed."""
    d = _draw()
    words = [f"t{i}" for i in range(5000)]
    first = queries.draw_queries(11, words, np.arange(5000, 0, -1), 3,
                                 d["model"])
    s = queries.QueryStream(11, words, np.arange(5000, 0, -1), d["model"],
                            exclude=first)
    got = [s.next() for _ in range(3 * queries.QueryStream.BLOCK)]
    assert len(set(got)) == len(got)
    assert not set(first) & set(got)
    t = queries.QueryStream(11, words, np.arange(5000, 0, -1), d["model"],
                            exclude=first)
    assert [t.next() for _ in range(50)] == got[:50]


def test_failed_requests_miss_every_limit(server):
    _Handler.fail_every = 4
    offsets = np.arange(20) * 0.01
    _, out = _run(server, {"loop": "open", "offsets": offsets.tolist(),
                           "max_connections": 16, "seconds": 0.2,
                           "drain_s": 5, "keep": []}, 20)
    lat = stats.latencies_ms(out["records"])
    assert sum(1 for x in lat if x == stats.INF) == 5
    assert stats.pct(lat, 0.95) == stats.INF
    assert stats.pct(lat, 0.5) < stats.INF


def test_percentile_is_over_every_request():
    vals = [float(i) for i in range(1, 101)]
    assert stats.pct(vals, 0.5) == 50.0  # nearest rank below
    assert stats.pct(vals, 0.95) == 95.0
    assert stats.pct(vals[::-1], 0.95) == 95.0  # order does not matter
    assert stats.pct([], 0.5) == stats.INF


def test_arrivals_fix_the_work_and_not_the_order():
    a = queries.arrivals(1, 100.0, 2.0)
    b = queries.arrivals(2, 100.0, 2.0)
    assert len(a) == len(b) == 200
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 2.0
    assert not np.array_equal(a, b)
    assert np.array_equal(a, queries.arrivals(1, 100.0, 2.0))
