"""HTTP serving load test: concurrent /api/search against a running server.

Counterpart of the reference package's ``eval/load_test.py``: C concurrent
clients fire R requests at the control plane (``serving/api.py`` on the
asyncio server of ``serving/http.py``, on a real loopback port) or at the
C++ data plane (``native/http_server.cpp`` through ``serving/fastpath``);
the batchers coalesce them into device batches.  Reports q/s, latency
percentiles and the coalescing.

The clients are the standard library's: ``http_load`` runs keep-alive
``http.client`` connections, one thread each; ``data_plane_load`` runs the
data plane's epoll generator (``native_http.client_bench``).  Either runs
in a separate process through ``in_subprocess``, so client and server do
not share an interpreter.

Usage (synthetic corpus; on the card unless ``--device cpu``):

    python -m modern_search_engines_project_tpu_torch.eval.load_test \\
        [--docs 20000] [--requests 512] [--concurrency 64] [--device cpu] \\
        [--native stub|pycb|engine] [--stub-device]
"""

from __future__ import annotations

import argparse
import asyncio
import http.client
import json
import os
import random
import subprocess
import sys
import threading
import time
from typing import Sequence

# the directory holding the package, for the client processes
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_service(n_docs: int, summarize: bool = True, seed: int = 7,
                  device=None):
    """(SearchService, vocabulary) over ``n_docs`` synthetic documents
    (``eval/corpus.make_corpus``) indexed with a 64-d hashing encoder;
    ``summarize=False`` swaps the summarizer for one returning ""."""
    from modern_search_engines_project_tpu_torch.config import Config
    from modern_search_engines_project_tpu_torch.eval.corpus import (
        make_corpus,
        make_vocab,
    )
    from modern_search_engines_project_tpu_torch.index import IndexBuilder
    from modern_search_engines_project_tpu_torch.models import HashingEncoder
    from modern_search_engines_project_tpu_torch.retrieval import SearchEngine
    from modern_search_engines_project_tpu_torch.serving.api import SearchService

    cfg = Config(embedding_dim=64, window_size=32, step_size=28)
    enc = HashingEncoder(dim=cfg.embedding_dim)
    docs = make_corpus(n_docs=n_docs, seed=seed,
                       n_domains=max(16, n_docs // 50))
    art = IndexBuilder(enc, cfg).build(docs)
    engine = SearchEngine(art, enc, cfg, device=device)
    service = SearchService(engine)
    if not summarize:
        class _Null:
            def generate_summary(self, q, w):
                return ""

        service.summarizer = _Null()
    return service, make_vocab(400)


def stub_device(engine, queries, latency_ms: float = 0.0) -> None:
    """Replace ``engine._device_rank`` with per-batch-shape cached outputs
    (B = 1, 2, 4, ..., 64 from ``queries``; the device tensors the engine
    finishes from): the serving host's ceiling (batcher, finishing,
    summarizer, JSON) with the device call free; ``latency_ms`` > 0 sleeps
    that long a call, as a device batch would take."""
    cache = {}
    b = 1
    while b <= 64:
        term_ids, qtf, processed = engine.prepare_queries(queries[:b])
        qvec = engine.encode_queries(processed)
        cache[b] = engine._device_rank(term_ids, qtf, qvec)
        b *= 2

    def ranked(t, q, v):
        if latency_ms > 0.0:
            time.sleep(latency_ms / 1e3)
        return cache[t.shape[0]]

    engine._device_rank = ranked


def _pct(lat: list, q: float) -> float:
    return lat[int(q * (len(lat) - 1))] * 1e3 if lat else 0.0


def http_load(port: int, bodies: Sequence[str], n_clients: int,
              n_requests: int, path: str = "/api/search",
              timeout: float = 300.0, host: str = "127.0.0.1") -> dict:
    """``n_clients`` threads, each on one keep-alive ``http.client``
    connection, POST ``n_requests`` requests between them (request k from
    client k mod ``n_clients``, in turn), request k's body
    ``bodies[k % len(bodies)]``.  Returns requests, errors (a status
    other than 200, or an exception), wall_s, qps, p50/p95/p99 ms and
    ``first`` (request 0's parsed body)."""
    lat, errs, first = [], [], {}
    lock = threading.Lock()

    def run(i):
        c = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            for k in range(i, n_requests, n_clients):
                t0 = time.perf_counter()
                try:
                    c.request("POST", path, bodies[k % len(bodies)],
                              {"Content-Type": "application/json"})
                    r = c.getresponse()
                    data = r.read()
                    err = None if r.status == 200 else r.status
                    if k == 0 and err is None:
                        first["body"] = json.loads(data)
                except Exception as e:  # a failed request counts, the run goes on
                    err = repr(e)
                    c.close()
                    c = http.client.HTTPConnection(host, port,
                                                   timeout=timeout)
                dt = time.perf_counter() - t0
                with lock:
                    lat.append(dt)
                    if err is not None:
                        errs.append(err)
        finally:
            c.close()

    t0 = time.perf_counter()
    ts = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    lat.sort()
    return {"requests": len(lat), "errors": len(errs),
            "error_sample": errs[:3], "wall_s": wall,
            "qps": len(lat) / wall, "p50_ms": _pct(lat, 0.5),
            "p95_ms": _pct(lat, 0.95), "p99_ms": _pct(lat, 0.99),
            "first": first.get("body")}


def data_plane_load(port: int, bodies: Sequence[str], n_conns: int = 64,
                    total_requests: int = 4000, timeout_s: int = 600) -> dict:
    """The data plane's epoll generator (``native_http.client_bench``):
    ``n_conns`` connections, ``total_requests`` requests rotating over
    ``bodies``."""
    from modern_search_engines_project_tpu_torch.native.native_http import (
        client_bench,
    )

    return client_bench(port, n_conns=n_conns, total_requests=total_requests,
                        timeout_s=timeout_s, bodies=list(bodies))


def in_subprocess(fn: str, timeout: float = 900.0, **kwargs) -> dict:
    """Run this module's ``fn(**kwargs)`` (``http_load`` or
    ``data_plane_load``) in a separate Python process; its JSON result.
    Raises with the process's output when it fails."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from modern_search_engines_project_tpu_torch.eval import "
            "load_test; kw = json.loads(sys.argv[3]); "
            "print(json.dumps(getattr(load_test, sys.argv[2])(**kw)))")
    out = subprocess.run(
        [sys.executable, "-c", code, _ROOT, fn, json.dumps(kwargs)],
        capture_output=True, text=True, timeout=timeout,
    )
    if out.returncode != 0:
        raise RuntimeError(f"{fn} client process failed: "
                           f"{out.stdout[-400:]} {out.stderr[-800:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def query_pool(vocab, n: int, seed: int = 11) -> list:
    """``n`` queries of 1-3 words from the vocabulary's first 120."""
    rng = random.Random(seed)
    return [" ".join(rng.sample(vocab[:120], rng.randint(1, 3)))
            for _ in range(n)]


async def run_load(service, vocab, n_requests: int, concurrency: int,
                   separate_process: bool = False) -> dict:
    """``n_requests`` /api/search requests (1-3 word queries) from
    ``concurrency`` clients at ``service``'s app, served by the asyncio
    server on a loopback port; every batch shape the batcher can emit is
    warmed first.  Raises when a request is not answered with 200.
    Returns the reference's record (requests, concurrency, wall_s, qps,
    p50_ms, p95_ms, batcher, engine_stages) plus p99_ms and ``sample``
    (the first query and its documents)."""
    from modern_search_engines_project_tpu_torch.serving.http import (
        ServerThread,
    )

    queries = query_pool(vocab, n_requests)
    loop = asyncio.get_running_loop()
    b = 1
    while b <= service.batcher.max_batch:
        await loop.run_in_executor(
            None, lambda n=b: service.engine.search_batch(queries[:n],
                                                          top_k=100))
        b *= 2
    bodies = [json.dumps({"query": q}) for q in queries]
    srv = ServerThread(service.build_app()).start()
    try:
        await loop.run_in_executor(None, lambda: http_load(
            srv.port, bodies[:1], 1, 1))
        kw = dict(port=srv.port, bodies=bodies, n_clients=concurrency,
                  n_requests=n_requests)
        if separate_process:
            res = await loop.run_in_executor(
                None, lambda: in_subprocess("http_load", **kw))
        else:
            res = await loop.run_in_executor(None, lambda: http_load(**kw))
    finally:
        srv.stop()
    if res["errors"]:
        raise RuntimeError(f"{res['errors']} of {res['requests']} requests "
                           f"failed: {res['error_sample']}")
    return {
        "requests": res["requests"],
        "concurrency": concurrency,
        "wall_s": round(res["wall_s"], 3),
        "qps": round(res["qps"], 1),
        "p50_ms": round(res["p50_ms"], 2),
        "p95_ms": round(res["p95_ms"], 2),
        "p99_ms": round(res["p99_ms"], 2),
        "batcher": service.batcher.stats(),
        "engine_stages": (
            service.engine.times.report() if service.engine.times else {}
        ),
        "sample": {"query": queries[0],
                   "documents": (res["first"] or {}).get("documents")},
    }


def run_native(args) -> dict:
    """Load-test the C++ data plane (``native/http_server.cpp``).

    Modes: ``stub`` ranks inside C++ (the host path's ceiling), ``pycb``
    ranks through a canned Python callback (adds the ctypes boundary),
    ``engine`` runs the real device path.  The epoll load generator runs
    in a separate process.  ``args``: the namespace of ``main``'s
    flags."""
    from modern_search_engines_project_tpu_torch.serving.fastpath import (
        attach_engine,
        attach_stub,
        build_fragments,
        make_server,
    )

    service, vocab = build_service(args.docs, summarize=False,
                                   device=args.device)
    engine = service.engine
    srv = make_server(args.port, n_threads=args.server_threads,
                      default_top_k=args.top_k, pipeline=args.pipeline)
    frags = build_fragments(engine.art)
    srv.load_fragments(frags)
    if args.native == "stub":
        attach_stub(srv, len(frags), k=args.top_k)
    elif args.native == "pycb":
        canned = [[(i, 1.0 - i / 1000.0) for i in range(args.top_k)]]

        def rank(queries, top_k):
            return canned * len(queries)

        srv.set_rank_fn(rank)
    bodies = [json.dumps({"query": "law research tübingen",
                          "top_k": args.top_k})]
    if args.native == "engine":
        attach_engine(srv, engine, frags)
        engine.warmup(batch_sizes=(1, 2, 4, 8, 16, 32, 64))
        # distinct queries a coalesced batch drive the batcher and the
        # U-dedup shapes as real traffic does
        rng = random.Random(17)
        bodies = [json.dumps({"query": " ".join(rng.sample(
                      vocab[:120], rng.randint(1, 3))), "top_k": args.top_k})
                  for _ in range(256)]
        pool = [json.loads(b)["query"] for b in bodies]
        for b in (1, 2, 4, 8, 16, 32, 64):
            engine.search_batch_indices(pool[:b], top_k=args.top_k)
    srv.start()
    try:
        time.sleep(0.2)
        client = in_subprocess("data_plane_load", port=srv.port, bodies=bodies,
                            n_conns=args.concurrency,
                            total_requests=args.requests, timeout_s=300)
        stats = srv.stats()
    finally:
        srv.stop()
    return {
        "mode": f"native-{args.native}",
        "docs": args.docs,
        "top_k": args.top_k,
        "pipeline": args.pipeline,
        "device": str(engine.device),
        "client": client,
        "server": stats,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--docs", type=int, default=20000)
    p.add_argument("--requests", type=int, default=512)
    p.add_argument("--concurrency", type=int, default=64)
    p.add_argument("--no-summarize", action="store_true")
    p.add_argument("--native", choices=["stub", "pycb", "engine"],
                   default=None,
                   help="load-test the C++ data plane instead of the "
                        "control plane (see run_native)")
    p.add_argument("--port", type=int, default=5177)
    p.add_argument("--top-k", type=int, default=100)
    p.add_argument("--server-threads", type=int, default=1)
    p.add_argument("--pipeline", type=int, default=1,
                   help="native modes: concurrent dispatcher threads; "
                        "depth D keeps D device batches in flight")
    p.add_argument("--stub-device", action="store_true",
                   help="the host path's ceiling: device outputs cached "
                        "per batch shape and returned at once")
    p.add_argument("--stub-device-ms", type=float, default=0.0,
                   help="like --stub-device, each device call sleeping "
                        "this long")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the engine runs (the card unless cpu)")
    args = p.parse_args(argv)

    if args.native:
        out = run_native(args)
        print(json.dumps(out))
        return out

    service, vocab = build_service(args.docs,
                                   summarize=not args.no_summarize,
                                   device=args.device)
    if args.stub_device or args.stub_device_ms > 0:
        rng = random.Random(3)
        qs = [" ".join(rng.sample(vocab[:120], 2)) for _ in range(64)]
        stub_device(service.engine, qs, latency_ms=args.stub_device_ms)
    out = asyncio.run(run_load(service, vocab, args.requests,
                               args.concurrency, separate_process=True))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
