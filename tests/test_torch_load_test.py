"""The port's load test (``eval/load_test.py``, ``eval/corpus.py``) on the
CPU: its corpus against ``tests/corpus_util.py`` (the reference's load
test's generator), ``stub_device`` against the reference's, ``run_load``
over the asyncio control plane on a loopback port with a standard-library
client, and ``run_native`` over the C++ data plane in ``stub`` and
``engine`` modes.  Servers listen on 127.0.0.1 and are stopped inside each
call; proxy variables are cleared."""

import argparse
import asyncio
import socket

import numpy as np
import pytest

import corpus_util
from modern_search_engines_project_tpu.eval import load_test as ref_lt
from modern_search_engines_project_tpu_torch.eval import corpus
from modern_search_engines_project_tpu_torch.eval import load_test as lt

N_DOCS = 150


@pytest.fixture(autouse=True)
def no_proxy(monkeypatch):
    for var in ("HTTP_PROXY", "HTTPS_PROXY", "ALL_PROXY", "http_proxy",
                "https_proxy", "all_proxy"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def services():
    port_svc, port_vocab = lt.build_service(N_DOCS, summarize=False,
                                            device="cpu")
    ref_svc, ref_vocab = ref_lt.build_service(N_DOCS, summarize=False)
    return port_svc, port_vocab, ref_svc, ref_vocab


@pytest.mark.parametrize("n_docs,seed", [(80, 42), (300, 7), (40, 3)])
def test_corpus_equals_corpus_util(n_docs, seed):
    got = corpus.make_corpus(n_docs=n_docs, seed=seed, n_domains=9)
    want = corpus_util.make_corpus(n_docs=n_docs, seed=seed, n_domains=9)
    assert [(d.doc_id, d.url, d.title, d.text) for d in got] == [
        (d.doc_id, d.url, d.title, d.text) for d in want]
    assert corpus.make_vocab(400) == corpus_util.make_vocab(400)


def test_build_service_matches_reference(services):
    port_svc, port_vocab, ref_svc, ref_vocab = services
    assert port_vocab == ref_vocab
    pa, ra = port_svc.engine.art, ref_svc.engine.art
    assert pa.n_docs == ra.n_docs and pa.n_chunks == ra.n_chunks
    assert list(pa.urls) == list(ra.urls)
    assert port_svc.summarizer.generate_summary("q", ["w"]) == ""


@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 32, 64])
def test_stub_device_caches_the_reference_outputs(services, B):
    """Each batch shape's cached ranking, finished by each engine: the same
    doc ids, scores within 1e-5 (the device layouts number docs in their
    own orders, so the raw outputs are compared through the finish)."""
    port_svc, vocab, ref_svc, _ = services
    qs = [" ".join(vocab[i % 120] for i in (b, b + 7)) for b in range(64)]
    got = stubbed(port_svc.engine, qs, lt.stub_device)[B]
    want = stubbed(ref_svc.engine, qs, ref_lt.stub_device)[B]
    assert [[d for d, _ in r] for r in got] == [[d for d, _ in r]
                                                for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=0, atol=1e-5)


_CACHES = {}


def stubbed(engine, qs, stub):
    """(doc id, score) rows of ``search_batch`` at B = 1, 2, ..., 64 with
    ``engine._device_rank`` stubbed by ``stub`` (each engine once, then
    restored)."""
    if id(engine) not in _CACHES:
        orig = engine._device_rank
        stub(engine, qs)
        _CACHES[id(engine)] = {
            b: [[(d.doc_id, d.similarity_score) for d in r]
                for r in engine.search_batch(qs[:b], top_k=10)]
            for b in (1, 2, 4, 8, 16, 32, 64)}
        engine._device_rank = orig
    return _CACHES[id(engine)]


def test_run_load_answers_every_request():
    svc, vocab = lt.build_service(N_DOCS, summarize=True, device="cpu")
    res = asyncio.run(lt.run_load(svc, vocab, 32, 8))
    assert res["requests"] == 32 and res["concurrency"] == 8
    assert res["qps"] > 0 and res["p50_ms"] <= res["p95_ms"] <= res["p99_ms"]
    assert res["batcher"]["requests"] >= 32
    sample = res["sample"]
    want = svc.engine.search_batch([sample["query"]], top_k=100)[0]
    assert [int(d["doc_id"]) for d in sample["documents"]] == [
        w.doc_id for w in want]


def test_http_load_counts_failures():
    """A status other than 200 is counted, not raised, by the client."""
    svc, vocab = lt.build_service(40, summarize=False, device="cpu")
    from modern_search_engines_project_tpu_torch.serving.http import (
        ServerThread,
    )

    srv = ServerThread(svc.build_app()).start()
    try:
        res = lt.http_load(srv.port, ['{"query": "castle"}', "not json"], 2, 6)
    finally:
        srv.stop()
    assert res["requests"] == 6 and res["errors"] == 3
    assert "documents" in res["first"]


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("mode", ["stub", "engine"])
def test_run_native(mode):
    args = argparse.Namespace(
        docs=N_DOCS, requests=48, concurrency=8, native=mode,
        port=free_port(), top_k=10, server_threads=1, pipeline=1,
        device="cpu")
    rec = lt.run_native(args)
    assert rec["mode"] == f"native-{mode}" and rec["device"] == "cpu"
    assert rec["client"]["requests"] == 48 and rec["client"]["errors"] == 0
    assert rec["server"]["served"] >= 48
    if mode == "engine":
        assert rec["server"]["batches"] > 0


def test_main_takes_a_device(capsys):
    out = lt.main(["--device", "cpu", "--docs", "60", "--requests", "16",
                   "--concurrency", "4", "--no-summarize", "--stub-device"])
    assert out["requests"] == 16
    with pytest.raises(SystemExit):
        lt.main(["--device", "tpu"])
