"""The port's serving CLI booted as a real process on the CPU
(``python -m modern_search_engines_project_tpu_torch.serving --device
cpu``): the demo index with and without the C++ data plane, a saved index
with ``--int8-bank`` on both planes, ``--workers 2`` sharing one port, a
clean exit on SIGTERM, ``--sharded`` (one CPU shard) and ``--mesh 2,4``
(eight CPU shards) serving the demo index as the one-device server does,
and both exiting non-zero with ``--device cuda`` where too few cards are
visible."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from corpus_util import make_corpus
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import (
    IndexBuilder,
    save_artifacts,
)
from modern_search_engines_project_tpu_torch.models import HashingEncoder

REPO = Path(__file__).resolve().parents[1]
MODULE = "modern_search_engines_project_tpu_torch.serving"
# no proxy for 127.0.0.1, whatever the environment says
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = {k: v for k, v in os.environ.items()
           if k.lower() not in ("http_proxy", "https_proxy", "all_proxy")}
    env["PYTHONPATH"] = str(REPO)
    return env


@pytest.fixture
def boot(tmp_path):
    """boot(*flags) -> (proc, port); every process is stopped in a
    finaliser (SIGTERM, then SIGKILL)."""
    procs = []

    def start(*flags):
        port = _free_port()
        log = open(tmp_path / f"server_{port}.log", "wb")  # never fills up
        proc = subprocess.Popen(
            [sys.executable, "-m", MODULE, "--device", "cpu", "--host",
             "127.0.0.1", "--port", str(port), *flags],
            stdout=log, stderr=subprocess.STDOUT, env=_env(),
            cwd=str(tmp_path),
        )
        proc.log_path = log.name
        procs.append((proc, log))
        return proc, port

    yield start
    for proc, log in procs:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        log.close()


def _get(url, timeout=10):
    with OPENER.open(url, timeout=timeout) as r:
        return json.loads(r.read()), r.headers


def _post(port, path, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with OPENER.open(req, timeout=timeout) as r:
        return json.loads(r.read()), r.headers


def _wait_health(port, proc, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            out = Path(proc.log_path).read_text(errors="replace")[-3000:]
            raise AssertionError(f"server exited rc={proc.returncode}: {out}")
        try:
            return _get(f"http://127.0.0.1:{port}/api/health", 2)[0]
        except OSError:
            time.sleep(0.3)
    raise AssertionError("server never became healthy")


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    return proc.wait(timeout=30)


def test_demo_index_boot_search_and_sigterm(boot):
    proc, port = boot("--query-cache", "16", "--no-warmup")
    assert _wait_health(port, proc)["search_engine_ready"] is True
    data, headers = _post(port, "/api/search",
                          {"query": "castle neckar", "top_k": 3})
    assert data["documents"] and data["documents"][0]["rank"] == 1
    assert data["documents"][0]["url"] == "https://www.tuebingen.de/en/schloss"
    assert headers["Access-Control-Allow-Origin"] == "*"
    stats, _ = _get(f"http://127.0.0.1:{port}/api/stats")
    assert stats["total_documents"] == 11
    assert _stop(proc) in (0, -signal.SIGTERM)


def test_dual_plane_boot_from_saved_index_int8(boot, tmp_path):
    """A saved index served with --int8-bank and --fastpath-port: both
    planes answer /api/search with the same docs and scores."""
    docs = make_corpus(n_docs=50, seed=3, min_len=40, max_len=120)
    cfg = Config(embedding_dim=32, window_size=32, step_size=25,
                 top_k_retrieval=20, top_k_reranking=10, max_query_terms=8)
    save_artifacts(IndexBuilder(HashingEncoder(dim=32), cfg).build(docs),
                   str(tmp_path / "index"))
    fast_port = _free_port()
    proc, port = boot("--index", str(tmp_path / "index"), "--int8-bank",
                      "--fastpath-port", str(fast_port))
    _wait_health(port, proc)
    assert _get(f"http://127.0.0.1:{fast_port}/api/health")[0]["status"] \
        == "healthy"
    for q in ("research law", "research square law"):
        fast, _ = _post(fast_port, "/api/search", {"query": q, "top_k": 5})
        slow, _ = _post(port, "/api/search", {"query": q, "top_k": 5})
        assert fast["documents"]
        assert [d["doc_id"] for d in fast["documents"]] == [
            d["doc_id"] for d in slow["documents"]]
        for a, b in zip(fast["documents"], slow["documents"]):
            assert abs(a["score"] - b["score"]) < 1e-5
            assert a["snippet"] == b["snippet"]
    assert _stop(proc) in (0, -signal.SIGTERM)


def test_two_workers_share_port(boot):
    proc, port = boot("--workers", "2", "--query-cache", "0", "--no-warmup")
    _wait_health(port, proc, timeout=180)
    workers = set()
    for i in range(16):
        data, headers = _post(port, "/api/search",
                              {"query": f"tuebingen castle {i}"})
        assert "documents" in data
        workers.add(headers["X-Worker"])
    assert workers <= {"0", "1"} and workers
    assert _stop(proc) in (0, -signal.SIGTERM)


@pytest.mark.parametrize("flags", [["--sharded"], ["--mesh", "2,4"]])
def test_sharded_and_mesh_exit_non_zero(flags):
    """``--device cuda`` with fewer cards than the mesh needs exits
    non-zero with the mesh constructor's message: no card at all for
    ``--sharded``, fewer than eight for ``--mesh 2,4`` (never one card or
    the CPU quietly)."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n >= (1 if flags[0] == "--sharded" else 8):
        pytest.skip(f"{n} cards visible: {flags} would serve")
    out = subprocess.run(
        [sys.executable, "-m", MODULE, "--device", "cuda", "--port",
         str(_free_port()), *flags],
        capture_output=True, text=True, env=_env(), timeout=120,
    )
    assert out.returncode != 0
    want = "no CUDA device" if flags[0] == "--sharded" else "Mesh("
    assert want in out.stderr, out.stderr[-2000:]


@pytest.mark.parametrize("flags,shape", [
    (["--sharded"], "('shard',) mesh (1,)"),
    (["--mesh", "2,4"], "('dp', 'shard') mesh (2, 4)"),
], ids=["sharded", "mesh-2x4"])
def test_sharded_and_mesh_serve_search(boot, flags, shape):
    """The sharded engine behind /api/search on CPU shards: the same
    documents and scores as the one-device server on the demo index."""
    proc, port = boot(*flags, "--query-cache", "0", "--no-warmup")
    one, one_port = boot("--query-cache", "0", "--no-warmup")
    _wait_health(port, proc)
    _wait_health(one_port, one)
    for q in ("castle neckar", "tuebingen university research"):
        got, _ = _post(port, "/api/search", {"query": q, "top_k": 5})
        want, _ = _post(one_port, "/api/search", {"query": q, "top_k": 5})
        assert got["documents"]
        assert [d["doc_id"] for d in got["documents"]] == [
            d["doc_id"] for d in want["documents"]]
        for a, b in zip(got["documents"], want["documents"]):
            assert abs(a["score"] - b["score"]) < 1e-5
    assert _stop(proc) in (0, -signal.SIGTERM)
    assert shape in Path(proc.log_path).read_text(errors="replace")
