"""The port's multi-process sharded serving (``parallel/multihost.py``):
two real OS processes with four CPU shards each join one
``torch.distributed`` group over gloo, flat and hierarchical.  Both print
the same ranking, equal to the reference's unsharded single-process
oracle on the same demo corpus (the shape of ``tests/test_multihost.py``).

Tolerance: scores rounded to 4 places by both sides, held to 2e-4, as the
reference's test holds its own; doc ids equal except across score ties.
Every subprocess has a timeout.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
MODULE = "modern_search_engines_project_tpu_torch.parallel.multihost"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_cluster(n_proc, devs_per_proc, hierarchical=False):
    env = {k: v for k, v in os.environ.items()
           if k.lower() not in ("http_proxy", "https_proxy", "all_proxy")}
    env["PYTHONPATH"] = str(REPO)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", MODULE, "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", str(n_proc),
             "--process-id", str(pid), "--devices-per-process",
             str(devs_per_proc), "--device", "cpu"]
            + (["--hierarchical"] if hierarchical else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True,
        )
        for pid in range(n_proc)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    return outs


@pytest.fixture(scope="module")
def oracle():
    from modern_search_engines_project_tpu.config import Config
    from modern_search_engines_project_tpu.index import IndexBuilder
    from modern_search_engines_project_tpu.models import HashingEncoder
    from modern_search_engines_project_tpu.parallel.multihost import (
        QUERIES,
        demo_corpus,
    )
    from modern_search_engines_project_tpu.retrieval import SearchEngine

    cfg = Config(embedding_dim=32, window_size=32, step_size=25,
                 top_k_retrieval=32, top_k_reranking=8, max_query_terms=8)
    enc = HashingEncoder(dim=32)
    single = SearchEngine(IndexBuilder(enc, cfg).build(demo_corpus(64)), enc,
                          cfg)
    return [[[d.doc_id, round(d.similarity_score, 4)] for d in ranked]
            for ranked in single.search_batch(QUERIES, top_k=5)]


def test_demo_matches_the_reference_demo():
    """The port's demo corpus, queries and config are the reference's."""
    from modern_search_engines_project_tpu.parallel import multihost as ref
    from modern_search_engines_project_tpu_torch.parallel import multihost

    assert multihost.QUERIES == ref.QUERIES
    assert [(d.doc_id, d.url, d.title, d.text)
            for d in multihost.demo_corpus(64)] == [
        (d.doc_id, d.url, d.title, d.text) for d in ref.demo_corpus(64)]


@pytest.mark.parametrize("hierarchical", [False, True],
                         ids=["flat", "hierarchical"])
def test_two_processes_match_the_oracle(oracle, hierarchical):
    outs = _run_cluster(2, 4, hierarchical=hierarchical)
    assert [o["process_count"] for o in outs] == [2, 2]
    assert outs[0]["global_devices"] == 8 and outs[0]["local_devices"] == 4
    assert outs[0]["backend"] == "gloo" and outs[0]["device"] == "cpu"
    assert outs[0]["hierarchical"] is hierarchical
    assert outs[0]["rank_ms_per_batch"] > 0
    assert outs[0]["collective_ms_per_batch"] > 0
    assert outs[1]["results"] == outs[0]["results"]
    for want, got in zip(oracle, outs[0]["results"]):
        assert len(got) == len(want) > 0
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   atol=2e-4, rtol=0)
        for (wd, ws), (gd, gs) in zip(want, got):
            assert wd == gd or abs(ws - gs) < 2e-4
