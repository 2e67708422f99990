"""The search kind plans, streams and judges exactly what the harness did
before kinds existed.

The digests and numbers below were taken from the functions of the
commit that held the search code in ``benchmark/run.py`` and
``benchmark/loadgen.py`` (``run.warm_batches``, ``run.window_plan``, the
load generator's ``QueryStream`` draws and ``run.judge``), over
``tiny.py``'s cells at ``SEED`` on the CPU with one torch thread; that
load generator posted every request to ``/api/search``, which the header
now names."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark import corpus as corpus_mod, reference, weights
from benchmark.corpus import DOC_ID_BASE
from benchmark.kinds import search
from benchmark.tests import tiny

SEED = 3_000_000_021
SECONDS = 10.0
N_STREAM = 1024
N_JUDGED = 8

PARENT = {
    "data-open": {
        "warm": "f54d98ef9b786e081c38d9bf28bc4003bad4ca7604c86585686e41141bf59240",
        "header": "0a7515f48e9cb06a1ead4444df2d6d7609fc41927410ff325b9da7db20f6afcb",
        "bodies": "6b10ab27239a465a5e5ffbb9bb239dbdd432a30bf0a773a8dde98795d8d773e8",
        "numbers": {"doc_gap": 0.2794367141599648, "miss_gap": 0.6951090296346687},
    },
    "data-closed": {
        "warm": "f54d98ef9b786e081c38d9bf28bc4003bad4ca7604c86585686e41141bf59240",
        "header": "baffcb9944467ef78dddf504c399484efc5786f36767d53731eded00c085a975",
        "bodies": "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
        "stream": "bac77a50120d7402385b3be28f6717bb762b7a41622ff96d0e841851ddbfa728",
        "numbers": {"doc_gap": 0.43681184710333687, "miss_gap": 0.7235068363529591},
    },
    "control-open": {
        "warm": "f54d98ef9b786e081c38d9bf28bc4003bad4ca7604c86585686e41141bf59240",
        "header": "0a7515f48e9cb06a1ead4444df2d6d7609fc41927410ff325b9da7db20f6afcb",
        "bodies": "6b10ab27239a465a5e5ffbb9bb239dbdd432a30bf0a773a8dde98795d8d773e8",
        "numbers": {"ce_gap": 0.2630460262298584, "stage2_gap": 0.48319334084543586},
    },
    "control-closed": {
        "warm": "f54d98ef9b786e081c38d9bf28bc4003bad4ca7604c86585686e41141bf59240",
        "header": "baffcb9944467ef78dddf504c399484efc5786f36767d53731eded00c085a975",
        "bodies": "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
        "stream": "bac77a50120d7402385b3be28f6717bb762b7a41622ff96d0e841851ddbfa728",
        "numbers": {"ce_gap": 0.27899864315986633, "stage2_gap": 0.40440397383083343},
    },
}


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def replies(cell, corp, seed, requests):
    """Reply bodies as the API writes them, of the reference's answer
    (rescored by its cross-encoder where the configuration has one) with
    a fixed change in most: the first score raised, two rows swapped, the
    last row's window moved to the next of its document's, and without
    stage 3 one answer left out."""
    cfg = cell["config"]
    ref = reference.Reference(corp, cfg["engine"])
    enc, ce_cfg = cfg["encoder"], cfg.get("cross_encoder")
    qs = [json.loads(r)["query"] for r in requests]
    qvec = reference.embed(weights.draw_tree(seed, enc, False, "cpu"), enc,
                           reference.HashTokens(enc["vocab_size"]),
                           [reference.processed(q) for q in qs], "cpu")
    out = []
    for i, (q, v) in enumerate(zip(qs, qvec)):
        st = ref.stage2(q, v)
        rows = list(zip(st.docs.tolist(), st.wins.tolist(), st.scores.tolist()))
        if ce_cfg:
            ce = reference.cross_scores(
                weights.draw_tree(seed, ce_cfg, True, "cpu"), ce_cfg,
                reference.HashTokens(ce_cfg["vocab_size"]), q,
                [corp.window_texts[w] for _, w, _ in rows], "cpu")
            rows = [(rows[j][0], rows[j][1], float(ce[j]))
                    for j in np.argsort(-ce, kind="stable")]
        if i % 4 == 1:
            rows[0] = (rows[0][0], rows[0][1], rows[0][2] + 0.004)
        elif i % 4 == 2 and len(rows) > 2:
            rows[1], rows[2] = rows[2], rows[1]
        elif i % 4 == 3:
            d, w, s = rows[-1]
            a, n = int(corp.doc_chunk_start[d]), int(corp.doc_n_chunks[d])
            rows[-1] = (d, a + (w - a + 1) % n, s)
        elif i == 4 and not ce_cfg:
            rows = rows[:-1]
        out.append(json.dumps({"documents": [
            {"doc_id": DOC_ID_BASE + d, "snippet": f"w{w} text", "score": s}
            for d, w, s in rows]}))
    return out


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("plane", ["data", "control"])
@pytest.mark.parametrize("loop", ["open", "closed"])
def test_search_kind_is_the_parents(plane, loop, one_thread):
    cell = tiny.cell(plane, loop)
    corp = corpus_mod.make_corpus(SEED, cell["config"]["corpus"], "cpu")
    corp.freeze()
    warm = search.warm_batches(SEED, corp, cell["traffic"])
    state = search.State(corp, warm)
    plan = search.plan(cell, SEED, SECONDS, state)
    header, bodies = plan["header"], plan["bodies"]
    assert header["path"] == "/api/search"
    got = {"warm": digest(warm), "header": digest(header),
           "bodies": digest(bodies)}
    if loop == "open":
        requests = [bodies[k] for k in header["keep"][:N_JUDGED]]
    else:
        next_body = search.stream(header["draw"])
        drawn = [next_body() for _ in range(N_STREAM)]
        got["stream"] = digest(drawn)
        requests = drawn[:N_JUDGED]
    numbers, counts = search.judge(
        cell, SEED, state, list(zip(requests, replies(cell, corp, SEED, requests))),
        "cpu")
    assert counts == {"bank_dtype_off": 0}
    got["numbers"] = numbers
    assert got == PARENT[f"{plane}-{loop}"]
