"""The torch port's SearchEngine (on the CPU, plain kernel versions) against
the reference SearchEngine on its Pallas path (interpret mode) and against
the numpy oracle, on the fixtures of test_engine_parity.py.

Each BM25 dispatch branch is driven: one query (the per-query kernel), 16
queries (U-dedup "sublane") and 40 queries with more than 128 distinct
terms (U-dedup "i8").  Same doc ids, windows and validity; scores to 1e-5.
"""

import numpy as np
import pytest
import torch

from corpus_util import make_corpus, make_vocab
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.models import HashingEncoder as RefEncoder
from modern_search_engines_project_tpu.retrieval import SearchEngine as RefEngine
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import IndexBuilder
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.retrieval import (
    SearchEngine,
    hybrid_search_numpy,
    preprocess_query,
)
from modern_search_engines_project_tpu_torch.retrieval import cuda_lib
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    u_pad_for,
    udedup_plan,
)

CFG = dict(embedding_dim=64, window_size=64, step_size=50, top_k_retrieval=50,
           top_k_reranking=10, max_query_terms=8)
QUERIES = [
    "research square law",
    "ai faculty cyber",
    "neuro tour square",
    "castleaq gardenaq universityaq",
    "tübingen research faculty",
]
ATOL = 1e-5


def _wide_batch():
    """40 queries of 6 distinct mid-frequency words: > 128 distinct terms."""
    rng = np.random.default_rng(0)
    vocab = make_vocab(400)[40:]
    return [" ".join(rng.choice(vocab, 6, replace=False)) for _ in range(40)]


BATCHES = {
    "plain": QUERIES[:1],
    "sublane": (QUERIES * 4)[:16],
    "i8": _wide_batch(),
}


@pytest.fixture(scope="module")
def built():
    docs = make_corpus(n_docs=80, seed=42)
    art = IndexBuilder(HashingEncoder(dim=64), Config(**CFG)).build(docs)
    eng = SearchEngine(art, HashingEncoder(dim=64), Config(**CFG), device="cpu")
    ref_art = RefBuilder(RefEncoder(dim=64), RefConfig(**CFG)).build(docs)
    ref = RefEngine(ref_art, RefEncoder(dim=64), RefConfig(**CFG), use_pallas=True)
    return art, eng, ref


@pytest.fixture(scope="module")
def ref_raw(built):
    _, _, ref = built
    return {name: ref.rank_batch(qs) for name, qs in BATCHES.items()}


@pytest.mark.parametrize("branch", sorted(BATCHES))
def test_dispatch_branch(built, branch):
    _, eng, _ = built
    qs = BATCHES[branch]
    tids, _, _ = eng.prepare_queries(qs + [""] * (eng._bucket(len(qs)) - len(qs)))
    u = u_pad_for(int(np.unique(tids[tids >= 0]).size))
    assert udedup_plan(u, tids.shape[0]) == (None if branch == "plain" else branch)


@pytest.mark.parametrize("branch", sorted(BATCHES))
def test_rank_batch_matches_reference(built, ref_raw, branch):
    _, eng, _ = built
    doc, vals, old, win, valid = eng.rank_batch(BATCHES[branch])
    rdoc, rvals, rold, rwin, rvalid = ref_raw[branch]
    assert valid.any()
    np.testing.assert_array_equal(valid, rvalid)
    np.testing.assert_array_equal(doc, rdoc)
    np.testing.assert_array_equal(win[valid], rwin[rvalid])
    np.testing.assert_allclose(vals, rvals, atol=ATOL, rtol=0)
    np.testing.assert_allclose(old, rold, atol=ATOL, rtol=0)


@pytest.mark.parametrize("branch", sorted(BATCHES))
def test_search_batch_matches_reference(built, ref_raw, branch):
    _, eng, ref = built
    qs = BATCHES[branch]
    got = eng.search_batch(qs, top_k=10)
    want = ref.finish_batch(ref_raw[branch], qs, 10)
    assert sum(len(w) for w in want) > 0
    for g_list, w_list in zip(got, want):
        assert [g.doc_id for g in g_list] == [w.doc_id for w in w_list]
        assert [g.window_index for g in g_list] == [w.window_index for w in w_list]
        np.testing.assert_allclose(
            [g.similarity_score for g in g_list],
            [w.similarity_score for w in w_list], atol=ATOL, rtol=0,
        )


def test_search_batch_indices_matches_reference(built, ref_raw):
    _, eng, ref = built
    qs = BATCHES["sublane"]
    got = eng.search_batch_indices(qs, top_k=10)
    want = ref.search_batch_indices(qs, top_k=10)
    for g, w in zip(got, want):
        assert [x[0] for x in g] == [x[0] for x in w]
        np.testing.assert_allclose([x[1] for x in g], [x[1] for x in w], atol=ATOL)


@pytest.mark.parametrize("q", QUERIES)
def test_matches_numpy_oracle(built, q):
    art, eng, _ = built
    pq = preprocess_query(q)
    ref = hybrid_search_numpy(
        art, pq, HashingEncoder(dim=64).encode(pq), CFG["top_k_retrieval"],
        CFG["top_k_reranking"], diversification=True,
    )
    got = eng.search(q, top_k=CFG["top_k_reranking"])
    assert len(ref) > 0 and len(got) == len(ref)
    np.testing.assert_allclose(
        [g.similarity_score for g in got], [r.similarity_score for r in ref],
        atol=2e-4,
    )
    for g, r in zip(got, ref):
        assert g.doc_id == r.doc_id or abs(
            g.similarity_score - r.similarity_score
        ) < 1e-5


def test_window_selection_matches_numpy_oracle(built):
    art, _, _ = built
    eng = SearchEngine(art, HashingEncoder(dim=64),
                       Config(**CFG).replace(diversification=False), device="cpu")
    for q in QUERIES[:3]:
        pq = preprocess_query(q)
        ref = hybrid_search_numpy(
            art, pq, HashingEncoder(dim=64).encode(pq), CFG["top_k_retrieval"],
            CFG["top_k_reranking"], diversification=False,
        )
        for g, r in zip(eng.search(q, top_k=CFG["top_k_reranking"]), ref):
            if g.doc_id == r.doc_id:
                assert g.window_index == r.window_index


def test_oversized_batch_chunks_and_matches(built):
    """Batches beyond cfg.query_batch_size run as several chunks; the
    results equal the unchunked batch's."""
    art, eng, _ = built
    small = SearchEngine(art, HashingEncoder(dim=64),
                         Config(**CFG).replace(query_batch_size=4), device="cpu")
    queries = (QUERIES * 3)[:11]  # 11 > 4: 3 chunks, the last one ragged
    got = small.search_batch(queries, top_k=10)
    want = eng.search_batch(queries, top_k=10)
    assert len(got) == len(want) == 11
    for g_list, w_list in zip(got, want):
        gs = np.array([r.similarity_score for r in g_list])
        ws = np.array([r.similarity_score for r in w_list])
        assert np.allclose(gs, ws, atol=1e-4)
        for g, w, vg, vw in zip(g_list, w_list, gs, ws):
            assert g.doc_id == w.doc_id or abs(vg - vw) < 1e-4


def test_scores_sorted_and_edge_queries(built):
    _, eng, _ = built
    res = eng.search("research square", top_k=10)
    scores = [r.similarity_score for r in res]
    assert res and scores == sorted(scores, reverse=True)
    # augmentation appends tuebingen: docs containing it still match
    assert all(r.similarity_score >= 0 for r in eng.search("zzzzqqqq xxyyzz"))
    eng.search("", top_k=5)


def test_cpu_run_launches_no_kernel(built):
    _, eng, _ = built
    before = [k.launches for k in cuda_lib.KERNELS]
    eng.search_batch(BATCHES["sublane"], top_k=5)
    assert [k.launches for k in cuda_lib.KERNELS] == before
    assert len(cuda_lib.KERNELS) == 4


@pytest.mark.parametrize(
    "override,exc",
    [
        (dict(bm25_layout="blocked"), NotImplementedError),
        (dict(approx_candidates=True), NotImplementedError),
    ],
)
def test_unported_paths_raise(built, override, exc):
    art, _, _ = built
    eng = SearchEngine(art, HashingEncoder(dim=64),
                       Config(**CFG).replace(**override), device="cpu")
    with pytest.raises(exc):
        eng.search("research square")


def test_no_card_raises(built, monkeypatch):
    art, _, _ = built
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        SearchEngine(art, HashingEncoder(dim=64), Config(**CFG))
