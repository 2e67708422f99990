"""The torch port's SearchEngine with ``bm25_layout="blocked"`` (on the CPU,
plain kernel versions) against the reference SearchEngine on its Pallas
path (interpret mode) and against the numpy oracle; plus the entry points
that run one stage (``bm25_search``, ``dense_search``), ``warmup``, the
empty and dense-only indexes, and ``approx_candidates=True``.

Both blocked dispatch branches are driven: one query (kernel 7) and 64
queries sharing few terms at t_eff = 8, where 4 * u_pad <= B * T (kernel
8).  The reference's blocked kernels sum in compensated bf16x2 (~2^-16
relative per posting), the port in exact f32, so scores agree to 1e-4 and
doc ids agree except where neighbouring fused scores lie within 1e-4.
"""

import numpy as np
import pytest

from corpus_util import make_corpus
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.models import HashingEncoder as RefEncoder
from modern_search_engines_project_tpu.retrieval import SearchEngine as RefEngine
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import Document, IndexBuilder
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.retrieval import (
    SearchEngine,
    hybrid_search_numpy,
    preprocess_query,
)
from modern_search_engines_project_tpu_torch.retrieval import ops
from modern_search_engines_project_tpu_torch.retrieval.bm25_blocked import (
    blocked_udedup_gate,
)
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import u_pad_for

CFG = dict(embedding_dim=64, window_size=64, step_size=50, top_k_retrieval=50,
           top_k_reranking=10, max_query_terms=8)
QUERIES = [
    "research square law",
    "ai faculty cyber",
    "neuro tour square",
    "castleaq gardenaq universityaq",
    "tübingen research faculty",
]
# seven known words (+ the tuebingen anchor): the term axis buckets to 8
LONG = "research faculty cyber neuro tour square law"
BATCHES = {
    "blocked": QUERIES[:1],
    "blocked_udedup": ([LONG] + QUERIES * 13)[:64],
}
TOL = 1e-4


def _cfg(**kw):
    return Config(**CFG).replace(**kw)


def _ref_cfg(**kw):
    return RefConfig(**CFG).replace(**kw)


@pytest.fixture(scope="module")
def built():
    docs = make_corpus(n_docs=80, seed=42)
    enc = HashingEncoder(dim=64)
    art = IndexBuilder(enc, Config(**CFG)).build(docs)
    ref_art = RefBuilder(RefEncoder(dim=64), RefConfig(**CFG)).build(docs)
    eng = SearchEngine(art, enc, _cfg(bm25_layout="blocked"), device="cpu")
    ref = RefEngine(ref_art, RefEncoder(dim=64), _ref_cfg(bm25_layout="blocked"),
                    use_pallas=True)
    return art, ref_art, eng, ref


@pytest.fixture(scope="module")
def ref_raw(built):
    _, _, _, ref = built
    return {name: ref.rank_batch(qs) for name, qs in BATCHES.items()}


def _near_tie(vals, valid, i, atol=TOL):
    return any(
        abs(vals[j] - vals[i]) <= atol
        for j in (i - 1, i + 1)
        if 0 <= j < len(vals) and valid[j]
    )


def _same_raw(got, want):
    doc, vals, old, win, valid = got
    rdoc, rvals, rold, rwin, rvalid = want
    assert valid.any()
    np.testing.assert_array_equal(valid, rvalid)
    np.testing.assert_allclose(vals[valid], rvals[rvalid], atol=TOL, rtol=0)
    np.testing.assert_allclose(old[valid], rold[rvalid], atol=TOL, rtol=0)
    for b in range(doc.shape[0]):
        for i in np.nonzero(valid[b])[0]:
            if doc[b, i] == rdoc[b, i]:
                assert win[b, i] == rwin[b, i], (b, i)
            else:
                assert _near_tie(rvals[b], rvalid[b], i), (b, i)


def _same_ranked(got, want, atol=TOL):
    assert len(got) == len(want)
    gs = [g.similarity_score for g in got]
    ws = [w.similarity_score for w in want]
    np.testing.assert_allclose(gs, ws, atol=atol, rtol=0)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.doc_id == w.doc_id:
            assert g.window_index == w.window_index
        else:
            assert _near_tie(ws, [True] * len(ws), i, atol), i


@pytest.mark.parametrize("branch", sorted(BATCHES))
def test_dispatch_branch(built, branch, monkeypatch):
    """B = 1 takes kernel 7; the shared-term 64-query batch passes the
    reference's gate and takes kernel 8."""
    _, _, eng, _ = built
    qs = BATCHES[branch]
    tids, _, _ = eng.prepare_queries(qs + [""] * (eng._bucket(len(qs)) - len(qs)))
    B, T = tids.shape
    u = u_pad_for(int(np.unique(tids[tids >= 0]).size))
    assert blocked_udedup_gate(u, B, T) == (branch == "blocked_udedup")
    called = []
    for name in ("hybrid_rank_buckets", "hybrid_rank_buckets_udedup",
                 "hybrid_rank_slots", "hybrid_rank_slots_udedup",
                 "hybrid_rank_blocked"):
        fn = getattr(ops, name)
        monkeypatch.setattr(
            ops, name,
            lambda *a, _fn=fn, _n=name, **k: called.append(_n) or _fn(*a, **k),
        )
    eng.rank_batch(qs)
    want = ("hybrid_rank_buckets_udedup" if branch == "blocked_udedup"
            else "hybrid_rank_buckets")
    assert called == [want]


@pytest.mark.parametrize("branch", sorted(BATCHES))
def test_rank_batch_matches_reference(built, ref_raw, branch):
    _, _, eng, _ = built
    _same_raw(eng.rank_batch(BATCHES[branch]), ref_raw[branch])


@pytest.mark.parametrize("branch", sorted(BATCHES))
def test_search_batch_matches_reference(built, ref_raw, branch):
    _, _, eng, ref = built
    qs = BATCHES[branch]
    got = eng.search_batch(qs, top_k=10)
    want = ref.finish_batch(ref_raw[branch], qs, 10)
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        _same_ranked(g, w)


@pytest.mark.parametrize("q", QUERIES)
def test_matches_numpy_oracle(built, q):
    art, _, eng, _ = built
    pq = preprocess_query(q)
    want = hybrid_search_numpy(
        art, pq, HashingEncoder(dim=64).encode(pq), CFG["top_k_retrieval"],
        CFG["top_k_reranking"], diversification=True,
    )
    got = eng.search(q, top_k=CFG["top_k_reranking"])
    assert len(want) > 0
    _same_ranked(got, want, atol=2e-4)


def test_blocked_and_slots_rank_identically(built):
    """The two resident layouts (each building only its own) give the same
    ranking: exact f32 BM25 in both, in the same per-doc order."""
    art, _, eng_b, _ = built
    eng_s = SearchEngine(art, HashingEncoder(dim=64), _cfg(), device="cpu")
    assert eng_s.didx.blocked is None and eng_b.didx.slot_stream is None
    assert eng_b.didx.bm25_layout == "blocked"
    for qs in BATCHES.values():
        for g, w in zip(eng_b.search_batch(qs, top_k=10),
                        eng_s.search_batch(qs, top_k=10)):
            assert len(g) == len(w) > 0
            _same_ranked(g, w, atol=1e-5)


@pytest.mark.parametrize("layout", ["slots", "blocked"])
def test_bm25_search_matches_reference(built, layout):
    art, ref_art, _, _ = built
    eng = SearchEngine(art, HashingEncoder(dim=64), _cfg(bm25_layout=layout),
                       device="cpu")
    ref = RefEngine(ref_art, RefEncoder(dim=64), _ref_cfg(bm25_layout=layout),
                    use_pallas=True)
    for q in QUERIES[:3]:
        got, want = eng.bm25_search(q, top_k=20), ref.bm25_search(q, top_k=20)
        assert len(got) == len(want) > 0
        ws = [w["score"] for w in want]
        np.testing.assert_allclose([g["score"] for g in got], ws, atol=TOL)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g["doc_id"] == w["doc_id"] or _near_tie(
                ws, [True] * len(ws), i
            )
            if g["doc_id"] == w["doc_id"]:
                assert g["text_snippet"] == w["text_snippet"]


@pytest.mark.parametrize("layout", ["slots", "blocked"])
def test_dense_search_matches_reference(built, layout):
    art, ref_art, _, _ = built
    eng = SearchEngine(art, HashingEncoder(dim=64), _cfg(bm25_layout=layout),
                       device="cpu")
    ref = RefEngine(ref_art, RefEncoder(dim=64), _ref_cfg(bm25_layout=layout),
                    use_pallas=True)
    for q in QUERIES[:3]:
        got, want = eng.dense_search(q, top_k=10), ref.dense_search(q, top_k=10)
        assert len(want) == 10
        assert [g.doc_id for g in got] == [w.doc_id for w in want]
        assert [g.window_index for g in got] == [w.window_index for w in want]
        np.testing.assert_allclose(
            [g.similarity_score for g in got],
            [w.similarity_score for w in want], atol=1e-5,
        )


EDGE = dict(embedding_dim=32, window_size=16, step_size=12,
            top_k_retrieval=10, top_k_reranking=5, max_query_terms=8)


@pytest.mark.parametrize("layout", ["slots", "blocked"])
def test_empty_index(layout):
    """An empty corpus has no chunk buckets: the index is blocked whatever
    the configured layout, kernel 7 runs over one row of pads and every
    entry point returns [] (as the reference does)."""
    cfg = Config(**EDGE).replace(bm25_layout=layout)
    enc = HashingEncoder(dim=32)
    eng = SearchEngine(IndexBuilder(enc, cfg).build([]), enc, cfg, device="cpu")
    d = eng.didx
    assert d.bm25_layout == "blocked" and not d.buckets and d.doc_perm is None
    assert d.chunk_emb.shape == (128, 32) and d.blocked.n_blocks == 1
    assert eng.search("castle", top_k=5) == []
    assert eng.search_batch(["castle", "river"], top_k=5) == [[], []]
    assert eng.bm25_search("castle") == []
    assert eng.dense_search("castle", top_k=5) == []
    ref_cfg = RefConfig(**EDGE).replace(bm25_layout=layout)
    renc = RefEncoder(dim=32)
    ref = RefEngine(RefBuilder(renc, ref_cfg).build([]), renc, ref_cfg,
                    use_pallas=True)
    assert ref.search("castle", top_k=5) == []


@pytest.mark.parametrize("layout", ["slots", "blocked"])
def test_dense_only_index(layout):
    """use_bm25=False: no postings; stage 1 admits nothing, dense search
    still ranks (tests/test_edge_cases.py TestUseBm25Flag)."""
    cfg = Config(**EDGE).replace(use_bm25=False, bm25_layout=layout)
    docs = [
        Document(1, "https://a.de/x", "t", "castle river neckar hills"),
        Document(2, "https://a.de/y", "t", "pizza dough flour salt"),
    ]
    enc = HashingEncoder(dim=32)
    eng = SearchEngine(IndexBuilder(enc, cfg).build(docs), enc, cfg,
                       device="cpu")
    assert eng.art.n_terms == 0 and eng.didx.bm25_layout == layout
    assert eng.bm25_search("castle") == []
    assert eng.search("castle", top_k=5) == []
    dense = eng.dense_search("castle river", top_k=2)
    assert dense and dense[0].doc_id == 1


@pytest.mark.parametrize("layout", ["slots", "blocked"])
def test_approx_candidates_match_reference(built, layout):
    """approx_candidates=True: the reference's lax.approx_max_k is exact
    top-k off the TPU, and the port runs the exact selection; both equal
    the exact engines."""
    art, ref_art, _, _ = built
    qs = BATCHES["blocked_udedup"][:16]
    eng = SearchEngine(art, HashingEncoder(dim=64),
                       _cfg(bm25_layout=layout, approx_candidates=True),
                       device="cpu")
    assert eng._approx
    ref = RefEngine(ref_art, RefEncoder(dim=64),
                    _ref_cfg(bm25_layout=layout, approx_candidates=True),
                    use_pallas=True)
    assert ref._approx
    got = eng.rank_batch(qs)
    _same_raw(got, ref.rank_batch(qs))
    exact = SearchEngine(art, HashingEncoder(dim=64), _cfg(bm25_layout=layout),
                         device="cpu").rank_batch(qs)
    for a, b in zip(got, exact):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["slots", "blocked"])
def test_warmup_matches_reference_call_count(built, layout):
    art, ref_art, _, _ = built
    eng = SearchEngine(art, HashingEncoder(dim=64), _cfg(bm25_layout=layout),
                       device="cpu")
    ref = RefEngine(ref_art, RefEncoder(dim=64), _ref_cfg(bm25_layout=layout),
                    use_pallas=True)
    for sizes in ((1,), (1, 4)):
        assert eng.warmup(sizes) == ref.warmup(sizes)
    assert eng.warmup((1, 64)) == 4  # 400 words < 64 * 8: no distinct batch

