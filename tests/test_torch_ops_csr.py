"""The port's CSR scatter path against the reference's, on the CPU.

``ops.bm25_score_batch`` (rarest-first terms, the ``posting_cap`` gather
budget, one scatter of (score, match count)), ``exact_topk`` below and
above its 131,072-column split, ``hybrid_rank`` and ``bm25_topk`` on the
same CSR arrays, and the engine with ``use_pallas=False`` against the
reference engine with ``use_pallas=False`` (the reference's default path
off the TPU).

Tolerances: both sides add the same f32 products a doc, in scatter order
(which the port's ``index_add_`` does not promise), so keyed scores agree
to 1e-5 and the matched set exactly; top-k values and ids are equal
(integer-valued scores make ties, broken alike); the engines' fused
scores agree to 1e-5 with equal doc ids, windows and validity.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from corpus_util import make_corpus
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.models import HashingEncoder as RefEncoder
from modern_search_engines_project_tpu.retrieval import SearchEngine as RefEngine
from modern_search_engines_project_tpu.retrieval import ops as ref_ops
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import IndexBuilder
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.retrieval import SearchEngine, ops
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    DeviceIndex,
)

ATOL = 1e-5
CFG = dict(embedding_dim=32, window_size=32, step_size=25, top_k_retrieval=40,
           top_k_reranking=10, max_query_terms=8)
QUERIES = ["research square law", "ai faculty cyber",
           "tübingen research faculty", "castle river neckar museum"]


@pytest.fixture(scope="module")
def built():
    docs = make_corpus(n_docs=100, seed=11, min_len=30, max_len=150)
    art = IndexBuilder(HashingEncoder(dim=32), Config(**CFG)).build(docs)
    ref_art = RefBuilder(RefEncoder(dim=32), RefConfig(**CFG)).build(docs)
    eng = SearchEngine(art, HashingEncoder(dim=32), Config(**CFG),
                       device="cpu", use_pallas=False)
    ref = RefEngine(ref_art, RefEncoder(dim=32), RefConfig(**CFG),
                    use_pallas=False)
    return eng, ref


def _queries(rng, B, T, n_terms):
    tids = rng.integers(0, n_terms, (B, T)).astype(np.int32)
    tids[rng.random((B, T)) < 0.3] = -1
    qtf = np.where(tids >= 0, rng.integers(1, 4, (B, T)), 0).astype(np.float32)
    return tids, qtf


def _score_both(csr, tids, qtf, n_docs_pad, cap):
    indptr, docs, imp = csr
    got = ops.bm25_score_batch(
        torch.from_numpy(indptr), torch.from_numpy(docs),
        torch.from_numpy(imp), torch.from_numpy(tids), torch.from_numpy(qtf),
        n_docs_pad=n_docs_pad, posting_cap=cap).numpy()
    want = np.asarray(ref_ops.bm25_score_batch(
        jnp.asarray(indptr), jnp.asarray(docs), jnp.asarray(imp),
        jnp.asarray(tids), jnp.asarray(qtf), n_docs_pad=n_docs_pad,
        posting_cap=cap))
    return got, want


def test_csr_fields_equal_the_reference(built):
    eng, ref = built
    d, r = eng.didx, ref.didx
    assert d.posting_cap == r.posting_cap and d.n_docs_pad == r.n_docs_pad
    for name in ("indptr", "post_docs", "post_impact", "chunk_emb",
                 "chunk_doc", "doc_chunk_start", "doc_n_chunks"):
        np.testing.assert_array_equal(getattr(d, name).numpy(),
                                      np.asarray(getattr(r, name)), name)
    # the kernel path keeps its resident bytes: no CSR, no packed bank
    kernel = DeviceIndex.from_artifacts(eng.art, eng.cfg, device="cpu")
    assert kernel.indptr is None and kernel.chunk_emb is None
    assert kernel.posting_cap == 0
    assert eng.didx.resident_bytes() > kernel.resident_bytes()


@pytest.mark.parametrize("B,T", [(1, 4), (16, 8), (5, 16)])
def test_bm25_score_batch_matches_reference(built, B, T):
    eng, _ = built
    d = eng.didx
    csr = tuple(x.numpy() for x in (d.indptr, d.post_docs, d.post_impact))
    tids, qtf = _queries(np.random.default_rng(B * 100 + T), B, T,
                         d.n_terms)
    got, want = _score_both(csr, tids, qtf, d.n_docs_pad, d.posting_cap)
    assert got.shape == (B, d.n_docs_pad + 1)
    np.testing.assert_array_equal(got < 0, want < 0)
    assert (want >= 0).any()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _synthetic_csr(seed, n_docs=300, n_terms=40, nnz=3000):
    """CSR postings whose impacts include exact zeros (an idf-0 term) and
    negatives, so matched docs score exactly 0 or below."""
    rng = np.random.default_rng(seed)
    term = np.sort(rng.integers(0, n_terms, nnz))
    docs = rng.integers(0, n_docs, nnz).astype(np.int32)
    imp = rng.gamma(2.0, 1.0, nnz).astype(np.float32)
    imp[term == 3] = 0.0  # idf 0: matched, score 0, admissible
    imp[term == 5] *= -1.0  # negative idf: matched, below 0 -> -1
    indptr = np.zeros(n_terms + 1, np.int32)
    np.cumsum(np.bincount(term, minlength=n_terms), out=indptr[1:])
    return indptr, docs, imp


def test_idf_zero_matches_stay_admissible():
    csr = _synthetic_csr(0)
    tids = np.array([[3, -1, -1, -1], [5, -1, -1, -1], [3, 5, 7, -1]],
                    np.int32)
    qtf = np.where(tids >= 0, 1.0, 0.0).astype(np.float32)
    got, want = _score_both(csr, tids, qtf, 384, 1024)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got < 0, want < 0)
    assert (got[0, :384] == 0.0).any()  # matched at exactly 0: kept
    assert (got[1, :384] == -1.0).all()  # only negative scores: none kept


@pytest.mark.parametrize("cap", [16, 100, 1024])
def test_posting_cap_cuts_the_commonest_terms(cap):
    csr = _synthetic_csr(1)
    tids, qtf = _queries(np.random.default_rng(cap), 6, 8, 40)
    got, want = _score_both(csr, tids, qtf, 384, cap)
    np.testing.assert_array_equal(got < 0, want < 0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("N,k", [(1000, 50), (140_000, 100), (140_000, 9000)])
def test_exact_topk_matches_reference(N, k):
    rng = np.random.default_rng(N + k)
    scores = rng.integers(0, 200, (2, N)).astype(np.float32)  # many ties
    v, i = ops.exact_topk(torch.from_numpy(scores), k)
    rv, ri = ref_ops.exact_topk(jnp.asarray(scores), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert i.dtype == torch.int32


def test_hybrid_rank_and_bm25_topk_match_reference(built):
    eng, ref = built
    tids, qtf, processed = eng.prepare_queries(QUERIES)
    qvec = eng.encode_queries(processed)
    d, r = eng.didx, ref.didx
    got = ops.hybrid_rank(
        d.indptr, d.post_docs, d.post_impact, d.chunk_emb, d.chunk_doc,
        d.doc_chunk_start, d.doc_n_chunks, torch.from_numpy(tids),
        torch.from_numpy(qtf), torch.from_numpy(qvec),
        n_docs_pad=d.n_docs_pad, posting_cap=d.posting_cap, k_ret=eng.k_ret,
        smoothing=eng.cfg.smoothing)
    want = ref_ops.hybrid_rank(
        r.indptr, r.post_docs, r.post_impact, r.chunk_emb, r.chunk_doc,
        r.doc_chunk_start, r.doc_n_chunks, jnp.asarray(tids),
        jnp.asarray(qtf), jnp.asarray(qvec), n_docs_pad=r.n_docs_pad,
        posting_cap=r.posting_cap, k_ret=ref.k_ret, smoothing=ref.cfg.smoothing)
    _same_raw([x.numpy() for x in got], [np.asarray(x) for x in want])
    idx, vals = ops.bm25_topk(d, torch.from_numpy(tids),
                              torch.from_numpy(qtf), 30)
    ridx, rvals = ref_ops.bm25_topk(r, jnp.asarray(tids), jnp.asarray(qtf), 30)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rvals), atol=ATOL,
                               rtol=0)


def _same_raw(got, want):
    doc, vals, old, win, valid = got
    rdoc, rvals, rold, rwin, rvalid = want
    assert valid.any()
    np.testing.assert_array_equal(valid, rvalid)
    np.testing.assert_array_equal(doc, rdoc)
    np.testing.assert_array_equal(win[valid], rwin[rvalid])
    np.testing.assert_allclose(vals, rvals, atol=ATOL, rtol=0)
    np.testing.assert_allclose(old, rold, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 4, 16])
def test_engine_scatter_path_matches_reference(built, n):
    eng, ref = built
    qs = (QUERIES * 4)[:n]
    _same_raw(list(eng.rank_batch(qs)), list(ref.rank_batch(qs)))
    got, want = eng.search_batch(qs, top_k=10), ref.search_batch(qs, top_k=10)
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert [x.doc_id for x in g] == [x.doc_id for x in w]
        assert [x.window_index for x in g] == [x.window_index for x in w]
        np.testing.assert_allclose([x.similarity_score for x in g],
                                   [x.similarity_score for x in w],
                                   atol=ATOL, rtol=0)


def test_engine_scatter_bm25_and_dense_search(built):
    eng, ref = built
    n_bm25 = 0
    for q in QUERIES:
        got, want = eng.bm25_search(q, top_k=30), ref.bm25_search(q, top_k=30)
        n_bm25 += len(want)
        assert [g["doc_id"] for g in got] == [w["doc_id"] for w in want]
        np.testing.assert_allclose([g["score"] for g in got],
                                   [w["score"] for w in want], atol=ATOL,
                                   rtol=0)
        got, want = eng.dense_search(q, top_k=10), ref.dense_search(q, top_k=10)
        assert want and [g.doc_id for g in got] == [w.doc_id for w in want]
        assert [g.window_index for g in got] == [w.window_index for w in want]
        np.testing.assert_allclose([g.similarity_score for g in got],
                                   [w.similarity_score for w in want],
                                   atol=ATOL, rtol=0)
    assert n_bm25 > 0


def test_scatter_engine_serves_an_empty_index():
    cfg = Config(**CFG)
    eng = SearchEngine(IndexBuilder(HashingEncoder(dim=32), cfg).build([]),
                       HashingEncoder(dim=32), cfg, device="cpu",
                       use_pallas=False)
    assert eng.search("castle") == []
    assert eng.bm25_search("castle") == [] and eng.dense_search("castle") == []
