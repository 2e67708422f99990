"""The int8 dense bank of the torch port (``bank_dtype="int8"``) against the
reference's, on the CPU.

The quantizer equals the reference's bit for bit (zero rows included); the
s8 x s8 -> s32 sims and the streaming top-2 equal the reference's
``_bucket_sims`` pair branch and ``bucket_doc_stats``; end to end, the port
engine with ``bank_dtype="int8"`` returns the JAX engine's doc ids and
windows (``bank_dtype="int8", use_pallas=True``, Pallas in interpret mode)
with scores to 1e-5, on every BM25 dispatch branch and in ``dense_search``.
"""

import numpy as np
import pytest
import torch

from corpus_util import make_corpus, make_vocab
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.models import HashingEncoder as RefEncoder
from modern_search_engines_project_tpu.retrieval import SearchEngine as RefEngine
from modern_search_engines_project_tpu.retrieval import ops as ref_ops
from modern_search_engines_project_tpu.retrieval.device_index import (
    quantize_bank_int8 as ref_quantize,
)
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import IndexBuilder
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.retrieval import SearchEngine, ops
from modern_search_engines_project_tpu_torch.retrieval import cuda_lib
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    quantize_bank_int8,
)

CFG = dict(embedding_dim=48, window_size=32, step_size=25, top_k_retrieval=60,
           top_k_reranking=10, max_query_terms=8)
QUERIES = [
    "research square law",
    "ai faculty cyber",
    "tübingen research faculty",
    "castle river town",
]
ATOL = 1e-5


def _wide_batch():
    rng = np.random.default_rng(0)
    vocab = make_vocab(400)[40:]
    return [" ".join(rng.choice(vocab, 6, replace=False)) for _ in range(40)]


BATCHES = {"plain": QUERIES[:1], "sublane": (QUERIES * 4)[:16],
           "i8": _wide_batch()}


@pytest.fixture(scope="module")
def built():
    docs = make_corpus(n_docs=120, seed=7, min_len=40, max_len=200)
    art = IndexBuilder(HashingEncoder(dim=48), Config(**CFG)).build(docs)
    eng = SearchEngine(art, HashingEncoder(dim=48), Config(**CFG),
                       bank_dtype="int8", device="cpu")
    ref_art = RefBuilder(RefEncoder(dim=48), RefConfig(**CFG)).build(docs)
    ref = RefEngine(ref_art, RefEncoder(dim=48), RefConfig(**CFG),
                    use_pallas=True, bank_dtype="int8")
    return art, eng, ref


@pytest.mark.parametrize("n,dim,zero_rows", [(64, 48, ()), (300, 768, (0, 7)),
                                             (5, 32, (0, 1, 2, 3, 4))])
def test_quantizer_bit_equal_to_reference(n, dim, zero_rows):
    rng = np.random.default_rng(n)
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[list(zero_rows)] = 0.0
    q8, inv = quantize_bank_int8(emb)
    r8, rinv = ref_quantize(emb)
    assert q8.dtype == np.int8 and inv.dtype == np.float32
    np.testing.assert_array_equal(q8, r8)
    np.testing.assert_array_equal(inv.view(np.int32), rinv.view(np.int32))
    assert np.all(q8[list(zero_rows)] == 0) and np.all(inv > 0)


def test_int8_bank_layout(built):
    _, eng, _ = built
    for (n, cnt), e in zip(eng.didx.buckets, eng.didx.bucket_emb):
        q8, inv = e
        assert q8.dtype == torch.int8 and q8.shape == (n, cnt, 48)
        assert inv.dtype == torch.float32 and inv.shape == (n, cnt)


@pytest.mark.parametrize("B,n", [(1, 1), (3, 4), (16, 10)])
def test_bucket_sims_and_stats_match_reference(B, n):
    """Sims of the pair branch equal the reference's (the s32 product is
    exact on both sides; the scales apply in the same order), and the
    streaming top-2 gives the same values and slots."""
    import jax.numpy as jnp

    rng = np.random.default_rng(B * 10 + n)
    cnt, dim = 128, 48
    emb = rng.standard_normal((n * cnt, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[3] = 0.0
    q8, inv = quantize_bank_int8(emb)
    q8, inv = q8.reshape(n, cnt, dim), inv.reshape(n, cnt)
    qv = rng.standard_normal((B, dim)).astype(np.float32)
    qv[0, :5] = 0.0
    pair = (torch.from_numpy(q8), torch.from_numpy(inv))
    got = ops.int8_bucket_sims(pair, torch.from_numpy(qv)).numpy()
    want = np.asarray(ref_ops._bucket_sims(
        jnp.asarray(qv), (jnp.asarray(q8), jnp.asarray(inv)), cnt, n))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the s32 product against numpy's int64 one
    qi, qm = ops.quantize_queries_int8(torch.from_numpy(qv))
    raw = np.einsum("bd,ncd->bnc", qi.numpy().astype(np.int64),
                    q8.astype(np.int64))
    np.testing.assert_allclose(
        got, raw.astype(np.float32) * (qm.numpy()[:, :, None] / 127.0)
        * inv[None], rtol=0, atol=0)
    stats = ops.bucket_doc_stats([(n, cnt)], [pair], torch.from_numpy(qv))[0]
    ref = ref_ops.bucket_doc_stats(
        [(n, cnt)], [(jnp.asarray(q8), jnp.asarray(inv))],
        [jnp.ones(cnt, bool)], jnp.asarray(qv), use_pallas=True,
        interpret=True)[0]
    for g, w in zip(stats, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("branch", sorted(BATCHES))
def test_search_batch_matches_reference_int8(built, branch):
    _, eng, ref = built
    qs = BATCHES[branch]
    before = [k.launches for k in cuda_lib.KERNELS]
    got = eng.search_batch(qs, top_k=10)
    assert [k.launches for k in cuda_lib.KERNELS] == before
    want = ref.search_batch(qs, top_k=10)
    assert sum(len(w) for w in want) > 0
    for g_list, w_list in zip(got, want):
        assert [g.doc_id for g in g_list] == [w.doc_id for w in w_list]
        assert [g.window_index for g in g_list] == [
            w.window_index for w in w_list]
        np.testing.assert_allclose(
            [g.similarity_score for g in g_list],
            [w.similarity_score for w in w_list], atol=ATOL, rtol=0,
        )


@pytest.mark.parametrize("q", QUERIES)
def test_dense_search_matches_reference_int8(built, q):
    _, eng, ref = built
    got = eng.dense_search(q, top_k=20)
    want = ref.dense_search(q, top_k=20)
    assert len(want) > 0
    assert [g.doc_id for g in got] == [w.doc_id for w in want]
    assert [g.window_index for g in got] == [w.window_index for w in want]
    np.testing.assert_allclose([g.similarity_score for g in got],
                               [w.similarity_score for w in want], atol=ATOL)


def test_int8_near_f32_rankings(built):
    """The int8 engine stays near the f32 one (the reference's own bar,
    tests/test_int8_bank.py): top-10 overlap >= 0.9, shared docs' scores
    within 0.05; its bucket banks take under a third of the f32 bytes."""
    art, eng, _ = built
    f32 = SearchEngine(art, HashingEncoder(dim=48), Config(**CFG),
                       device="cpu")
    for q in QUERIES:
        a, b = f32.search(q, top_k=10), eng.search(q, top_k=10)
        ids_a, ids_b = [r.doc_id for r in a], [r.doc_id for r in b]
        if not ids_a:
            assert not ids_b
            continue
        assert len(set(ids_a) & set(ids_b)) / len(ids_a) >= 0.9
        for ra, rb in zip(a, b):
            if ra.doc_id == rb.doc_id:
                assert abs(ra.similarity_score - rb.similarity_score) < 0.05

    def bank_bytes(e):
        return sum(t.numel() * t.element_size() for b in e.didx.bucket_emb
                   for t in (b if isinstance(b, tuple) else (b,)))

    assert bank_bytes(eng) * 3 < bank_bytes(f32)


def test_torch_int8_alias(built):
    art, eng, _ = built
    alias = SearchEngine(art, HashingEncoder(dim=48), Config(**CFG),
                         bank_dtype=torch.int8, device="cpu")
    for a, b in zip(alias.rank_batch(BATCHES["sublane"]),
                    eng.rank_batch(BATCHES["sublane"])):
        np.testing.assert_array_equal(a, b)
