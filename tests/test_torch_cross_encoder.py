"""The torch port's cross-encoder and the engine's stage 3 against the
reference package on the CPU.

Each case feeds the same inputs (made with numpy from fixed seeds, the
30-doc corpus of ``tests/test_models.py``, or the committed
``runs/cross-encoder-real`` checkpoint) through the reference's modules
and the port's.

Tolerances.  With ``dtype="float32"`` both sides run the same arithmetic
with no bf16 rounding: logits agree to 1e-5 of their scale (measured
1e-6), which holds the structure (joint framing, CLS row, the f32 head
with its biases and tanh GELU) exactly.  In bf16 each side rounds the
residual stream after arithmetic done in another order; logits agree to
2^-5 of their scale (measured 2^-6.6 at 2 layers, 64 wide).  Sigmoid
scores agree to 5e-3 (measured 2.2e-3 on random weights at 2 layers, 64
wide, and 2.5e-4 on ``cross-encoder-real``).  Stage 3 orders rows by
those scores, so two rows whose scores lie within 2 x 5e-3 of each other
may trade places; every other neighbour keeps its order.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus_util import make_corpus
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.models import HashingEncoder as RefHash
from modern_search_engines_project_tpu.models import cross_encoder as ref
from modern_search_engines_project_tpu.models.encoder import (
    EncoderConfig as RefEncoderConfig,
)
from modern_search_engines_project_tpu.retrieval import SearchEngine as RefEngine
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import IndexBuilder
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.models import cross_encoder as port
from modern_search_engines_project_tpu_torch.models import encoder as port_enc
from modern_search_engines_project_tpu_torch.models.decoder import DecoderConfig
from modern_search_engines_project_tpu_torch.retrieval import SearchEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL = os.path.join(ROOT, "runs", "cross-encoder-real")
LOGIT_RTOL = 2.0 ** -5
F32_RTOL = 1e-5
SCORE_ATOL = 5e-3
TINY = dict(vocab_size=1024, dim=64, n_layers=2, n_heads=4, mlp_ratio=2,
            max_len=32)  # tests/test_models.py's TINY

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU forwards here are many small ops: one intra-op
    thread keeps them from spinning against the suite's other workers
    (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(cfg, seed):
    rng = np.random.default_rng(seed)
    return port.init_cross_encoder_params(
        cfg, lambda s: rng.standard_normal(s, dtype=np.float32))


def _pair(cfg, seed, **kw):
    """(reference reranker, port reranker on the CPU) on one seeded tree."""
    tree = _tree(cfg, seed)
    rcfg = RefEncoderConfig(**dataclasses.asdict(cfg))
    return (ref.CrossEncoderReranker(rcfg, params=tree, **kw),
            port.CrossEncoderReranker(cfg, params=tree, device="cpu", **kw))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


# ---- the module ---------------------------------------------------------------


@pytest.mark.parametrize("dtype,rtol", [("float32", F32_RTOL),
                                        ("bfloat16", LOGIT_RTOL)])
def test_cross_encoder_matches_reference(dtype, rtol):
    cfg = port_enc.EncoderConfig(**TINY, dtype=dtype)
    tree = _tree(cfg, 0)
    rm = ref.CrossEncoder(RefEncoderConfig(**dataclasses.asdict(cfg)))
    pm = port.CrossEncoder(cfg)
    pm.load_state_dict(port.cross_encoder_params_from_reference(
        tree, "cpu", getattr(torch, dtype)))
    rng = np.random.default_rng(1)
    ids = rng.integers(5, cfg.vocab_size, (6, 32)).astype(np.int32)
    ids[:, 0] = 1
    lens = np.array([32, 3, 17, 1, 30, 9])
    mask = (np.arange(32)[None] < lens[:, None]).astype(np.int32)
    want = np.asarray(rm.apply({"params": tree}, ids, mask))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (6,)
    _close(got.numpy(), want, rtol)


def test_cross_encoder_full_width_seeded():
    """4 layers, 384 wide, 6 heads, 50,257 ids, L = 192
    (``runs/cross-encoder-real``'s shape), weights from a numpy seed."""
    cfg = port_enc.EncoderConfig(dim=384, n_layers=4, n_heads=6, max_len=192)
    tree = _tree(cfg, 2)
    rm = ref.CrossEncoder(RefEncoderConfig(**dataclasses.asdict(cfg)))
    pm = port.CrossEncoder(cfg)
    pm.load_state_dict(port.cross_encoder_params_from_reference(tree, "cpu"))
    rng = np.random.default_rng(3)
    ids = rng.integers(5, cfg.vocab_size, (3, 192)).astype(np.int32)
    ids[:, 0] = 1
    mask = (np.arange(192)[None] < np.array([192, 40, 7])[:, None]).astype(
        np.int32)
    want = np.asarray(rm.apply({"params": tree}, ids, mask))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    _close(got, want, LOGIT_RTOL)


def test_seeded_tree_has_the_reference_form():
    cfg = port_enc.EncoderConfig(**TINY)
    want = ref.CrossEncoder(RefEncoderConfig(**TINY)).init(
        jax.random.key(0), jnp.zeros((1, 32), jnp.int32),
        jnp.ones((1, 32), jnp.int32))["params"]
    got = _tree(cfg, 0)
    ref_leaves = {jax.tree_util.keystr(k): np.asarray(v)
                  for k, v in jax.tree_util.tree_leaves_with_path(want)}
    port_leaves = dict(port_enc._leaves_with_keys(got))
    assert sorted(ref_leaves) == sorted(port_leaves)
    for k, r in ref_leaves.items():
        p = port_leaves[k]
        assert p.dtype == r.dtype and p.shape == r.shape, k
        assert abs(p.std() - r.std()) <= 0.15 * max(r.std(), 1e-3), k


# ---- the reranker -------------------------------------------------------------

TEXTS = [
    "the castle on the hill", "pizza dough", "x", "",
    "tübingen castle tour with the neckar river and the old town hall " * 6,
    "research faculty of computer science", "boats race on the neckar",
]
LONG_QUERY = " ".join(f"q{i}" for i in range(40))  # longer than max_len


@pytest.mark.parametrize("query", ["castle tour", LONG_QUERY, ""])
def test_encode_pairs_matches_reference(query):
    r, p = _pair(port_enc.EncoderConfig(**TINY), 0, batch_size=4, max_len=32)
    assert p._encode_pairs(query, TEXTS) == r._encode_pairs(query, TEXTS)


@pytest.mark.parametrize("query,texts,bs", [
    ("castle tour", TEXTS, 3),  # ragged final chunk: 7 = 3 + 3 + 1
    ("castle tour", TEXTS[:4], 4),  # one full chunk, an empty window
    (LONG_QUERY, TEXTS, 4),  # the query alone overflows max_len
    ("castle tour", TEXTS[2:3], 32),
])
def test_rescore_matches_reference(query, texts, bs):
    r, p = _pair(port_enc.EncoderConfig(**TINY), 4, batch_size=bs, max_len=32)
    want = r.rescore(query, texts)
    got = p.rescore(query, texts)
    assert got.dtype == np.float32 and got.shape == (len(texts),)
    assert np.abs(got - want).max() <= SCORE_ATOL
    assert np.all((got > 0) & (got < 1))
    # rows are independent: chunking does not move a score
    whole = port.CrossEncoderReranker(p.cfg, params=_tree(p.cfg, 4),
                                      batch_size=64, max_len=32, device="cpu")
    np.testing.assert_allclose(whole.rescore(query, texts), got, atol=1e-6)


def test_rescore_empty_and_device():
    _, p = _pair(port_enc.EncoderConfig(**TINY), 0, batch_size=4, max_len=32)
    out = p.rescore("castle", [])
    assert out.dtype == np.float32 and out.shape == (0,)
    dev = p.rescore_device("castle", TEXTS)
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(), p.rescore("castle", TEXTS))


def test_reranker_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_enc.EncoderConfig(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.CrossEncoderReranker(cfg, params=_tree(cfg, 0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.CrossEncoderReranker.from_checkpoint(REAL)
    p = port.CrossEncoderReranker(cfg, seed=3, device="cpu")
    assert p.device.type == "cpu"
    assert p.max_len == 32 and p.batch_size == 32


def test_real_checkpoint_rescore_matches_reference():
    """``runs/cross-encoder-real``, read once by each package."""
    r = ref.CrossEncoderReranker.from_checkpoint(REAL)
    p = port.CrossEncoderReranker.from_checkpoint(REAL, device="cpu")
    assert dataclasses.asdict(p.cfg) == dataclasses.asdict(r.cfg)
    assert p.max_len == r.max_len == 192 and p.batch_size == r.batch_size
    windows = [
        "The University of Tübingen is one of the oldest universities in "
        "Germany, founded in 1477.",
        "Hohentübingen Castle overlooks the old town and the Neckar river.",
        "Punting on the Neckar is a popular summer activity in Tübingen.",
        "tax law seminar for students of the faculty of law", "",
    ]
    for q in ("tübingen castle", "punting race neckar"):
        want = r.rescore(q, windows)
        got = p.rescore(q, windows)
        assert np.abs(got - want).max() <= SCORE_ATOL, (got, want)


# ---- the engine's stage 3 ------------------------------------------------------

CFG = dict(embedding_dim=32, window_size=32, step_size=25, top_k_retrieval=16,
           top_k_reranking=5, max_query_terms=8)  # tests/test_models.py
QUERIES = ["research law faculty", "castle river tour", "tübingen university",
           "old town market", "chocolate", "zzzz unknown"]


@pytest.fixture(scope="module")
def engines():
    docs = make_corpus(30, seed=3, min_len=40, max_len=100)
    cfg = port_enc.EncoderConfig(**TINY)
    tree = _tree(cfg, 5)
    r_ce = ref.CrossEncoderReranker(RefEncoderConfig(**TINY), params=tree,
                                    batch_size=4, max_len=32)
    p_ce = port.CrossEncoderReranker(cfg, params=tree, batch_size=4,
                                     max_len=32, device="cpu")
    art = IndexBuilder(HashingEncoder(dim=32), Config(**CFG)).build(docs)
    r_art = RefBuilder(RefHash(dim=32), RefConfig(**CFG)).build(docs)
    eng = SearchEngine(art, HashingEncoder(dim=32), Config(**CFG),
                       device="cpu", cross_encoder=p_ce)
    plain = SearchEngine(art, HashingEncoder(dim=32), Config(**CFG),
                         device="cpu")
    r_eng = RefEngine(r_art, RefHash(dim=32), RefConfig(**CFG),
                      use_pallas=True, cross_encoder=r_ce)
    return eng, plain, r_eng


def _same_order(got, want):
    """Same docs; order equal except between neighbours whose scores lie
    within 2 x SCORE_ATOL."""
    assert sorted(g.doc_id for g in got) == sorted(w.doc_id for w in want)
    by_id = {w.doc_id: w for w in want}
    for i, g in enumerate(got):
        w = by_id[g.doc_id]
        assert abs(g.similarity_score - w.similarity_score) <= SCORE_ATOL
        assert g.original_similarity == pytest.approx(
            w.original_similarity, abs=1e-5)
        assert g.window_index == w.window_index
        if g.doc_id != want[i].doc_id:
            assert abs(w.similarity_score - want[i].similarity_score) <= (
                2 * SCORE_ATOL), (i, g.doc_id, want[i].doc_id)


def test_engine_stage3_matches_reference(engines):
    eng, plain, r_eng = engines
    got = eng.search_batch(QUERIES, top_k=5)
    want = r_eng.search_batch(QUERIES, top_k=5)
    before = plain.search_batch(QUERIES, top_k=5)
    assert any(got) and len(got) == len(want) == len(QUERIES)
    n_ordered = 0
    for g, w, b in zip(got, want, before):
        _same_order(g, w)
        scores = [x.similarity_score for x in g]
        assert scores == sorted(scores, reverse=True)
        assert all(0.0 <= s <= 1.0 for s in scores)
        # the stage-2 rows, rescored: the same docs, original_similarity
        # kept, similarity_score the sigmoid
        assert sorted(x.doc_id for x in g) == sorted(x.doc_id for x in b)
        orig = {x.doc_id: x.original_similarity for x in b}
        assert all(x.original_similarity == orig[x.doc_id] for x in g)
        n_ordered += sum(
            abs(w[i].similarity_score - w[i + 1].similarity_score)
            > 2 * SCORE_ATOL for i in range(len(w) - 1))
    assert n_ordered >= 5  # the order check held real gaps


def test_stage3_scores_are_the_rescore_of_the_windows(engines):
    eng, plain, _ = engines
    for q in QUERIES[:3]:
        rows = plain.search(q, top_k=5)
        ce = eng.cross_encoder.rescore(q, [r.window_text for r in rows])
        order = sorted(range(len(rows)), key=lambda i: -ce[i])  # stable
        got = eng.search(q, top_k=5)
        assert [r.doc_id for r in got] == [rows[i].doc_id for i in order]
        assert [r.similarity_score for r in got] == [float(ce[i])
                                                     for i in order]


def test_search_batch_indices_does_not_rescore(engines):
    eng, plain, r_eng = engines
    got = eng.search_batch_indices(QUERIES, top_k=5)
    assert got == plain.search_batch_indices(QUERIES, top_k=5)
    want = r_eng.search_batch_indices(QUERIES, top_k=5)
    for g, w in zip(got, want):
        assert [x[0] for x in g] == [x[0] for x in w]


# ---- chip_smoke.py's hard-coded full-width configurations ---------------------


def test_chip_smoke_configs_equal_the_checkpoints():
    """``chip_smoke.py`` reads nothing under ``runs/`` (it runs where
    ``runs/`` is absent): its two configurations are written out, and
    must stay those of the committed checkpoints."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    for cfg, name, cls in ((chip_smoke.CE_CFG, "cross-encoder-real",
                            port_enc.EncoderConfig),
                           (chip_smoke.DEC_CFG, "summarizer-real",
                            DecoderConfig)):
        with open(os.path.join(ROOT, "runs", name, "config.json")) as f:
            want = json.load(f)
        assert isinstance(cfg, cls)
        assert dataclasses.asdict(cfg) == want, name
