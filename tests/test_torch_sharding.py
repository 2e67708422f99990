"""The port's sharded backend against the reference's, on the CPU.

The reference runs its sharded program over the 8 virtual CPU devices of
``tests/conftest.py``; the port over a mesh of 8 CPU shards
(``make_mesh(8, device="cpu")``), both on the reference's fixtures (100
docs, 32-d, ``top_k_retrieval=40``).  Compared at the same mesh shape:

  * the ``ShardedDeviceIndex`` arrays, field by field;
  * ``rank`` (the port's kernel path on the plain versions against the
    reference's Pallas path in interpret mode, and the scatter stage 1 on
    both sides), including the U-dedup variants forced through
    ``udedup_plan``;
  * ``search``, ``search_batch``, ``bm25_search`` and ``dense_search`` at
    meshes 8, (2, 4), (4, 2) and (8, 1), the int8 bank, a skewed corpus;
  * the collectives a call (one gather a merge level, one extrema max,
    one or two combine maxes);
  * ``ShardedQueryEncoder`` and ``DataParallelEncoder`` against one
    encode.

Tolerances: equal doc ids, windows and validity; fused and BM25 scores to
1e-5 (the same f32 arithmetic in other summation orders); f32 query
embeddings to 1e-5.
"""

import numpy as np
import pytest
import torch

from corpus_util import make_corpus
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.models import HashingEncoder as RefEncoder
from modern_search_engines_project_tpu.parallel import make_mesh as ref_make_mesh
from modern_search_engines_project_tpu.parallel.sharding import (
    ShardedEngineBackend as RefBackend,
    make_mesh_2d as ref_make_mesh_2d,
)
from modern_search_engines_project_tpu.retrieval import SearchEngine as RefEngine
from modern_search_engines_project_tpu.retrieval import bm25_pallas as ref_pallas
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import (
    BuildPipeline,
    IndexBuilder,
)
from modern_search_engines_project_tpu_torch.index.pipeline import (
    DataParallelEncoder,
)
from modern_search_engines_project_tpu_torch.models import (
    EncoderConfig,
    HashingEncoder,
    TorchEncoder,
)
from modern_search_engines_project_tpu_torch.parallel import sharding
from modern_search_engines_project_tpu_torch.parallel.sharding import (
    Mesh,
    ShardedQueryEncoder,
    make_mesh,
    make_mesh_2d,
)
from modern_search_engines_project_tpu_torch.retrieval import SearchEngine

ATOL = 1e-5
CFG = dict(embedding_dim=32, window_size=32, step_size=25, top_k_retrieval=40,
           top_k_reranking=10, max_query_terms=8)
QUERIES = ["research square law", "ai faculty cyber",
           "tübingen research faculty"]
MESHES = {"8": None, "2x4": (2, 4), "4x2": (4, 2), "8x1": (8, 1)}


def _wide_batch():
    """40 queries of 6 distinct words: more than 128 distinct terms, so
    the U-dedup gate picks "i8" at B = 40."""
    rng = np.random.default_rng(0)
    from corpus_util import make_vocab

    vocab = make_vocab(400)[40:]
    return [" ".join(rng.choice(vocab, 6, replace=False)) for _ in range(40)]


BATCHES = {"plain": QUERIES, "sublane": (QUERIES * 6)[:16],
           "i8": _wide_batch()}


def _meshes(name):
    shape = MESHES[name]
    if shape is None:
        return make_mesh(8, device="cpu"), ref_make_mesh(8)
    return make_mesh_2d(*shape, device="cpu"), ref_make_mesh_2d(*shape)


class Built:
    def __init__(self, docs):
        self.art = IndexBuilder(HashingEncoder(dim=32), Config(**CFG)).build(
            docs)
        self.ref_art = RefBuilder(RefEncoder(dim=32), RefConfig(**CFG)).build(
            docs)
        self.single = SearchEngine(self.art, HashingEncoder(dim=32),
                                   Config(**CFG), device="cpu")
        self._cache = {}

    def port(self, mesh_name, kernels=True, bank=None):
        key = ("port", mesh_name, kernels, bank)
        if key not in self._cache:
            self._cache[key] = SearchEngine.sharded(
                self.art, HashingEncoder(dim=32), _meshes(mesh_name)[0],
                Config(**CFG), bank_dtype=bank,
                use_pallas=None if kernels else False)
        return self._cache[key]

    def ref(self, mesh_name, kernels=True, bank=None):
        """The reference's sharded engine; ``kernels`` swaps in its Pallas
        backend (interpret mode), else its default scatter stage 1."""
        key = ("ref", mesh_name, kernels, bank)
        if key not in self._cache:
            mesh = _meshes(mesh_name)[1]
            eng = RefEngine.sharded(self.ref_art, RefEncoder(dim=32), mesh,
                                    RefConfig(**CFG), bank_dtype=bank)
            if kernels:
                b = RefBackend(self.ref_art, mesh, RefConfig(**CFG),
                               bank_dtype=bank or np.float32, use_pallas=True)
                eng._backend, eng._device_rank, eng.didx = b, b.rank, b.sidx
            self._cache[key] = eng
        return self._cache[key]


@pytest.fixture(scope="module")
def built(eight_devices):
    return Built(make_corpus(n_docs=100, seed=11, min_len=30, max_len=150))


@pytest.fixture(scope="module")
def skewed(eight_devices):
    """Most docs one window, four giants with ten (the reference's
    ``TestShardedBucketLayout`` corpus)."""
    docs = make_corpus(n_docs=96, seed=23, min_len=10, max_len=25)
    giants = make_corpus(n_docs=4, seed=24, min_len=2000, max_len=2500)
    for i, g in enumerate(giants):
        docs.append(type(g)(1000 + i, f"https://giant{i}.de/x", g.title, g.text))
    return Built(docs)


def _same_rows(got, want):
    """search_batch rows: equal doc ids and windows, scores to ATOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [x.doc_id for x in g] == [x.doc_id for x in w]
        assert [x.window_index for x in g] == [x.window_index for x in w]
        np.testing.assert_allclose([x.similarity_score for x in g],
                                   [x.similarity_score for x in w],
                                   atol=ATOL, rtol=0)


def _same_raw(got, want):
    doc, vals, old, win, valid = (x.numpy() for x in got)
    rdoc, rvals, rold, rwin, rvalid = (np.asarray(x) for x in want)
    assert valid.any()
    np.testing.assert_array_equal(valid, rvalid)
    np.testing.assert_array_equal(doc[valid], rdoc[rvalid])
    np.testing.assert_array_equal(win[valid], rwin[rvalid])
    np.testing.assert_allclose(vals, rvals, atol=ATOL, rtol=0)
    np.testing.assert_allclose(old, rold, atol=ATOL, rtol=0)


def _same_index(port, ref):
    s, r = port.didx, ref.didx
    assert (s.n_shards, s.d_loc, s.n_docs, s.posting_cap) == (
        r.n_shards, r.d_loc, r.n_docs, r.posting_cap)
    assert s.buckets == r.buckets
    np.testing.assert_array_equal(s.doc_perm, r.doc_perm)
    assert s.shard_ids == tuple(range(r.n_shards))
    for c, sh in enumerate(s.shards):
        for name in ("indptr", "post_docs", "post_impact"):
            np.testing.assert_array_equal(getattr(sh, name).numpy(),
                                          np.asarray(getattr(r, name))[c])
        np.testing.assert_array_equal(sh.col_unperm.numpy(),
                                      np.asarray(r.col_unperm))
        assert len(sh.slot_terms) == len(r.slot_terms)
        for a, b in zip(sh.slot_terms, r.slot_terms):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b)[c])
        for a, b in zip(sh.slot_impact, r.slot_impact):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b)[c])
        for name in ("bucket_valid", "bucket_start", "bucket_emb"):
            for a, b in zip(getattr(sh, name), getattr(r, name)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b)[c])


def test_index_arrays_equal_the_reference(built):
    _same_index(built.port("8"), built.ref("8", kernels=False))


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "scatter"])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_rank_matches_reference(built, batch, kernels):
    port, ref = built.port("8", kernels), built.ref("8", kernels)
    tids, qtf, processed = built.single.prepare_queries(BATCHES[batch])
    qvec = built.single.encode_queries(processed)
    _same_raw(port._backend.rank(tids, qtf, qvec),
              ref._backend.rank(tids, qtf, qvec))


@pytest.mark.parametrize("variant", ["sublane", "wide_i8"])
def test_forced_udedup_variant_matches_reference(built, monkeypatch,
                                                 variant):
    port, ref = built.port("8"), built.ref("8")
    monkeypatch.setattr(sharding, "udedup_plan", lambda u, b: variant)
    monkeypatch.setattr(ref_pallas, "udedup_plan",
                        lambda u, b, nnz=None: variant)
    tids, qtf, processed = built.single.prepare_queries(QUERIES)
    qvec = built.single.encode_queries(processed)
    _same_raw(port._backend.rank(tids, qtf, qvec),
              ref._backend.rank(tids, qtf, qvec))
    assert variant in ref._backend._ranker_ud  # its gate fired too


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "scatter"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_search_batch_matches_reference(built, mesh, kernels):
    port, ref = built.port(mesh, kernels), built.ref(mesh, kernels)
    qs = QUERIES * 2  # 6 queries: a dp of 4 pads the batch
    _same_rows(port.search_batch(qs, top_k=10), ref.search_batch(qs, top_k=10))
    _same_rows([port.search(QUERIES[0], top_k=10)],
               [ref.search(QUERIES[0], top_k=10)])
    for g, w in zip(port.search_batch_indices(qs, top_k=10),
                    ref.search_batch_indices(qs, top_k=10)):
        assert [x[0] for x in g] == [x[0] for x in w]
        np.testing.assert_allclose([x[1] for x in g], [x[1] for x in w],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_bm25_and_dense_search_match_reference(built, mesh):
    port, ref = built.port(mesh), built.ref(mesh, kernels=False)
    n = 0
    for q in QUERIES:
        got, want = port.bm25_search(q, top_k=30), ref.bm25_search(q, top_k=30)
        n += len(want)
        assert [g["doc_id"] for g in got] == [w["doc_id"] for w in want]
        np.testing.assert_allclose([g["score"] for g in got],
                                   [w["score"] for w in want], atol=ATOL,
                                   rtol=0)
        got, want = port.dense_search(q, top_k=10), ref.dense_search(q, top_k=10)
        assert want
        _same_rows([got], [want])
    assert n > 0


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "scatter"])
def test_int8_bank_matches_reference(built, kernels):
    port = built.port("8", kernels, bank="int8")
    ref = built.ref("8", kernels, bank="int8")
    assert isinstance(port.didx.shards[0].bucket_emb[0], tuple)
    for qs in (QUERIES, BATCHES["sublane"]):
        _same_rows(port.search_batch(qs, top_k=10),
                   ref.search_batch(qs, top_k=10))
    _same_rows([port.dense_search(QUERIES[1], top_k=10)],
               [ref.dense_search(QUERIES[1], top_k=10)])


def test_skewed_corpus(skewed):
    port, ref = skewed.port("8", kernels=False), skewed.ref("8", kernels=False)
    _same_index(port, ref)
    s = port.didx
    rows = sum(n * c for n, c in s.buckets) * s.n_shards
    assert rows < s.n_shards * s.d_loc * max(n for n, _ in s.buckets)
    _same_rows(port.search_batch(QUERIES, top_k=10),
               ref.search_batch(QUERIES, top_k=10))
    _same_rows(skewed.port("8").search_batch(QUERIES, top_k=10),
               skewed.ref("8").search_batch(QUERIES, top_k=10))


def test_collectives_a_call(built, monkeypatch):
    """One gather a merge level, one max of the pool extrema, one max of
    (score, win) while chunk ids are exact in f32 (two maxes otherwise),
    whatever the dp split; dense_topk and bm25_topk gather once."""
    tids, qtf, processed = built.single.prepare_queries(QUERIES)
    qvec = built.single.encode_queries(processed)
    for mesh in MESHES:
        b = built.port(mesh)._backend
        b.rank(tids, qtf, qvec)
        assert b.last_collectives == {"gather": 1, "max": 2}, mesh
        b.dense_topk(qvec, 10)
        assert b.last_collectives == {"gather": 1}, mesh
        b.bm25_topk(tids, qtf, 10)
        assert b.last_collectives == {"gather": 1}, mesh
    b = built.port("8")._backend
    want = b.rank(tids, qtf, qvec)
    monkeypatch.setattr(b, "fuse_win", False)
    got = b.rank(tids, qtf, qvec)
    assert b.last_collectives == {"gather": 1, "max": 3}
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_host_mesh_merges_in_two_levels(built):
    """A ("host", "shard") mesh in one process: a gather within each host,
    then one across the hosts' merged sets; the ranking is the flat one."""
    mesh = Mesh(np.array([[torch.device("cpu")] * 4] * 2, dtype=object),
                ("host", "shard"))
    eng = SearchEngine.sharded(built.art, HashingEncoder(dim=32), mesh,
                               Config(**CFG))
    qs = BATCHES["sublane"]
    _same_rows(eng.search_batch(qs, top_k=10),
               built.port("8").search_batch(qs, top_k=10))
    assert eng._backend.last_collectives == {"gather": 2, "max": 2}


def test_mesh_constructors():
    assert make_mesh(device="cpu").shape == {"shard": 1}
    assert make_mesh(8, device="cpu").shape == {"shard": 8}
    m = make_mesh_2d(2, 4, device="cpu")
    assert m.shape == {"dp": 2, "shard": 4} and m.size == 8
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=r"Mesh\("):
        make_mesh_2d(n + 1, 1)
    with pytest.raises(ValueError, match=r"Mesh\("):
        make_mesh(n + 1)
    with pytest.raises(ValueError, match="axes"):
        Mesh(np.array([torch.device("cpu")] * 2, dtype=object), ("dp",))


# ---- the query encoder over the mesh ----------------------------------------


@pytest.fixture(scope="module")
def tiny_encoder():
    cfg = EncoderConfig(vocab_size=512, dim=32, n_layers=2, n_heads=4,
                        mlp_ratio=2, max_len=16, dtype="float32")
    return TorchEncoder(cfg, generator=torch.Generator().manual_seed(3),
                        batch_size=8, device="cpu")


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


@pytest.mark.parametrize("n_texts", [8, 5, 17])
@pytest.mark.parametrize("shape", [None, (4, 2)])
def test_sharded_query_encoder_matches_one_encode(tiny_encoder, n_texts,
                                                  shape):
    texts = [f"castle river doc {i} neckar museum" for i in range(n_texts)]
    mesh = (make_mesh(8, device="cpu") if shape is None
            else make_mesh_2d(*shape, device="cpu"))
    senc = ShardedQueryEncoder(tiny_encoder, mesh)
    assert list(senc.replicas) == [torch.device("cpu")]  # shared replica
    got = senc(texts).numpy()
    want = _unit(tiny_encoder.encode_batch(texts))
    assert got.shape == (n_texts, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_data_parallel_encoder_and_build(tiny_encoder, tmp_path):
    texts = [f"query number {i} tuebingen" for i in range(13)]
    dpe = DataParallelEncoder(tiny_encoder, make_mesh(8, device="cpu"))
    np.testing.assert_allclose(dpe.encode_batch(texts),
                               tiny_encoder.encode_batch(texts), atol=1e-5,
                               rtol=0)
    docs = make_corpus(n_docs=12, seed=5, min_len=20, max_len=60)
    cfg = Config(**CFG)
    a = BuildPipeline(tiny_encoder, str(tmp_path / "a"), cfg, shard_size=5,
                      mesh=make_mesh(4, device="cpu")).build(docs)
    b = BuildPipeline(tiny_encoder, str(tmp_path / "b"), cfg,
                      shard_size=5).build(docs)
    np.testing.assert_allclose(a.chunk_emb, b.chunk_emb, atol=1e-5, rtol=0)


def test_sharded_engine_routes_through_mesh_encode(built, tiny_encoder):
    docs = make_corpus(n_docs=60, seed=7, min_len=30, max_len=120)
    cfg = Config(embedding_dim=32, window_size=16, step_size=12,
                 top_k_retrieval=30, top_k_reranking=10, max_query_terms=8)
    art = IndexBuilder(tiny_encoder, cfg).build(docs)
    single = SearchEngine(art, tiny_encoder, cfg, device="cpu")
    sharded = SearchEngine.sharded(art, tiny_encoder,
                                   make_mesh(8, device="cpu"), cfg)
    assert getattr(sharded, "_sharded_enc", None) is not None
    assert getattr(single, "_sharded_enc", None) is None
    qs = ["research square law", "tübingen research faculty"]
    got, want = sharded.search_batch(qs, top_k=8), single.search_batch(qs,
                                                                       top_k=8)
    assert all(want)
    _same_rows(got, want)
