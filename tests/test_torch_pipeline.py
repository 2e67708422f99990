"""The torch port's sharded, resumable build (``index/pipeline.py``), its
CLI (``index/__main__.py``) and the crawl store it reads
(``crawler/storage.py``), against the reference package on the CPU.

The same documents (``tests/corpus_util.py``, made from fixed seeds) go
through the reference's ``BuildPipeline`` and the port's.  Tolerances:
with the hashing encoder both sides compute the same f32 vectors on the
host, so every array, list and dict of the artifacts is equal and the
embeddings agree to 1e-6 (other summation orders in the L2
normalisation).  With a trained checkpoint (``runs/encoder-demo``, 2
layers, 64 wide, bf16) the port's embeddings agree with the reference's
to 5e-3, as ``tests/test_torch_encoder.py`` holds the encoders; every
other field stays equal.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from corpus_util import make_corpus
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.crawler.storage import (
    CrawlStore as RefStore,
)
from modern_search_engines_project_tpu.index import __main__ as ref_cli
from modern_search_engines_project_tpu.index.pipeline import (
    BuildPipeline as RefPipeline,
)
from modern_search_engines_project_tpu.models import HashingEncoder as RefHashing
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.crawler import CrawlStore
from modern_search_engines_project_tpu_torch.index import (
    BuildPipeline,
    DataParallelEncoder,
    IndexBuilder,
    load_artifacts,
)
from modern_search_engines_project_tpu_torch.index import __main__ as cli
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.retrieval import SearchEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "runs", "encoder-demo")
CFG = dict(embedding_dim=32, window_size=32, step_size=25,
           top_k_retrieval=20, top_k_reranking=10, max_query_terms=8)
ARRAYS = ["indptr", "post_docs", "post_impact", "idf", "df", "doc_len",
          "chunk_doc", "doc_chunk_start", "doc_n_chunks"]
LISTS = ["doc_ids", "urls", "titles", "domains", "snippets", "window_texts"]


@pytest.fixture(scope="module")
def corpus():
    docs = make_corpus(n_docs=30, seed=11, min_len=20, max_len=120)
    docs[4].text = ""  # an empty document still gets one window
    docs[7].title = ""
    return docs


def same_artifacts(got, want, emb_atol=1e-6):
    for f in ARRAYS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in LISTS:
        assert list(getattr(got, f)) == list(getattr(want, f)), f
    assert got.avgdl == want.avgdl
    assert got.vocab.term_to_id == want.vocab.term_to_id
    assert got.config.__dict__ == want.config.__dict__
    assert got.encoder_meta == want.encoder_meta
    assert got.chunk_emb.shape == want.chunk_emb.shape
    np.testing.assert_allclose(got.chunk_emb, want.chunk_emb, rtol=0,
                               atol=emb_atol)


@pytest.mark.parametrize("shard_size,use_bm25", [(7, True), (1000, True),
                                                 (4, False)])
def test_pipeline_equals_reference(corpus, tmp_path, shard_size, use_bm25):
    cfg = Config(**CFG, use_bm25=use_bm25)
    got = BuildPipeline(HashingEncoder(dim=32), str(tmp_path / "port"), cfg,
                        shard_size=shard_size).build(corpus)
    want = RefPipeline(RefHashing(dim=32), str(tmp_path / "ref"),
                       RefConfig(**CFG, use_bm25=use_bm25),
                       shard_size=shard_size).build(corpus)
    same_artifacts(got, want)
    assert ((tmp_path / "port" / "manifest.json").read_text()
            == (tmp_path / "ref" / "manifest.json").read_text())
    # the shard files hold the same payload
    shards = sorted(os.listdir(tmp_path / "ref" / "shards"))
    assert sorted(os.listdir(tmp_path / "port" / "shards")) == shards
    for s in shards:
        with open(tmp_path / "port" / "shards" / s, "rb") as f:
            a = pickle.load(f)
        with open(tmp_path / "ref" / "shards" / s, "rb") as f:
            b = pickle.load(f)
        assert a.keys() == b.keys()
        for k in b:
            if k == "chunk_emb":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
            elif isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


def test_pipeline_equals_the_one_shot_builder(corpus, tmp_path):
    cfg = Config(**CFG)
    enc = HashingEncoder(dim=32)
    got = BuildPipeline(enc, str(tmp_path), cfg, shard_size=8).build(corpus)
    want = IndexBuilder(enc, cfg).build(corpus)
    same_artifacts(got, want)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_build_half_done_by_one_package_resumed_by_the_other(
        corpus, tmp_path, first):
    """Shards 0-1 built by one package (as if it were stopped), the build
    resumed by the other: the built shards are kept, the rest built, and
    the merge equals a whole build."""
    cfg, rcfg = Config(**CFG), RefConfig(**CFG)
    out = str(tmp_path / "half")
    begin = (RefPipeline(RefHashing(dim=32), out, rcfg, shard_size=8)
             if first == "reference"
             else BuildPipeline(HashingEncoder(dim=32), out, cfg, shard_size=8))
    for i in range(2):
        begin.build_shard(i, corpus[i * 8 : (i + 1) * 8])
    kept = {i: os.path.getmtime(begin._shard_path(i)) for i in range(2)}
    if first == "reference":
        resumed = BuildPipeline(HashingEncoder(dim=32), out, cfg,
                                shard_size=8).build(corpus)
    else:
        resumed = RefPipeline(RefHashing(dim=32), out, rcfg,
                              shard_size=8).build(corpus)
    assert all(os.path.getmtime(begin._shard_path(i)) == t
               for i, t in kept.items())
    whole = BuildPipeline(HashingEncoder(dim=32), str(tmp_path / "whole"),
                          cfg, shard_size=8).build(corpus)
    same_artifacts(resumed, whole)


def test_a_mesh_is_refused():
    """Anything but a ``parallel.sharding.Mesh`` is refused as a mesh (a
    real mesh splits the batch: ``tests/test_torch_sharding.py``)."""
    with pytest.raises(TypeError, match="Mesh"):
        DataParallelEncoder(HashingEncoder(dim=8), mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        BuildPipeline(HashingEncoder(dim=8), "unused", mesh=object())
    enc = DataParallelEncoder(HashingEncoder(dim=8))
    assert enc.dim == 8
    assert np.array_equal(enc.encode_batch(["a b"]),
                          HashingEncoder(dim=8).encode_batch(["a b"]))


def fill(store, docs, score=1.0):
    store.upsert_documents(
        {"url": d.url, "title": d.title, "text": d.text,
         "tue_eng_score": score if i % 3 else 0.2}
        for i, d in enumerate(docs))


@pytest.fixture()
def stores(corpus, tmp_path):
    db = str(tmp_path / "crawl.sqlite")
    s = RefStore(db)
    fill(s, corpus[:20])
    s.close()
    return db


def test_index_cli_equals_reference(stores, corpus, tmp_path):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    args = ["--db", stores, "--shard-size", "6", "--min-score", "0.5"]
    cli.main(args + ["--out", mine, "--device", "cpu"])
    ref_cli.main(args + ["--out", theirs])
    got, want = load_artifacts(mine), load_artifacts(theirs)
    assert got.n_docs == 13  # 20 docs, 7 under the score cut
    same_artifacts(got, want)
    # --force rebuilds every shard: a document added since is indexed
    store = CrawlStore(stores)
    fill(store, corpus[20:24])
    store.close()
    # a re-run resumes: the 3 shards exist, so the stale ones are merged
    cli.main(args + ["--out", mine, "--device", "cpu"])
    assert load_artifacts(mine).n_docs == 13
    cli.main(args + ["--out", mine, "--device", "cpu", "--force"])
    ref_cli.main(args + ["--out", theirs, "--force"])
    got, want = load_artifacts(mine), load_artifacts(theirs)
    assert got.n_docs == 15  # 2 of the 4 new docs pass the score cut
    same_artifacts(got, want)
    eng = SearchEngine(got, HashingEncoder(dim=got.config.embedding_dim),
                       got.config, device="cpu")
    assert eng.search(got.window_texts[1])


def test_index_cli_with_a_checkpoint(stores, tmp_path):
    """``--encoder CKPT``: the trained encoder embeds the windows; the
    artifacts record its provenance (the checkpoint's path and digest),
    as the reference's do."""
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    args = ["--db", stores, "--shard-size", "8", "--encoder", DEMO]
    cli.main(args + ["--out", mine, "--device", "cpu"])
    ref_cli.main(args + ["--out", theirs])
    got, want = load_artifacts(mine), load_artifacts(theirs)
    assert got.encoder_meta["ckpt"] == DEMO
    assert got.config.embedding_dim == 64
    same_artifacts(got, want, emb_atol=5e-3)


def test_index_cli_needs_the_card_unless_asked(monkeypatch, stores, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--db", stores, "--out", str(tmp_path / "x")])
    assert not os.path.exists(tmp_path / "x")


def test_crawl_store_copy_matches_reference(corpus, tmp_path):
    a, b = CrawlStore(str(tmp_path / "a.sqlite")), RefStore(":memory:")
    for s in (a, b):
        fill(s, corpus[:10])
        fill(s, corpus[5:12], score=0.9)  # upserts
        s.log_error("https://x.de/", 404, "gone", 1.5)
        s.save_state({"frontier": [1, 2], "delays": {"x.de": 2.0}})
    assert a.n_documents() == b.n_documents() == 12
    assert a.has_url(corpus[3].url) and not a.has_url("https://none/")
    for min_score in (0.0, 0.5, 0.95):
        got = [dataclasses.astuple(d) for d in a.iter_documents(min_score, 4)]
        want = [dataclasses.astuple(d) for d in b.iter_documents(min_score, 4)]
        assert got == want
    assert a.recent_errors() == b.recent_errors()
    assert a.load_state() == b.load_state()
    pa, pb = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    assert a.export_csv(pa, 5) == b.export_csv(pb, 5)
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()
    a.close()
    b.close()
