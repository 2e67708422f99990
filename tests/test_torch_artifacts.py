"""Index artifacts cross between the packages: what the reference's
``save_artifacts`` writes, the port's ``load_artifacts`` reads, and the
other way round, with every array and every metadata field equal; the
loaded index serves the same top-10 through both engines (the port's on
the CPU, the reference's with ``use_pallas=True`` in interpret mode)."""

import dataclasses
import json

import numpy as np
import pytest

from corpus_util import make_corpus
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.index import (
    load_artifacts as ref_load,
    save_artifacts as ref_save,
)
from modern_search_engines_project_tpu.models import HashingEncoder as RefEncoder
from modern_search_engines_project_tpu.retrieval import SearchEngine as RefEngine
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import (
    IndexBuilder,
    load_artifacts,
    save_artifacts,
)
from modern_search_engines_project_tpu_torch.index.artifacts import (
    _ARRAY_FIELDS,
    _META_FIELDS,
)
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.retrieval import SearchEngine

CFG = dict(embedding_dim=32, window_size=32, step_size=25, top_k_retrieval=30,
           top_k_reranking=10, max_query_terms=8)
QUERIES = ["research law", "forest library castle", "tübingen market"]


@pytest.fixture(scope="module")
def ref_art():
    docs = make_corpus(n_docs=60, seed=11, min_len=30, max_len=150)
    return RefBuilder(RefEncoder(dim=32), RefConfig(**CFG)).build(docs)


def assert_same_artifacts(a, b):
    for f in _ARRAY_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in _META_FIELDS:
        assert list(getattr(a, f)) == list(getattr(b, f)), f
    assert a.avgdl == b.avgdl
    assert a.vocab.term_to_id == b.vocab.term_to_id
    assert a.config.__dict__ == b.config.__dict__
    assert a.encoder_meta == b.encoder_meta


def test_reference_writes_port_reads_and_back(ref_art, tmp_path):
    ref_save(ref_art, str(tmp_path / "ref"))
    art = load_artifacts(str(tmp_path / "ref"))
    assert isinstance(art.config, Config)
    assert_same_artifacts(art, ref_art)
    save_artifacts(art, str(tmp_path / "port"))
    for name in ("arrays.npz", "vocab.json", "meta.json"):
        assert (tmp_path / "port" / name).exists()
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "arrays.npz", "meta.json", "vocab.json"]  # no temporary left
    back = ref_load(str(tmp_path / "port"))
    assert_same_artifacts(back, ref_art)
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == \
        json.loads((tmp_path / "ref" / "meta.json").read_text())


def test_port_written_index_loads_in_reference(tmp_path):
    docs = make_corpus(n_docs=30, seed=4, min_len=30, max_len=90)
    art = IndexBuilder(HashingEncoder(dim=32), Config(**CFG)).build(docs)
    save_artifacts(art, str(tmp_path))
    assert_same_artifacts(ref_load(str(tmp_path)), art)
    save_artifacts(dataclasses.replace(art, titles=["x"] * art.n_docs),
                   str(tmp_path))  # saving over an index replaces it
    assert load_artifacts(str(tmp_path)).titles == ["x"] * art.n_docs


def test_loaded_index_serves_same_top10(ref_art, tmp_path):
    ref_save(ref_art, str(tmp_path))
    art = load_artifacts(str(tmp_path))
    port = SearchEngine(art, HashingEncoder(dim=32), art.config, device="cpu")
    ref = RefEngine(ref_load(str(tmp_path)), RefEncoder(dim=32),
                    use_pallas=True)
    got = port.search_batch(QUERIES, top_k=10)
    want = ref.search_batch(QUERIES, top_k=10)
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert [r.doc_id for r in g] == [r.doc_id for r in w]
        assert [r.window_index for r in g] == [r.window_index for r in w]
        np.testing.assert_allclose([r.similarity_score for r in g],
                                   [r.similarity_score for r in w], atol=1e-5)
