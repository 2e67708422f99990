"""The port's text route against the reference package's defaults.

The reference's ``Analyzer()`` and ``HashTokenizer()`` take its C++ route
(``native/analyzer.cpp``, built with g++ at first use), whose case fold
covers fewer code points than Python's ``str.lower()``; the port builds
its own copy of that library and takes the same route by default.  Texts
with U+0130, U+1E9E, U+212A and capitals outside Latin-1 (Ł, Greek,
Cyrillic) are where the two routes differ.  Everything here is exact.
"""

import numpy as np
import pytest

from modern_search_engines_project_tpu.index import Document as RefDocument
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.models import HashingEncoder as RefEncoder
from modern_search_engines_project_tpu.text.analyzer import Analyzer as RefAnalyzer
from modern_search_engines_project_tpu.text.hash_tokenizer import (
    HashTokenizer as RefTokenizer,
)
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import Document, IndexBuilder
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.native import native_analyzer
from modern_search_engines_project_tpu_torch.text.analyzer import Analyzer
from modern_search_engines_project_tpu_torch.text.hash_tokenizer import (
    HashTokenizer,
)

TEXTS = [
    "GROẞE Straße in Tübingen",  # U+1E9E
    "İstanbul and Izmir",  # U+0130
    "273 K (Kelvin) is 0 °C",  # U+212A
    "Łódź Universität, ŁÓDŹ",
    "ΑΘΗΝΑ Αθήνα ΣΟΦΙΑ",
    "МОСКВА Москва УНИВЕРСИТЕТ",
    "plain ascii text about the castle",
]
CFG = dict(embedding_dim=32, window_size=16, step_size=12, top_k_retrieval=10,
           top_k_reranking=5, max_query_terms=8)


@pytest.mark.parametrize("text", TEXTS)
def test_analyzer_default_matches_reference(text):
    port, ref = Analyzer(), RefAnalyzer()
    assert port.tokens(text) == ref.tokens(text)
    assert port.count(text) == ref.count(text)


@pytest.mark.parametrize("text", TEXTS)
def test_analyzer_python_route_matches_reference(text):
    port, ref = Analyzer(use_native=False), RefAnalyzer(use_native=False)
    assert port.tokens(text) == ref.tokens(text)
    assert port.count(text) == ref.count(text)


@pytest.mark.parametrize("text", TEXTS)
def test_hash_tokenizer_default_matches_reference(text):
    ids, offs = HashTokenizer().encode_with_offsets(text)
    rids, roffs = RefTokenizer().encode_with_offsets(text)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(rids))
    np.testing.assert_array_equal(np.asarray(offs), np.asarray(roffs))


@pytest.mark.parametrize("text", TEXTS)
def test_hash_tokenizer_python_route_matches_reference(text):
    got = HashTokenizer(use_native=False).encode_with_offsets(text)
    assert got == RefTokenizer(use_native=False).encode_with_offsets(text)


def test_routes_differ_where_the_reference_routes_differ():
    """The fault the default route repairs: "GROẞE" is the term "gro" on
    the C++ route and "große" on the Python one; the tokenizer's ids of
    capitals outside Latin-1 differ too."""
    assert Analyzer().tokens("GROẞE") == ["gro"]
    assert Analyzer(use_native=False).tokens("GROẞE") == ["große"]
    a = HashTokenizer().encode("Łódź ΑΘΗΝΑ")
    b = HashTokenizer(use_native=False).encode("Łódź ΑΘΗΝΑ")
    assert list(a) != list(b)


def test_hashing_encoder_default_matches_reference():
    got = HashingEncoder(dim=32).encode_batch(TEXTS)
    want = RefEncoder(dim=32).encode_batch(TEXTS)
    np.testing.assert_array_equal(got, want)


def test_index_builder_default_matches_reference():
    """The port's IndexBuilder with its default analyzer and tokenizer
    builds the reference's index: same vocabulary, postings and chunk
    vectors."""
    docs = [(i, f"https://www.s{i % 3}.de/{i}", f"t{i}", t * 3)
            for i, t in enumerate(TEXTS)]
    art = IndexBuilder(HashingEncoder(dim=32), Config(**CFG)).build(
        [Document(*d) for d in docs]
    )
    ref = RefBuilder(RefEncoder(dim=32), RefConfig(**CFG)).build(
        [RefDocument(*d) for d in docs]
    )
    assert art.vocab.get("gro") >= 0 and art.vocab.get("große") < 0
    assert art.vocab.term_to_id == ref.vocab.term_to_id
    for f in ("indptr", "post_docs", "post_impact", "chunk_emb", "chunk_doc"):
        np.testing.assert_array_equal(getattr(art, f), getattr(ref, f))
    assert art.window_texts == ref.window_texts


def test_failed_build_raises(tmp_path, monkeypatch):
    """No silent Python route: when g++ fails, asking for the native route
    raises with the compiler's message."""
    bad = tmp_path / "analyzer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_analyzer, "SRC", bad)
    monkeypatch.setattr(native_analyzer, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native_analyzer, "_cached", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        Analyzer()
    assert "error" in str(e.value)
    with pytest.raises(RuntimeError):
        HashTokenizer()
    assert Analyzer(use_native=False).tokens("castle") == ["castle"]


def test_library_is_built_under_build_keyed_by_source():
    path = native_analyzer.library_path()
    native_analyzer.load()
    assert path.exists() and path.parent.parent == native_analyzer.BUILD_ROOT
    assert native_analyzer.BUILD_ROOT.parts[-2:] == ("build", "native")
    assert path.parent != native_analyzer.SRC.parent
