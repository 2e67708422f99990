"""The torch port's index layouts equal the reference package's.

Both packages build from the same IndexArtifacts; every slot, blocked,
bucket, packed and permutation array of the port's DeviceIndex must equal
the reference DeviceIndex field bit for bit (the blocked layout's doc
permutation too: top-k ties break by permuted index), and
device_index_from_numpy must carry the reference's arrays across
unchanged.  JAX stays on the CPU; data crosses
as numpy.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus_util import make_corpus
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.models import HashingEncoder as RefEncoder
from modern_search_engines_project_tpu.retrieval.device_index import (
    DeviceIndex as RefIndex,
    balance_by_load as ref_balance_by_load,
)
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import IndexBuilder
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    SLOT_COLS,
    DeviceIndex,
    balance_by_load,
    build_index_fields,
    device_index_from_numpy,
    resolve_device,
)

CFG = dict(embedding_dim=32, window_size=32, step_size=25, max_query_terms=8)
CORPORA = {
    "docs60": dict(n_docs=60, seed=5),
    "docs80": dict(n_docs=80, seed=42),
    "docs700": dict(n_docs=700, seed=3, max_len=120),
}


def local_ids(blk) -> torch.Tensor:
    """The per-slot local doc ids [n_blocks, p_blk] that a BlockedPostings'
    doc offsets encode (doc j of row i over its run, pads 0), as the
    reference's ``blk_local`` holds them."""
    off = blk.doc_off.numpy()
    out = np.zeros((blk.n_blocks, blk.p_blk), np.int32)
    for i in range(blk.n_blocks):
        out[i, : off[i, -1]] = np.repeat(np.arange(128), np.diff(off[i]))
    return torch.from_numpy(out)


def ref_fields(ri) -> dict:
    """The reference DeviceIndex's arrays as numpy: the slot layout when it
    has one, else the blocked one; the packed chunk arrays when it has no
    buckets."""
    if ri.slot_terms is not None:
        bm25 = {
            "slot_terms": tuple(np.asarray(t) for t in ri.slot_terms),
            "slot_impact": tuple(np.asarray(t) for t in ri.slot_impact),
            "col_unperm": np.asarray(ri.col_unperm),
        }
    else:
        bm25 = {k: np.asarray(getattr(ri, k))
                for k in ("blk_terms", "blk_impact", "blk_local")}
    if not ri.buckets:
        bm25["chunk_emb"] = np.asarray(ri.chunk_emb, np.float32)
        for k in ("chunk_doc", "doc_chunk_start", "doc_n_chunks"):
            bm25[k] = np.asarray(getattr(ri, k))
    return {
        **bm25,
        "buckets": ri.buckets,
        "bucket_emb": tuple(np.asarray(e, np.float32) for e in ri.bucket_emb),
        "bucket_valid": tuple(np.asarray(v) for v in ri.bucket_valid),
        "bucket_start": tuple(np.asarray(s) for s in ri.bucket_start),
        "doc_perm": ri.doc_perm,
        "n_docs": ri.n_docs,
        "n_docs_pad": ri.n_docs_pad,
        "n_chunks_pad": ri.n_chunks_pad,
        "n_terms": ri.n_terms,
        "nnz": ri.nnz,
    }


@pytest.fixture(scope="module", params=sorted(CORPORA))
def built(request):
    docs = make_corpus(**CORPORA[request.param])
    art = RefBuilder(RefEncoder(dim=32), RefConfig(**CFG)).build(docs)
    ri = RefIndex.from_artifacts(art, RefConfig(**CFG))
    pi = DeviceIndex.from_artifacts(art, Config(**CFG), device="cpu")
    return docs, art, ri, pi


def test_slot_layout_matches_reference(built):
    _, _, ri, pi = built
    assert len(pi.slot_terms) == len(ri.slot_terms)
    for a, b in zip(pi.slot_terms, ri.slot_terms):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pi.slot_impact, ri.slot_impact):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(pi.col_unperm.numpy(), np.asarray(ri.col_unperm))


def test_bucket_layout_matches_reference(built):
    _, _, ri, pi = built
    assert pi.buckets == ri.buckets
    for a, b in zip(pi.bucket_emb, ri.bucket_emb):
        assert a.dtype == torch.float32  # f32 bank on the CPU
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pi.bucket_valid, ri.bucket_valid):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pi.bucket_start, ri.bucket_start):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_permutation_and_sizes_match_reference(built):
    _, _, ri, pi = built
    np.testing.assert_array_equal(pi.doc_perm, ri.doc_perm)
    for f in ("n_docs", "n_docs_pad", "n_chunks_pad", "n_terms", "nnz"):
        assert getattr(pi, f) == getattr(ri, f), f


def test_from_numpy_round_trips(built):
    """The reference's arrays carried across give the port's own index."""
    _, _, ri, pi = built
    got = device_index_from_numpy(ref_fields(ri), "cpu")
    for name in ("slot_terms", "slot_impact", "bucket_emb", "bucket_valid",
                 "bucket_start"):
        for a, b in zip(getattr(got, name), getattr(pi, name)):
            assert torch.equal(a, b), name
    for name in ("terms", "impact", "group_off", "group_rows"):
        assert torch.equal(
            getattr(got.slot_stream, name), getattr(pi.slot_stream, name)
        )
    assert torch.equal(got.col_unperm, pi.col_unperm)
    np.testing.assert_array_equal(got.doc_perm, pi.doc_perm)
    assert got.buckets == pi.buckets and got.n_docs_pad == pi.n_docs_pad


def test_slot_stream_holds_every_class_once(built):
    """Per-class tensors are views into the one flat stream the kernels
    walk; groups appear in class-concatenated order."""
    _, _, _, pi = built
    st = pi.slot_stream
    assert st.n_groups == sum(t.shape[0] for t in pi.slot_terms)
    assert int((st.group_rows.long() * SLOT_COLS).sum()) == st.terms.numel()
    g = 0
    for terms, impact in zip(pi.slot_terms, pi.slot_impact):
        assert terms.untyped_storage().data_ptr() == (
            st.terms.untyped_storage().data_ptr()
        )
        n_g, S, cols = terms.shape
        for i in range(n_g):
            off, rows = int(st.group_off[g]), int(st.group_rows[g])
            assert rows == S and cols == SLOT_COLS
            flat = st.terms[off : off + rows * cols].view(rows, cols)
            assert torch.equal(flat, terms[i])
            assert torch.equal(
                st.impact[off : off + rows * cols].view(rows, cols), impact[i]
            )
            g += 1


def test_slot_postings_round_trip(built):
    """Every posting lands once; per-doc impact sums survive the layout."""
    _, art, _, pi = built
    total = sum(int((t >= 0).sum()) for t in pi.slot_terms)
    assert total == art.post_docs.shape[0]
    real = pi.doc_perm >= 0
    want = np.zeros(art.n_docs)
    np.add.at(want, art.post_docs, art.post_impact)
    col_sums = torch.cat(
        [im.sum(dim=1).reshape(-1) for im in pi.slot_impact]
    ).numpy()
    got = col_sums[pi.col_unperm.numpy()]
    np.testing.assert_allclose(got[real], want[pi.doc_perm[real]], atol=1e-4)
    assert np.all(got[~real] == 0)


def test_port_builder_matches_reference(built):
    """The port's IndexBuilder gives the reference's artifacts up to the
    order in which term ids are assigned."""
    docs, ref, _, _ = built
    art = IndexBuilder(HashingEncoder(dim=32), Config(**CFG)).build(docs)
    assert set(art.vocab.term_to_id) == set(ref.vocab.term_to_id)
    np.testing.assert_array_equal(art.chunk_emb, ref.chunk_emb)
    for f in ("chunk_doc", "doc_chunk_start", "doc_n_chunks", "doc_len"):
        np.testing.assert_array_equal(getattr(art, f), getattr(ref, f))
    assert art.avgdl == ref.avgdl
    assert art.window_texts == ref.window_texts and art.urls == ref.urls
    for term, tid in ref.vocab.term_to_id.items():
        t2 = art.vocab.get(term)
        s, e = ref.indptr[tid], ref.indptr[tid + 1]
        s2, e2 = art.indptr[t2], art.indptr[t2 + 1]
        a = sorted(zip(ref.post_docs[s:e].tolist(), ref.post_impact[s:e].tolist()))
        b = sorted(zip(art.post_docs[s2:e2].tolist(), art.post_impact[s2:e2].tolist()))
        assert a == b, term
        assert art.idf[t2] == ref.idf[tid]


def test_bf16_bank_matches_reference_rounding():
    art = RefBuilder(RefEncoder(dim=32), RefConfig(**CFG)).build(
        make_corpus(60, seed=5)
    )
    ri = RefIndex.from_artifacts(art, RefConfig(**CFG), bank_dtype=jnp.bfloat16)
    pi = DeviceIndex.from_artifacts(
        art, Config(**CFG), bank_dtype=torch.bfloat16, device="cpu"
    )
    for a, b in zip(pi.bucket_emb, ri.bucket_emb):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(b, np.float32)
        )


def test_index_without_chunks_is_refused():
    """An index without chunk embeddings has no buckets, so the slot layout
    is refused for it: it is built on the blocked layout with the packed
    chunk arrays, in artifact doc order, equal to the reference's."""
    art = RefBuilder(RefEncoder(dim=32), RefConfig(**CFG)).build(
        make_corpus(20, seed=1)
    )
    empty = dataclasses.replace(
        art,
        chunk_emb=np.zeros((0, 32), np.float32),
        chunk_doc=np.zeros(0, np.int32),
        doc_chunk_start=np.zeros(art.n_docs, np.int32),
        doc_n_chunks=np.zeros(art.n_docs, np.int32),
    )
    f = build_index_fields(empty, Config(**CFG))
    assert f.get("slot_terms") is None and f["doc_perm"] is None
    assert f["buckets"] == ()
    ri = RefIndex.from_artifacts(
        empty, RefConfig(**CFG), build_unused_layout=False
    )
    assert ri.slot_terms is None
    want = ref_fields(ri)
    for k in ("blk_terms", "blk_impact", "blk_local", "chunk_emb",
              "chunk_doc", "doc_chunk_start", "doc_n_chunks"):
        np.testing.assert_array_equal(f[k], want[k], err_msg=k)
    pi = device_index_from_numpy(f, "cpu")
    assert pi.bm25_layout == "blocked" and pi.slot_stream is None


def test_empty_corpus_index_matches_reference():
    art = RefBuilder(RefEncoder(dim=32), RefConfig(**CFG)).build([])
    ri = RefIndex.from_artifacts(art, RefConfig(**CFG), build_unused_layout=False)
    pi = DeviceIndex.from_artifacts(art, Config(**CFG), device="cpu")
    want = ref_fields(ri)
    b = pi.blocked
    for got, k in ((b.terms, "blk_terms"), (b.impact, "blk_impact"),
                   (local_ids(b), "blk_local"), (pi.chunk_emb, "chunk_emb"),
                   (pi.chunk_doc, "chunk_doc"),
                   (pi.doc_chunk_start, "doc_chunk_start"),
                   (pi.doc_n_chunks, "doc_n_chunks")):
        np.testing.assert_array_equal(got.numpy(), want[k], err_msg=k)
    assert pi.n_docs_pad == ri.n_docs_pad == 128 and pi.doc_perm is None
    assert int(b.doc_off.sum()) == 0 and pi.resident_bytes() > 0


@pytest.mark.parametrize("n", [0, 5, 128, 129, 300, 1000])
def test_balance_by_load_matches_reference(n):
    rng = np.random.default_rng(n)
    load = rng.integers(0, 50, 2000)
    load[::7] = 10  # ties: the stable sort keeps them in index order
    idxs = rng.permutation(2000)[:n]
    got = balance_by_load(idxs, load, 128)
    np.testing.assert_array_equal(got, ref_balance_by_load(idxs, load, 128))
    assert sorted(got.tolist()) == sorted(idxs.tolist())


@pytest.fixture(scope="module", params=sorted(CORPORA))
def built_blocked(request):
    docs = make_corpus(**CORPORA[request.param])
    art = RefBuilder(RefEncoder(dim=32), RefConfig(**CFG)).build(docs)
    ri = RefIndex.from_artifacts(
        art, RefConfig(**CFG), bm25_layout="blocked", build_unused_layout=False
    )
    pi = DeviceIndex.from_artifacts(
        art, Config(**CFG), device="cpu", bm25_layout="blocked"
    )
    return art, ri, pi


def test_blocked_layout_matches_reference(built_blocked):
    """doc_perm (balance_by_load inside each bucket) and the blk_* arrays
    equal the reference's; only the blocked layout is resident."""
    _, ri, pi = built_blocked
    assert ri.slot_terms is None and pi.slot_stream is None
    assert pi.bm25_layout == "blocked" and pi.col_unperm is None
    np.testing.assert_array_equal(pi.doc_perm, ri.doc_perm)
    for got, name in ((pi.blocked.terms, "blk_terms"),
                      (pi.blocked.impact, "blk_impact"),
                      (local_ids(pi.blocked), "blk_local")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ri, name)))
    assert pi.buckets == ri.buckets
    for a, b in zip(pi.bucket_emb, ri.bucket_emb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("n_docs", "n_docs_pad", "n_chunks_pad", "n_terms", "nnz"):
        assert getattr(pi, f) == getattr(ri, f), f
    assert pi.chunk_emb is None  # the bucketed tail needs no packed bank


def test_blocked_permutation_differs_from_slots(built_blocked):
    """Each layout orders docs inside a bucket its own way."""
    art, _, pi = built_blocked
    slots = DeviceIndex.from_artifacts(art, Config(**CFG), device="cpu")
    assert sorted(slots.doc_perm.tolist()) == sorted(pi.doc_perm.tolist())
    if art.n_docs > 128:
        assert not np.array_equal(slots.doc_perm, pi.doc_perm)


def test_blocked_from_numpy_round_trips(built_blocked):
    """The reference's blocked arrays carried across give the port's own
    index, doc offsets included."""
    _, ri, pi = built_blocked
    got = device_index_from_numpy(ref_fields(ri), "cpu")
    for name in ("terms", "impact", "doc_off"):
        assert torch.equal(getattr(got.blocked, name),
                           getattr(pi.blocked, name)), name
    np.testing.assert_array_equal(got.doc_perm, pi.doc_perm)
    assert got.resident_bytes() == pi.resident_bytes()


def test_blocked_doc_offsets_cover_every_posting(built_blocked):
    """Row i's doc runs hold every real posting once, in doc order; the
    per-doc impact sums equal the artifact's."""
    art, _, pi = built_blocked
    b = pi.blocked
    off = b.doc_off.numpy()
    assert int(off[:, -1].sum()) == art.post_docs.shape[0]
    sums = np.zeros(pi.n_docs_pad)
    imp = b.impact.numpy()
    for i in range(b.n_blocks):
        for j in range(128):
            sums[i * 128 + j] = imp[i, off[i, j]:off[i, j + 1]].sum()
    want = np.zeros(art.n_docs)
    np.add.at(want, art.post_docs, art.post_impact)
    real = pi.doc_perm >= 0
    np.testing.assert_allclose(sums[real], want[pi.doc_perm[real]], atol=1e-4)
    assert np.all(sums[~real] == 0)


def test_no_card_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
