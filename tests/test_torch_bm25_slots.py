"""Plain versions of the three slot BM25 kernels against the reference's
Pallas kernels (interpret mode on the CPU), plus the host-side dispatch
and query prep.  Keyed scores must agree to 1e-5: every path sums at most
T nonzero f32 products per doc; the integer weights are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus_util import make_corpus
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.models import HashingEncoder as RefEncoder
from modern_search_engines_project_tpu.retrieval import bm25_pallas as ref
from modern_search_engines_project_tpu.retrieval.device_index import (
    DeviceIndex as RefIndex,
    build_slot_postings as ref_build_slot_postings,
)
from modern_search_engines_project_tpu_torch.retrieval import bm25_slots as port
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    build_slot_postings,
    device_index_from_numpy,
)
from test_torch_device_index import ref_fields

ATOL = 1e-5


@pytest.fixture(scope="module")
def built():
    cfg = RefConfig(embedding_dim=32, window_size=32, step_size=25,
                    top_k_retrieval=30, top_k_reranking=10, max_query_terms=8)
    art = RefBuilder(RefEncoder(dim=32), cfg).build(make_corpus(60, seed=5))
    ri = RefIndex.from_artifacts(art, cfg)
    pi = device_index_from_numpy(ref_fields(ri), "cpu")
    return art, ri, pi


def _queries(seed, B, T, n_terms):
    rng = np.random.default_rng(seed)
    tids = rng.integers(-1, n_terms, (B, T)).astype(np.int32)  # -1 = pad
    if B > 1:
        tids[1] = tids[0]  # shared terms across queries
    qtf = np.where(tids >= 0, rng.integers(1, 4, (B, T)), 0)
    return tids, qtf.astype(np.float32)


def _ref_slots(ri, tids, qtf):
    return np.asarray(
        ref.bm25_score_slots(
            ri.slot_terms, ri.slot_impact, ri.col_unperm,
            jnp.asarray(tids), jnp.asarray(qtf), interpret=True,
        )
    )


@pytest.mark.parametrize("B", [1, 8, 32])
def test_plain_kernel_matches_reference(built, B):
    art, ri, pi = built
    tids, qtf = _queries(B, B, 8, art.n_terms)
    want = _ref_slots(ri, tids, qtf)
    got = port.bm25_score_slots(pi, torch.as_tensor(tids), torch.as_tensor(qtf))
    assert got.shape == want.shape == (B, pi.n_docs_pad + 1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert (want >= 0).any() and (want[:, -1] == -1).all()


@pytest.mark.parametrize("variant", ["sublane", "i8"])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_udedup_kernels_match_reference(built, variant, B):
    art, ri, pi = built
    tids, qtf = _queries(100 + B, B, 8, art.n_terms)
    uids, w = ref.dedup_query_terms(tids, qtf)
    want = np.asarray(
        ref.bm25_score_slots_udedup(
            ri.slot_terms, ri.slot_impact, ri.col_unperm,
            jnp.asarray(uids), jnp.asarray(w), interpret=True, variant=variant,
        )
    )
    got = port.bm25_score_slots_udedup(
        pi, torch.as_tensor(uids), torch.as_tensor(w), variant
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # exact kernels: the U-dedup scores equal the per-query kernel's
    plain = port.bm25_score_slots(pi, torch.as_tensor(tids), torch.as_tensor(qtf))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)


def test_all_pad_query_keys_minus_one(built):
    """Query pad -1 is remapped to -2, so it never matches posting pad -1."""
    _, ri, pi = built
    tids = np.full((2, 4), -1, np.int32)
    qtf = np.zeros((2, 4), np.float32)
    want = _ref_slots(ri, tids, qtf)
    got = port.bm25_score_slots(pi, torch.as_tensor(tids), torch.as_tensor(qtf))
    assert (want == -1).all() and (got.numpy() == -1).all()


def test_keyed_contract_zero_and_negative_scores():
    """A matched doc whose score is exactly 0 stays admissible (keyed 0);
    a negative score keys to -1, as does an unmatched doc."""
    indptr = np.array([0, 3, 5, 6], np.int64)  # terms 0, 1, 2
    post_docs = np.array([0, 1, 2, 1, 3, 4], np.int32)
    impact = np.array([1.5, 0.0, -2.0, 0.0, 0.25, 3.0], np.float32)
    st, si, cu = build_slot_postings(indptr, post_docs, impact, 128)
    rst, rsi, rcu = ref_build_slot_postings(indptr, post_docs, impact, 128)
    tids = np.array([[0, 1, -1, -1], [2, -1, -1, -1]], np.int32)
    qtf = np.array([[1, 2, 0, 0], [1, 0, 0, 0]], np.float32)
    want = np.asarray(
        ref.bm25_score_slots(
            tuple(map(jnp.asarray, rst)), tuple(map(jnp.asarray, rsi)),
            jnp.asarray(rcu), jnp.asarray(tids), jnp.asarray(qtf),
            interpret=True,
        )
    )
    full = port.slots_plain(
        [torch.as_tensor(t) for t in st], [torch.as_tensor(t) for t in si],
        torch.as_tensor(tids), torch.as_tensor(qtf),
    )
    got = port._slots_key(full, torch.as_tensor(cu), 2).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got[0, :5].tolist() == [1.5, 0.0, -1.0, 0.5, -1.0]
    assert got[1, 4] == 3.0 and got[1, 0] == -1.0


@pytest.mark.parametrize("n_docs_pad", [128, 1536])
def test_slots_key_matches_reference(n_docs_pad):
    """Group-gather un-permutation (>= one group) and the elementwise
    gather of tiny corpora (< one group)."""
    rng = np.random.default_rng(n_docs_pad)
    nnz = 8 * n_docs_pad
    indptr = np.array([0, nnz // 2, nnz], np.int64)
    post_docs = rng.integers(0, n_docs_pad, nnz).astype(np.int32)
    # skewed per-doc counts -> several stride classes -> groups reordered
    post_docs[: nnz // 3] = rng.integers(0, 64, nnz // 3)
    impact = rng.random(nnz).astype(np.float32)
    _, si, cu = build_slot_postings(indptr, post_docs, impact, n_docs_pad)
    n_cols = sum(t.shape[0] * t.shape[2] for t in si)
    keyed = rng.standard_normal((3, n_cols)).astype(np.float32)
    want = np.asarray(ref._slots_key(jnp.asarray(keyed), jnp.asarray(cu), 3))
    got = port._slots_key(torch.as_tensor(keyed), torch.as_tensor(cu), 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B", [1, 4, 7, 8, 16, 31, 32, 64, 128])
def test_udedup_plan_matches_reference(B):
    for u_pad in (128, 256, 384, 512, 640, 1024, 1152):
        assert port.udedup_plan(u_pad, B) == ref.udedup_plan(u_pad, B)


def test_u_pad_for_matches_reference():
    for n in (0, 1, 127, 128, 129, 256, 511, 512, 1000, 1024, 1025, 5000):
        assert port.u_pad_for(n) == ref.u_pad_for(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_query_terms_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B, T = 16, 8
    tids = rng.integers(-1, 50, (B, T)).astype(np.int32)
    qtf = np.where(tids >= 0, rng.integers(1, 5, (B, T)), 0).astype(np.float32)
    for got, want in zip(port.dedup_query_terms(tids, qtf),
                         ref.dedup_query_terms(tids, qtf)):
        np.testing.assert_array_equal(got, want)


def test_wrappers_take_plain_versions_on_cpu(built):
    """CPU tensors go to the plain versions and launch nothing."""
    art, _, pi = built
    tids, qtf = _queries(7, 8, 4, art.n_terms)
    t, q = torch.as_tensor(tids), torch.as_tensor(qtf)
    uids, w = port.dedup_query_terms(tids, qtf)
    u, wt = torch.as_tensor(uids), torch.as_tensor(w)
    counts = [k.launches for k in (port.SLOTS_KERNEL, *port.UDEDUP_KERNELS.values())]
    st = pi.slot_stream
    assert torch.equal(
        port.slots_keyed(st, pi.slot_terms, pi.slot_impact, t, q),
        port.slots_plain(pi.slot_terms, pi.slot_impact, t, q),
    )
    for variant in ("sublane", "i8"):
        assert torch.equal(
            port.slots_udedup_keyed(st, pi.slot_terms, pi.slot_impact, u, wt,
                                    variant),
            port.slots_udedup_plain(pi.slot_terms, pi.slot_impact, u, wt,
                                    variant),
        )
    assert counts == [
        k.launches for k in (port.SLOTS_KERNEL, *port.UDEDUP_KERNELS.values())
    ]
    with pytest.raises(ValueError):
        port.slots_udedup_plain(pi.slot_terms, pi.slot_impact, u, wt, "acc")
