"""Plain versions of the two blocked BM25 kernels against the reference's
Pallas kernels (interpret mode on the CPU), against the slot path and a
numpy oracle, plus the blocked layout itself and the wrappers' handling of
any U and any T.

Tolerances: the TPU kernels reduce postings to docs with a compensated
bf16x2 one-hot product, exact to ~2^-16 (1.5e-5) relative per posting, so
keyed scores agree with them to atol 1e-4 (the reference's own
blocked-vs-base tolerance, tests/test_bm25_pallas.py, on scores below ~5)
plus rtol 1e-5 for the larger scores these gamma(2, 1.5) impacts reach
(up to ~40); the set of -1 keys must be identical.  The slot path and the
numpy oracle sum the same f32 products in another order: atol 1e-5.
Inputs are made with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modern_search_engines_project_tpu.retrieval import bm25_pallas as ref
from modern_search_engines_project_tpu.retrieval.device_index import (
    build_blocked_postings as ref_build_blocked,
)
from modern_search_engines_project_tpu_torch.retrieval import bm25_blocked as port
from modern_search_engines_project_tpu_torch.retrieval import bm25_slots
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    BlockedPostings,
    blocked_doc_offsets,
    build_blocked_postings,
    build_slot_postings,
    pack_blocked,
    pack_slot_classes,
)
from test_torch_bm25_slots import Recorder, meta, wide_batch

REF_ATOL = 1e-4
REF_RTOL = 1e-5
ATOL = 1e-5


def _random_csr(seed, n_docs=1000, n_terms=300, nnz=20000):
    """Zipf-like term-major CSR with gamma impacts; some impacts 0 (matched
    with score 0 stays admissible) and some negative (key to -1)."""
    rng = np.random.default_rng(seed)
    dfs = np.maximum((1.0 / np.arange(1, n_terms + 1)) ** 0.7 * nnz / 9, 1)
    dfs = np.minimum(dfs.astype(np.int64), n_docs)
    pairs = np.unique(
        np.repeat(np.arange(n_terms), dfs) * n_docs
        + rng.integers(0, n_docs, int(dfs.sum()))
    )
    terms, docs = pairs // n_docs, (pairs % n_docs).astype(np.int32)
    indptr = np.zeros(n_terms + 1, np.int64)
    np.cumsum(np.bincount(terms, minlength=n_terms), out=indptr[1:])
    impact = rng.gamma(2.0, 1.5, docs.size).astype(np.float32)
    impact[::97] = 0.0
    impact[::89] *= -1
    n_docs_pad = -(-n_docs // 128) * 128
    return (indptr, docs, impact, n_docs_pad), n_terms


@pytest.fixture(scope="module")
def built():
    csr, n_terms = _random_csr(3)
    arrays = build_blocked_postings(*csr)
    blk = pack_blocked(*arrays, "cpu")
    st, si, col_unperm = build_slot_postings(*csr)
    views_t, views_i, _ = pack_slot_classes(st, si, "cpu")
    slots = (views_t, views_i, torch.as_tensor(col_unperm))
    return csr, n_terms, arrays, blk, slots


def _queries(seed, B, T, n_terms):
    rng = np.random.default_rng(seed)
    tids = rng.integers(-1, n_terms, (B, T)).astype(np.int32)  # -1 = pad
    if B > 1:
        tids[1] = tids[0]  # shared terms across queries
    qtf = np.where(tids >= 0, rng.integers(1, 4, (B, T)), 0)
    return tids, qtf.astype(np.float32)


def _oracle(csr, tids, qtf):
    """numpy: per (query, doc) the qtf-weighted impact sum over the query's
    terms, keyed like the kernels (matched and >= 0, else -1)."""
    indptr, docs, impact, n_docs_pad = csr
    B = tids.shape[0]
    s = np.zeros((B, n_docs_pad), np.float64)
    c = np.zeros((B, n_docs_pad), np.int64)
    for b in range(B):
        for t, w in zip(tids[b], qtf[b]):
            if t < 0 or w <= 0:
                continue
            lo, hi = indptr[t], indptr[t + 1]
            np.add.at(s[b], docs[lo:hi], w * impact[lo:hi].astype(np.float64))
            np.add.at(c[b], docs[lo:hi], 1)
    keyed = np.where((c > 0) & (s >= 0), s, -1.0)
    return np.concatenate([keyed, np.full((B, 1), -1.0)], axis=1)


def _ref_blocked(arrays, n_docs_pad, tids, qtf):
    return np.asarray(
        ref.bm25_score_blocked(
            *map(jnp.asarray, arrays), jnp.asarray(tids), jnp.asarray(qtf),
            n_docs_pad=n_docs_pad, interpret=True,
        )
    )


def _assert_keyed_close(got, want, atol, rtol=0.0):
    got = np.asarray(got)
    np.testing.assert_array_equal(got < 0, want < 0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_layout_matches_reference(built):
    csr, _, arrays, _, _ = built
    for a, b in zip(arrays, ref_build_blocked(*csr)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("T", [4, 8, 16])
@pytest.mark.parametrize("B", [1, 8, 40])
def test_plain_kernel_matches_reference(built, B, T, dup):
    """``dup``: every query holds one term id in two of its slots, whose
    weights add up (the weight table of the CUDA kernel keeps one entry)."""
    csr, n_terms, arrays, blk, _ = built
    tids, qtf = _queries(B * 100 + T, B, T, n_terms)
    if dup:
        tids[:, 1] = tids[:, 0] = np.arange(B) % (n_terms - 1) + 1
        qtf[:, :2] = (2.0, 1.0)
    got = port.blocked_plain(
        blk, torch.as_tensor(tids), torch.as_tensor(qtf)
    )
    assert got.shape == (B, csr[3] + 1)
    want = _ref_blocked(arrays, csr[3], tids, qtf)
    _assert_keyed_close(got, want, REF_ATOL, REF_RTOL)
    assert (want >= 0).any() and (want == -1).any()


@pytest.mark.parametrize(
    "B,T,n_vocab", [(8, 4, 300), (8, 16, 300), (40, 8, 40), (40, 16, 300)]
)
def test_udedup_plain_matches_reference(built, B, T, n_vocab):
    """U below 128 (a shared 40-term vocabulary) and above (up to 512)."""
    csr, _, arrays, blk, _ = built
    tids, qtf = _queries(B + T + n_vocab, B, T, n_vocab)
    uids, w = bm25_slots.dedup_query_terms(tids, qtf)
    got = port.blocked_udedup_plain(
        blk, torch.as_tensor(uids), torch.as_tensor(w)
    )
    want = np.asarray(
        ref.bm25_score_blocked_udedup(
            *map(jnp.asarray, arrays), jnp.asarray(uids), jnp.asarray(w),
            n_docs_pad=csr[3], interpret=True,
        )
    )
    _assert_keyed_close(got, want, REF_ATOL, REF_RTOL)
    _assert_keyed_close(
        got, _ref_blocked(arrays, csr[3], tids, qtf), REF_ATOL, REF_RTOL
    )


def presence_apart(w, seed):
    """A copy of a U-dedup weight matrix whose presence rows [B, 2B) differ
    from weight > 0: some real (query, term) pairs keep their weight but
    lose presence, others get presence with weight 0."""
    w = w.copy()
    B = w.shape[0] // 2
    rng = np.random.default_rng(seed)
    pairs = np.argwhere(w[:B] > 0)
    pick = pairs[rng.random(len(pairs)) < 0.3]
    w[B + pick[:, 0], pick[:, 1]] = 0.0  # weighted, not present
    free = np.argwhere((w[:B] == 0) & (w[B:] == 0))
    pick = free[rng.random(len(free)) < 0.05]
    w[B + pick[:, 0], pick[:, 1]] = 1.0  # present with weight 0
    return w


def test_udedup_plain_reads_presence_rows(built):
    """Kernel 8 takes a posting's presence from rows [B, 2B) of w, as the
    TPU kernel does, not from its weight: with rows that disagree, the
    plain version still equals the reference, and its keys move."""
    csr, n_terms, arrays, blk, _ = built
    tids, qtf = _queries(77, 16, 8, n_terms)
    uids, w = bm25_slots.dedup_query_terms(tids, qtf)
    w2 = presence_apart(w, 5)
    got = port.blocked_udedup_plain(
        blk, torch.as_tensor(uids), torch.as_tensor(w2)
    )
    want = np.asarray(
        ref.bm25_score_blocked_udedup(
            *map(jnp.asarray, arrays), jnp.asarray(uids), jnp.asarray(w2),
            n_docs_pad=csr[3], interpret=True,
        )
    )
    _assert_keyed_close(got, want, REF_ATOL, REF_RTOL)
    same = port.blocked_udedup_plain(
        blk, torch.as_tensor(uids), torch.as_tensor(w)
    )
    assert not torch.equal(got < 0, same < 0)


@pytest.mark.parametrize("B,T", [(1, 4), (8, 8), (40, 16)])
def test_plain_matches_slot_path_and_oracle(built, B, T):
    """Both layouts give the same keyed scores, and so does numpy."""
    csr, n_terms, _, blk, (vt, vi, cu) = built
    tids, qtf = _queries(B * 7 + T, B, T, n_terms)
    t, q = torch.as_tensor(tids), torch.as_tensor(qtf)
    got = port.blocked_plain(blk, t, q)
    slot = bm25_slots._slots_key(bm25_slots.slots_plain(vt, vi, t, q), cu, B)
    _assert_keyed_close(got, slot.numpy(), ATOL)
    _assert_keyed_close(got, _oracle(csr, tids, qtf), ATOL)
    uids, w = bm25_slots.dedup_query_terms(tids, qtf)
    ud = port.blocked_udedup_plain(
        blk, torch.as_tensor(uids), torch.as_tensor(w)
    )
    _assert_keyed_close(ud, got.numpy(), ATOL)


def test_udedup_plain_takes_more_than_1024_terms():
    """U = 1152 distinct ids on the plain version of kernel 8, against
    kernel 7's plain version and the numpy oracle.  Up to 77 matched
    products a doc reach scores near 100, where f32 sums in another order
    differ by a few ulps (7.6e-6 each): rtol 1e-6 beside atol 1e-5."""
    csr, n_terms = _random_csr(5, n_docs=600, n_terms=3000, nnz=40000)
    blk = pack_blocked(*build_blocked_postings(*csr), "cpu")
    rng = np.random.default_rng(11)
    tids = np.stack(
        [rng.choice(n_terms, 80, replace=False) for _ in range(17)]
    ).astype(np.int32)
    tids[:, -3:] = -1
    qtf = np.where(tids >= 0, rng.integers(1, 4, tids.shape), 0).astype(
        np.float32
    )
    uids, w = bm25_slots.dedup_query_terms(tids, qtf)
    assert uids.size == 1152 and (uids >= 0).sum() > 1024
    ud = port.blocked_udedup_plain(
        blk, torch.as_tensor(uids), torch.as_tensor(w)
    )
    base = port.blocked_plain(
        blk, torch.as_tensor(tids), torch.as_tensor(qtf)
    )
    torch.testing.assert_close(ud, base, atol=ATOL, rtol=1e-6)
    oracle = _oracle(csr, tids, qtf)
    np.testing.assert_array_equal(base.numpy() < 0, oracle < 0)
    np.testing.assert_allclose(base.numpy(), oracle, atol=ATOL, rtol=1e-6)
    assert (oracle >= 0).any()


def _posting_order_oracle(blk, m, present):
    """numpy: each doc's products m * impact summed in f32 one posting at
    a time, in posting order; keyed like the kernels."""
    terms, impact, off = (x.numpy() for x in (blk.terms, blk.impact,
                                              blk.doc_off))
    B = m.shape[0]
    s = np.zeros((B, blk.n_blocks * 128), np.float32)
    c = np.zeros((B, blk.n_blocks * 128), np.int64)
    for b in range(B):
        for i in range(blk.n_blocks):
            for j in range(128):
                acc = np.float32(0.0)
                for p in range(off[i, j], off[i, j + 1]):
                    acc = np.float32(acc + np.float32(m[b, i, p] * impact[i, p]))
                    c[b, i * 128 + j] += present[b, i, p]
                s[b, i * 128 + j] = acc
    keyed = np.where((c > 0) & (s >= 0), s, np.float32(-1.0))
    return np.concatenate([keyed, np.full((B, 1), -1.0, np.float32)], axis=1)


@pytest.mark.parametrize("B,step_rows", [(1, 8), (5, 1), (7, 3)])
def test_reduce_sums_in_posting_order(built, B, step_rows):
    """The plain versions' reduction equals a numpy loop that sums each doc
    in posting order in f32, bit for bit (so it gives the same bits on
    every run, as the kernels do).  Weights: small integers, random f32
    and zeros, so a doc holds several nonzero products of mixed sign."""
    _, _, _, blk, _ = built
    rng = np.random.default_rng(B * 10 + step_rows)
    shape = (B,) + tuple(blk.terms.shape)
    m = np.where(rng.random(shape) < 0.3,
                 np.where(rng.random(shape) < 0.5,
                          rng.integers(1, 4, shape),
                          rng.standard_normal(shape) * 3), 0.0)
    m = m.astype(np.float32)
    present = (m != 0) | (rng.random(shape) < 0.05)
    m_t, p_t = torch.as_tensor(m), torch.as_tensor(present)
    # width chosen so that rows go step_rows at a time
    width = max(1, (1 << 24) // (step_rows * blk.p_blk))
    got = port._blocked_reduce(blk, B, width,
                               lambda rows: (m_t[:, rows], p_t[:, rows]))
    want = _posting_order_oracle(blk, m, present)
    assert (want >= 0).any() and (want == -1).any()
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_all_pad_query_keys_minus_one(built):
    """Query pads (-1) never match the posting pads (-1), and pads never
    add presence to doc 0 of their row."""
    _, _, _, blk, _ = built
    tids = torch.full((2, 4), -1, dtype=torch.int32)
    got = port.blocked_plain(blk, tids, torch.zeros(2, 4))
    assert torch.all(got == -1)
    uids = torch.full((128,), -2, dtype=torch.int32)
    got = port.blocked_udedup_plain(blk, uids, torch.zeros(4, 128))
    assert torch.all(got == -1)


def test_doc_offsets(built):
    """doc_off[i, j] is where doc j's run starts in row i (searchsorted on
    the real local ids); the last entry is the row's real count."""
    _, _, (terms, _, local), blk, _ = built
    off = blk.doc_off.numpy()
    for i in range(terms.shape[0]):
        n = int((terms[i] >= 0).sum())
        want = np.searchsorted(local[i, :n], np.arange(129), side="left")
        np.testing.assert_array_equal(off[i], want)
        assert off[i, 128] == n


def test_doc_offsets_refuse_malformed_rows(built):
    _, _, (terms, _, local), _, _ = built
    bad = local.copy()
    bad[0, 0] = 127  # the row's first posting now sorts after the others
    with pytest.raises(ValueError):
        blocked_doc_offsets(terms, bad)
    bad = local.copy()
    bad[0, int((terms[0] >= 0).sum()) - 1] = 128  # beyond the block
    with pytest.raises(ValueError):
        blocked_doc_offsets(terms, bad)
    gap = terms.copy()
    gap[0, 0] = -1  # a pad before a real posting
    with pytest.raises(ValueError):
        blocked_doc_offsets(gap, local)


def test_empty_layout():
    """No postings at all: one row of pads, every key -1."""
    t, i, loc = build_blocked_postings(
        np.zeros(4, np.int64), np.zeros(0, np.int32), np.zeros(0, np.float32),
        128,
    )
    assert t.shape == (1, 2048) and (t == -1).all()
    blk = pack_blocked(t, i, loc, "cpu")
    assert blk.doc_off.numpy().sum() == 0
    got = port.bm25_score_blocked(
        blk, torch.tensor([[3, -1]], dtype=torch.int32), torch.ones(1, 2)
    )
    assert got.shape == (1, 129) and torch.all(got == -1)


def test_udedup_gate_matches_reference_engine():
    """The reference engine's inline gate: 4 * u_pad <= B * T."""
    for u_pad, B, T in [(128, 64, 8), (256, 64, 8), (128, 16, 8), (128, 32, 16),
                        (512, 64, 16), (1024, 64, 16)]:
        assert port.blocked_udedup_gate(u_pad, B, T) == (4 * u_pad <= B * T)
    assert port.blocked_udedup_gate(128, 64, 8)
    assert not port.blocked_udedup_gate(128, 1, 16)


def test_wrappers_take_plain_versions_on_cpu(built):
    """CPU tensors go to the plain versions and launch nothing."""
    _, n_terms, _, blk, _ = built
    tids, qtf = _queries(9, 8, 4, n_terms)
    t, q = torch.as_tensor(tids), torch.as_tensor(qtf)
    uids, w = bm25_slots.dedup_query_terms(tids, qtf)
    u, wt = torch.as_tensor(uids), torch.as_tensor(w)
    kernels = (port.BLOCKED_KERNEL, port.BLOCKED_UDEDUP_KERNEL)
    counts = [k.launches for k in kernels]
    assert torch.equal(
        port.bm25_score_blocked(blk, t, q),
        port.blocked_plain(blk, t, q),
    )
    assert torch.equal(
        port.bm25_score_blocked_udedup(blk, u, wt),
        port.blocked_udedup_plain(blk, u, wt),
    )
    assert counts == [k.launches for k in kernels]


# ---- launch arguments for any U and any T (see test_torch_bm25_slots) ----


def _meta_blocked(blk):
    return BlockedPostings(*(meta(t) for t in (
        blk.terms, blk.impact, blk.doc_off)))


def test_blocked_wrappers_pass_any_u_and_any_t(built, monkeypatch):
    """T = 80 term slots reach kernel 7, and U = 1152 distinct ids reach
    kernel 8 with a device-memory uid table of 2 * 4096 int32 (2^12 >= 2U,
    csrc/uid_table.cuh) and a packed weight table of U x 32 int32 (17
    queries rounded up to 32)."""
    _, _, _, blk, _ = built
    rec = Recorder(monkeypatch, port.BLOCKED_KERNEL, port.BLOCKED_UDEDUP_KERNEL)
    tids, qtf, uids, w = wide_batch()
    mb = _meta_blocked(blk)
    out = port.bm25_score_blocked(mb, meta(tids), meta(qtf))
    assert out.shape == (17, blk.n_docs_pad + 1)
    name, args = rec.calls[-1]
    assert name == "bm25_blocked" and args[7:9] == (17, 80)
    out = port.bm25_score_blocked_udedup(mb, meta(uids), meta(w))
    name, args = rec.calls[-1]
    assert name == "bm25_blocked_udedup" and args[6] == 1152
    assert args[-3] == 1152 * 32  # packed weights length
    assert args[-1] == 2 * 4096  # table length
