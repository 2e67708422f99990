"""Kernels of the torch port against their plain versions, on the card.

Every test here is marked ``gpu`` and skips (inside the ``cuda`` fixture)
where no CUDA device is present.  On a machine with an H100:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's shared conftest imports jax, which this file
does not need.)  Inputs are made with numpy from fixed seeds.

Tolerances: the BM25 kernels sum at most T nonzero f32 products per doc in
another order than the plain version, so keyed scores agree to 1e-5; the
blocked kernels sum in the slot kernels' order, so the two layouts agree
to 1e-5 too.  The
stats kernel and its plain version read the same bf16 bank and query and
sum 768 f32 products in different orders; sims agree to ~1e-6, checked at
1e-4 (slots are compared by the sim they point at, since near-equal sims
may pick different slots).
"""

import numpy as np
import pytest
import torch

from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import Document, IndexBuilder
from modern_search_engines_project_tpu_torch.models import (
    EncoderConfig,
    HashingEncoder,
    TorchEncoder,
    init_reference_params,
)
from modern_search_engines_project_tpu_torch.retrieval import cuda_lib
from modern_search_engines_project_tpu_torch.retrieval.bm25_blocked import (
    BLOCKED_KERNEL,
    BLOCKED_UDEDUP_KERNEL,
    blocked_plain,
    blocked_udedup_plain,
    blocked_udedup_gate,
    bm25_score_blocked,
    bm25_score_blocked_udedup,
)
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    SLOTS_KERNEL,
    UDEDUP_KERNELS,
    _slots_key,
    dedup_query_terms,
    slots_keyed,
    slots_plain,
    slots_udedup_keyed,
    slots_udedup_plain,
    u_pad_for,
)
from modern_search_engines_project_tpu_torch.retrieval.dense_stats import (
    STATS_KERNEL,
    bucket_sims,
    bucket_stats,
    stats_max_abs_err,
    stats_plain,
)
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    build_blocked_postings,
    build_slot_postings,
    pack_blocked,
    pack_slot_classes,
)
from modern_search_engines_project_tpu_torch.retrieval.engine import SearchEngine

pytestmark = pytest.mark.gpu

BM25_ATOL = 1e-5
STATS_ATOL = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products reduce in f32, as the reference's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", torch.cuda.current_device())


def _random_csr(seed, n_docs=3000, n_terms=400, nnz=60000):
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
    impact[::97] = 0.0  # matched with score 0 stays admissible
    impact[::89] *= -1  # negative scores key to -1
    n_docs_pad = -(-n_docs // 128) * 128
    return (indptr, docs, impact, n_docs_pad), n_terms, rng


def _random_slots(seed, **kw):
    csr, n_terms, rng = _random_csr(seed, **kw)
    st, si, _ = build_slot_postings(*csr)
    return st, si, n_terms, rng


@pytest.fixture(scope="module")
def slots(cuda):
    st, si, n_terms, rng = _random_slots(0)
    views_t, views_i, stream = pack_slot_classes(st, si, cuda)
    return views_t, views_i, stream, n_terms, rng


@pytest.fixture(scope="module")
def both_layouts(cuda):
    """One random corpus (12k docs, 300k postings) in both layouts."""
    csr, n_terms, rng = _random_csr(7, n_docs=12000, n_terms=3000, nnz=300000)
    st, si, col_unperm = build_slot_postings(*csr)
    views_t, views_i, stream = pack_slot_classes(st, si, cuda)
    blk = pack_blocked(*build_blocked_postings(*csr), cuda)
    cu = torch.as_tensor(col_unperm, device=cuda)
    return (views_t, views_i, stream, cu), blk, n_terms, rng


def _queries(rng, B, T, n_terms):
    tids = rng.integers(-1, n_terms, (B, T)).astype(np.int32)
    qtf = np.where(tids >= 0, rng.integers(1, 4, (B, T)), 0)
    return tids, qtf.astype(np.float32)


def test_library_builds(cuda):
    cuda_lib.load()
    assert cuda_lib.library_path().exists()
    print(cuda_lib.build_log())


@pytest.mark.parametrize("B,T", [(1, 4), (5, 8), (16, 16), (64, 8)])
def test_slots_kernel_matches_plain(slots, cuda, B, T):
    views_t, views_i, stream, n_terms, rng = slots
    tids, qtf = _queries(rng, B, T, n_terms)
    tids_t = torch.as_tensor(tids, device=cuda)
    qtf_t = torch.as_tensor(qtf, device=cuda)
    before = SLOTS_KERNEL.launches
    got = slots_keyed(stream, views_t, views_i, tids_t, qtf_t)
    torch.cuda.synchronize()
    assert SLOTS_KERNEL.launches == before + 1
    want = slots_plain(views_t, views_i, tids_t, qtf_t)
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)
    assert (got >= 0).any() and (got == -1).any()


@pytest.mark.parametrize("variant", ["sublane", "i8"])
@pytest.mark.parametrize("B,T", [(8, 4), (16, 8), (64, 16)])
def test_udedup_kernels_match_plain(slots, cuda, variant, B, T):
    views_t, views_i, stream, n_terms, rng = slots
    tids, qtf = _queries(rng, B, T, n_terms)
    uids, w = dedup_query_terms(tids, qtf)
    uids_t = torch.as_tensor(uids, device=cuda)
    w_t = torch.as_tensor(w, device=cuda)
    got = slots_udedup_keyed(stream, views_t, views_i, uids_t, w_t, variant)
    want = slots_udedup_plain(views_t, views_i, uids_t, w_t, variant)
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)
    # both U-dedup kernels and the plain kernel give the same keyed scores
    plain = slots_keyed(
        stream, views_t, views_i,
        torch.as_tensor(tids, device=cuda), torch.as_tensor(qtf, device=cuda),
    )
    torch.testing.assert_close(got, plain, atol=BM25_ATOL, rtol=0)


def test_udedup_kernel_takes_unsorted_uids(slots, cuda):
    views_t, views_i, stream, n_terms, rng = slots
    tids, qtf = _queries(rng, 16, 8, n_terms)
    uids, w = dedup_query_terms(tids, qtf)
    perm = rng.permutation(uids.size)
    uids_t = torch.as_tensor(uids[perm], device=cuda)
    w_t = torch.as_tensor(np.ascontiguousarray(w[:, perm]), device=cuda)
    got = slots_udedup_keyed(stream, views_t, views_i, uids_t, w_t, "sublane")
    want = slots_udedup_plain(views_t, views_i, uids_t, w_t, "sublane")
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)


# (n, cnt, dim) of the stats kernel's edges: one doc, a doc tile of 64
# and one doc either side of it, n = 1 / 2 / 7 / 10, dims 32 / 64 / 96 /
# 768; buckets of 8,500+ docs, which take the 64-doc blocks (the smaller
# ones take 16-doc blocks that split each stage's dims over 4 warps); and
# dims whose query tile does not fit shared memory (the queries are then
# read from device memory), on both block shapes
STATS_SHAPES = [
    (1, 1, 32), (1, 100, 64), (2, 63, 64), (2, 8, 96), (7, 64, 768),
    (10, 65, 32), (3, 1000, 768), (10, 257, 768), (10, 1000, 64),
    (1, 8500, 768), (2, 8500, 96), (3, 9000, 32),
    (2, 70, 16384), (1, 8500, 12288),
]


@pytest.mark.parametrize("B", [1, 5, 8, 9, 17, 33, 64, 65])
@pytest.mark.parametrize("n,cnt,dim", STATS_SHAPES)
def test_stats_kernel_matches_plain(cuda, n, cnt, B, dim):
    """Kernel 4 against its plain version (slots by value, 1e-4), on a bank
    whose slot 1 repeats slot 0 for a third of the docs: there the sims
    are equal bit for bit, so the tie must keep the lowest slot exactly
    (w1 never 1; where w1 is 0, the duplicate is v2 at slot 1)."""
    rng = np.random.default_rng(n * 1000 + cnt + dim)
    # sims of the size the 1e-4 is stated for (768 standard normal
    # products): wider banks are scaled down to the same spread
    e = rng.standard_normal((n, cnt, dim)).astype(np.float32)
    e *= min(1.0, (768 / dim) ** 0.5)
    dup = np.zeros(cnt, bool)
    if n > 1:
        dup[: max(cnt // 3, 1)] = True
        e[1, dup] = e[0, dup]  # exact ties between slots
    emb = torch.as_tensor(e, device=cuda).to(torch.bfloat16)
    q = torch.as_tensor(rng.standard_normal((B, dim)), device=cuda).float()
    before = STATS_KERNEL.launches
    got = bucket_stats(emb, q)
    torch.cuda.synchronize()
    assert STATS_KERNEL.launches == before + 1
    want = stats_plain(emb, q)
    assert stats_max_abs_err(got, want, bucket_sims(emb, q)) <= STATS_ATOL
    if n > 1:
        v1, v2, w1, w2, _ = (x[:, torch.as_tensor(dup, device=cuda)]
                             for x in got)
        assert not (w1 == 1).any()
        first = w1 == 0
        assert (w2[first] == 1).all() and torch.equal(v2[first], v1[first])


def _blocked_queries(rng, B, T, n_terms):
    """Random queries with the cases kernel 7's table must get right: query
    0 holds one term id in two slots (its weight is the sum), query 1
    shares half its terms with query 0, and query 2 is all pads."""
    tids, qtf = _queries(rng, B, T, n_terms)
    tids[0, 0] = tids[0, 1] = 1 + rng.integers(n_terms - 1)
    qtf[0, :2] = (2.0, 3.0)
    if B > 1:
        tids[1, : T // 2] = tids[0, : T // 2]
        qtf[1, : T // 2] = np.where(tids[1, : T // 2] >= 0, 1.0, 0.0)
    if B > 2:
        tids[2], qtf[2] = -1, 0.0
    return tids, qtf


@pytest.mark.parametrize(
    "B,T",
    [(1, 4), (1, 8), (16, 8), (40, 16), (64, 8), (31, 8), (33, 8), (1, 40),
     (31, 40), (33, 40), (64, 40)],
)
def test_blocked_kernel_matches_plain_and_slots(both_layouts, cuda, B, T):
    """Kernel 7 against its plain version (1e-5) and, bit for bit, against
    slot kernel 1: both sum each doc's matched products in posting order
    with m summed in t order.  T = 40 at B >= 26 holds more term slots
    than kernel 7's shared-memory table (32 x 40 > 1024): the tables are
    built in device memory."""
    (vt, vi, stream, cu), blk, n_terms, rng = both_layouts
    tids, qtf = _blocked_queries(rng, B, T, n_terms)
    t = torch.as_tensor(tids, device=cuda)
    q = torch.as_tensor(qtf, device=cuda)
    before = BLOCKED_KERNEL.launches
    got = bm25_score_blocked(blk, t, q)
    torch.cuda.synchronize()
    assert BLOCKED_KERNEL.launches == before + 1
    want = blocked_plain(blk, t, q)
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)
    assert torch.equal(got < 0, want < 0)
    slot = _slots_key(slots_keyed(stream, vt, vi, t, q), cu, B)
    assert torch.equal(got, slot)
    assert (got >= 0).any() and (got == -1).any()
    if B > 2:
        assert (got[2] == -1).all()  # the all-pad query matches nothing


@pytest.mark.parametrize("B,T", [(16, 8), (64, 40)])
def test_blocked_plain_versions_repeat_their_bits(both_layouts, cuda, B, T):
    """The yardsticks of kernels 7 and 8 sum each doc in posting order, so
    five runs on one batch give the same bits (an ``index_add_`` of all
    products at once changed its order from run to run on the card)."""
    _, blk, n_terms, _ = both_layouts
    tids, qtf = _blocked_queries(np.random.default_rng(B), B, T, n_terms)
    t = torch.as_tensor(tids, device=cuda)
    q = torch.as_tensor(qtf, device=cuda)
    uids, w = dedup_query_terms(tids, qtf)
    u = torch.as_tensor(uids, device=cuda)
    wt = torch.as_tensor(w, device=cuda)
    for plain, args in ((blocked_plain, (t, q)),
                        (blocked_udedup_plain, (u, wt))):
        first = plain(blk, *args)
        assert (first >= 0).any()
        for _ in range(4):
            assert torch.equal(plain(blk, *args).view(torch.int32),
                               first.view(torch.int32))


@pytest.mark.parametrize("B,T", [(8, 4), (16, 8), (40, 16), (64, 16)])
def test_blocked_udedup_kernel_matches_plain(both_layouts, cuda, B, T):
    (vt, vi, stream, cu), blk, n_terms, rng = both_layouts
    tids, qtf = _queries(rng, B, T, n_terms)
    uids, w = dedup_query_terms(tids, qtf)
    u = torch.as_tensor(uids, device=cuda)
    wt = torch.as_tensor(w, device=cuda)
    before = BLOCKED_UDEDUP_KERNEL.launches
    got = bm25_score_blocked_udedup(blk, u, wt)
    torch.cuda.synchronize()
    assert BLOCKED_UDEDUP_KERNEL.launches == before + 1
    want = blocked_udedup_plain(blk, u, wt)
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)
    plain = bm25_score_blocked(
        blk, torch.as_tensor(tids, device=cuda),
        torch.as_tensor(qtf, device=cuda),
    )
    torch.testing.assert_close(got, plain, atol=BM25_ATOL, rtol=0)


def _presence_apart(w, seed):
    """A copy of w whose presence rows [B, 2B) differ from weight > 0 (as
    in test_torch_bm25_blocked, which imports jax, so it is not shared)."""
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


def test_blocked_udedup_kernel_reads_presence_rows(both_layouts, cuda):
    """Presence rows [B, 2B) of w that differ from weight > 0: the kernel
    follows them as its plain version (and the TPU kernel) does."""
    _, blk, n_terms, rng = both_layouts
    tids, qtf = _queries(rng, 16, 8, n_terms)
    uids, w = dedup_query_terms(tids, qtf)
    u = torch.as_tensor(uids, device=cuda)
    wt = torch.as_tensor(_presence_apart(w, 5), device=cuda)
    got = bm25_score_blocked_udedup(blk, u, wt)
    want = blocked_udedup_plain(blk, u, wt)
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)
    assert torch.equal(got < 0, want < 0)
    base = bm25_score_blocked_udedup(blk, u, torch.as_tensor(w, device=cuda))
    assert not torch.equal(got < 0, base < 0)


def test_blocked_udedup_takes_unsorted_uids(both_layouts, cuda):
    _, blk, n_terms, rng = both_layouts
    tids, qtf = _queries(rng, 16, 8, n_terms)
    uids, w = dedup_query_terms(tids, qtf)
    perm = rng.permutation(uids.size)
    u = torch.as_tensor(uids[perm], device=cuda)
    wt = torch.as_tensor(np.ascontiguousarray(w[:, perm]), device=cuda)
    got = bm25_score_blocked_udedup(blk, u, wt)
    want = blocked_udedup_plain(blk, u, wt)
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)


def _wide_queries(rng, B, T, n_terms):
    """B queries of T distinct real terms each, spread over the vocabulary
    so the batch holds more than 1024 distinct ids."""
    tids = np.stack(
        [rng.choice(n_terms, T, replace=False) for _ in range(B)]
    ).astype(np.int32)
    tids[:, -3:] = -1  # a few pads too
    qtf = np.where(tids >= 0, rng.integers(1, 4, tids.shape), 0)
    return tids, qtf.astype(np.float32)


WIDE_TOL = dict(atol=BM25_ATOL, rtol=1e-6)


def test_any_u_and_any_t(both_layouts, cuda):
    """U = 1152 distinct ids (above the shared-memory table) on kernels 2,
    3 and 8, and T = 80 term slots (above the shared-memory query table)
    on kernels 1 and 7, each against its plain version.  With 77 terms a
    query a doc sums up to 77 matched products and scores reach ~100,
    where one f32 ulp is 7.6e-6: sums taken in another order differ by a
    few ulps, hence rtol 1e-6 beside the 1e-5 of the other tests."""
    (vt, vi, stream, cu), blk, n_terms, _ = both_layouts
    tids, qtf = _wide_queries(np.random.default_rng(11), 17, 80, n_terms)
    uids, w = dedup_query_terms(tids, qtf)
    real = int((uids >= 0).sum())
    assert uids.size == 1152 and real > 1024
    t = torch.as_tensor(tids, device=cuda)
    q = torch.as_tensor(qtf, device=cuda)
    u = torch.as_tensor(uids, device=cuda)
    wt = torch.as_tensor(w, device=cuda)
    base = slots_plain(vt, vi, t, q)
    torch.testing.assert_close(
        slots_keyed(stream, vt, vi, t, q), base, **WIDE_TOL
    )
    for variant in ("sublane", "i8"):
        got = slots_udedup_keyed(stream, vt, vi, u, wt, variant)
        torch.testing.assert_close(
            got, slots_udedup_plain(vt, vi, u, wt, variant),
            **WIDE_TOL,
        )
        torch.testing.assert_close(got, base, **WIDE_TOL)
    bplain = blocked_plain(blk, t, q)
    torch.testing.assert_close(
        bm25_score_blocked(blk, t, q), bplain, **WIDE_TOL
    )
    got8 = bm25_score_blocked_udedup(blk, u, wt)
    torch.testing.assert_close(
        got8, blocked_udedup_plain(blk, u, wt),
        **WIDE_TOL,
    )
    torch.testing.assert_close(got8, bplain, **WIDE_TOL)
    assert (bplain >= 0).any()


# ---- kernels 5 ("acc") and 6 ("wide", "wide_i8"): tensor-core products ----

# what each tensor-core variant equals bit for bit: the lookup kernel with
# the same weight cast ("acc" sums in another order, so it has none)
SAME_AS = {"wide": "sublane", "wide_i8": "i8"}


@pytest.mark.parametrize("variant", ["acc", "wide", "wide_i8"])
@pytest.mark.parametrize("B,T", [(1, 4), (8, 4), (16, 8), (64, 16), (70, 8)])
def test_mma_udedup_kernels_match_plain(slots, cuda, variant, B, T):
    """Kernels 5 and 6 against their plain versions (1e-5); kernel 6 also
    against kernel 2 or 3 on the card, bit for bit.  B = 70 takes two
    query chunks of the grid, the second padded."""
    views_t, views_i, stream, n_terms, rng = slots
    tids, qtf = _queries(rng, B, T, n_terms)
    uids, w = dedup_query_terms(tids, qtf)
    u = torch.as_tensor(uids, device=cuda)
    wt = torch.as_tensor(w, device=cuda)
    before = UDEDUP_KERNELS[variant].launches
    got = slots_udedup_keyed(stream, views_t, views_i, u, wt, variant)
    assert UDEDUP_KERNELS[variant].launches == before + 1
    want = slots_udedup_plain(views_t, views_i, u, wt, variant)
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)
    assert torch.equal(got < 0, want < 0)
    if variant in SAME_AS:
        lookup = slots_udedup_keyed(stream, views_t, views_i, u, wt,
                                    SAME_AS[variant])
        assert torch.equal(got, lookup)


def test_acc_kernel_reads_presence_rows(slots, cuda):
    """Kernel 5 takes presence from the rows w[B:2B], as the TPU kernel
    does: a doc matching only terms present with weight 0 keys to 0 under
    "acc" and to -1 under the variants that derive presence from the
    weight."""
    views_t, views_i, stream, n_terms, rng = slots
    tids, qtf = _queries(rng, 16, 8, n_terms)
    uids, w = dedup_query_terms(tids, qtf)
    u = torch.as_tensor(uids, device=cuda)
    wt = torch.as_tensor(_presence_apart(w, 6), device=cuda)
    got = slots_udedup_keyed(stream, views_t, views_i, u, wt, "acc")
    want = slots_udedup_plain(views_t, views_i, u, wt, "acc")
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)
    assert torch.equal(got < 0, want < 0)
    base = slots_udedup_keyed(stream, views_t, views_i, u,
                              torch.as_tensor(w, device=cuda), "acc")
    assert not torch.equal(got < 0, base < 0)
    wide = slots_udedup_keyed(stream, views_t, views_i, u, wt, "wide")
    zero_only = (got == 0) & (wide == -1)
    assert zero_only.any()


def test_mma_kernels_any_u(both_layouts, cuda):
    """Kernels 5 and 6 at U = 1152 (device-memory uid table; kernel 6's A
    fragments of 17 queries in shared memory, kernel 5's read from device
    memory) and at U = 2048 (the bf16 A fragments of 40 queries read from
    device memory) against their plain versions, with the tolerance of
    test_any_u_and_any_t."""
    (vt, vi, stream, cu), _, n_terms, _ = both_layouts
    for B, T, n_u in ((17, 80, 1152), (40, 80, 2048)):
        tids, qtf = _wide_queries(np.random.default_rng(11), B, T, n_terms)
        uids, w = dedup_query_terms(tids, qtf)
        assert uids.size == n_u
        u = torch.as_tensor(uids, device=cuda)
        wt = torch.as_tensor(w, device=cuda)
        for variant in ("acc", "wide", "wide_i8"):
            got = slots_udedup_keyed(stream, vt, vi, u, wt, variant)
            want = slots_udedup_plain(vt, vi, u, wt, variant)
            torch.testing.assert_close(got, want, **WIDE_TOL)
            assert torch.equal(got < 0, want < 0)
            assert (want >= 0).any()
            if variant in SAME_AS:
                assert torch.equal(got, slots_udedup_keyed(
                    stream, vt, vi, u, wt, SAME_AS[variant]))


# ---- kernels 1-3: streaming design, any depth, any B, T and U --------------

# Group depths of the streaming slot kernels' edges: they stage 16 rows at
# a time in 8-row boxes, so one group of 8 rows (under one stage), one of
# exactly one stage, one and a half stages, and deep groups ending on a
# half stage.
DEPTHS = (8, 16, 24, 40, 56, 72, 120, 136)


@pytest.fixture(scope="module")
def deep(cuda):
    """8 groups of 512 docs at DEPTHS rows (each doc 0..depth postings of a
    Zipf vocabulary of 400 terms; zero and negative impacts) in the slot
    layout (strides set to DEPTHS) and the blocked layout."""
    rng = np.random.default_rng(3)
    n_terms, n_docs = 400, 512 * len(DEPTHS)
    p = 1.0 / np.arange(1, n_terms + 1) ** 0.8
    p /= p.sum()
    pairs = []
    for d in range(n_docs):
        k = int(rng.integers(0, DEPTHS[d // 512] + 1))
        pairs.append(rng.choice(n_terms, k, replace=False, p=p) * n_docs + d)
    pairs = np.sort(np.concatenate(pairs))
    terms, docs = pairs // n_docs, (pairs % n_docs).astype(np.int32)
    indptr = np.zeros(n_terms + 1, np.int64)
    np.cumsum(np.bincount(terms, minlength=n_terms), out=indptr[1:])
    impact = rng.gamma(2.0, 1.5, docs.size).astype(np.float32)
    impact[::97] = 0.0
    impact[::89] *= -1
    csr = (indptr, docs, impact, n_docs)
    st, si, col_unperm = build_slot_postings(
        *csr, S_g=np.asarray(DEPTHS, np.int64)
    )
    vt, vi, stream = pack_slot_classes(st, si, cuda)
    assert sorted(stream.group_rows.tolist()) == sorted(DEPTHS)
    blk = pack_blocked(*build_blocked_postings(*csr), cuda)
    cu = torch.as_tensor(col_unperm, device=cuda)
    return (vt, vi, stream, cu), blk, n_terms, rng


def _streaming_case(deep, cuda, tids, qtf, perm_seed, tol):
    """Kernels 1-3 against their plain versions (keys equal), kernel 1
    against kernel 7 and kernels 2-3 against kernel 6, bit for bit; the
    U-dedup kernels get their uids in a shuffled order."""
    (vt, vi, stream, cu), blk, _, _ = deep
    B = tids.shape[0]
    t = torch.as_tensor(tids, device=cuda)
    q = torch.as_tensor(qtf, device=cuda)
    before = SLOTS_KERNEL.launches
    got1 = slots_keyed(stream, vt, vi, t, q)
    torch.cuda.synchronize()
    assert SLOTS_KERNEL.launches == before + 1
    want1 = slots_plain(vt, vi, t, q)
    torch.testing.assert_close(got1, want1, **tol)
    assert torch.equal(got1 < 0, want1 < 0)
    assert torch.equal(bm25_score_blocked(blk, t, q), _slots_key(got1, cu, B))
    uids, w = dedup_query_terms(tids, qtf)
    perm = np.random.default_rng(perm_seed).permutation(uids.size)
    u = torch.as_tensor(uids[perm], device=cuda)
    wt = torch.as_tensor(np.ascontiguousarray(w[:, perm]), device=cuda)
    for variant, same in (("sublane", "wide"), ("i8", "wide_i8")):
        before = UDEDUP_KERNELS[variant].launches
        got = slots_udedup_keyed(stream, vt, vi, u, wt, variant)
        torch.cuda.synchronize()
        assert UDEDUP_KERNELS[variant].launches == before + 1
        want = slots_udedup_plain(vt, vi, u, wt, variant)
        torch.testing.assert_close(got, want, **tol)
        assert torch.equal(got < 0, want < 0)
        torch.testing.assert_close(got, got1, **tol)
        assert torch.equal(
            got, slots_udedup_keyed(stream, vt, vi, u, wt, same)
        )
    assert (want1 >= 0).any() and (want1 == -1).any()
    return want1


@pytest.mark.parametrize("B", [1, 7, 8, 16, 33, 64, 65, 128])
def test_streaming_slot_kernels_any_depth_and_batch(deep, cuda, B):
    """Groups of 8-136 rows (not all whole stages), one query chunk or
    several (kernel 1: 16 queries a block; kernels 2-3: 16, or 64 above
    B = 16), with a repeated term (query 0), shared terms (query 1), an
    all-pad query (query 2) and negative impacts.  A column sums up to 136
    matched products and scores pass 100, where one f32 ulp is 7.6e-6:
    the plain version sums the rows in another order, hence WIDE_TOL."""
    _, _, n_terms, rng = deep
    tids, qtf = _blocked_queries(rng, B, 8, n_terms)
    want = _streaming_case(deep, cuda, tids, qtf, B, WIDE_TOL)
    if B > 2:
        assert (want[2] == -1).all()


@pytest.mark.parametrize("B,T", [(1, 64), (1, 80), (16, 64), (17, 80),
                                 (65, 80)])
def test_streaming_slot_kernels_any_t(deep, cuda, B, T):
    """T = 64 term slots a query (kernel 1's last shared-memory table) and
    T = 80 (its device-memory query tables, one per 16-query chunk); the
    U-dedup kernels on the same batches, at U up to 1152."""
    _, _, n_terms, rng = deep
    tids, qtf = _blocked_queries(rng, B, T, n_terms)
    _streaming_case(deep, cuda, tids, qtf, T, WIDE_TOL)


@pytest.mark.parametrize("B,T,n_u", [(14, 76, 1024), (20, 54, 1024),
                                     (17, 80, 1152), (40, 80, 2048)])
def test_streaming_udedup_kernels_any_u(both_layouts, cuda, B, T, n_u):
    """U = 1024 distinct ids (the last shared-memory uid table, 2^11
    slots; at B = 20 the bf16 weights of 64-query chunks do not fit shared
    memory, so kernel 2 takes 16-query chunks) and above (the device-memory
    uid table, weights read from w) on kernels 2-3, and kernel 1 at
    T = 54-80, on the 12k-doc corpus, held as _streaming_case holds
    them."""
    n_terms = both_layouts[2]
    tids, qtf = _wide_queries(np.random.default_rng(11), B, T, n_terms)
    assert dedup_query_terms(tids, qtf)[0].size == n_u
    _streaming_case(both_layouts, cuda, tids, qtf, n_u, WIDE_TOL)


# ---- kernels 5 and 8: streaming designs, any depth, any B and U ------------


@pytest.fixture(scope="module")
def edges(cuda):
    """6 rows of 128 docs over a 3,000-term Zipf vocabulary in both layouts:
    rows 1 and 4 hold no real posting; the other docs hold 0-200 postings
    and doc 2 holds 2,500 (its run spans two of kernel 8's 2,048-posting
    stages, its slot group is 2,500 rows deep); every posting of doc 3 has
    impact 0, so a doc that matches scores exactly 0."""
    rng = np.random.default_rng(9)
    n_terms, n_docs = 3000, 768
    p = 1.0 / np.arange(1, n_terms + 1) ** 0.8
    p /= p.sum()
    pairs = []
    for d in range(n_docs):
        if d // 128 in (1, 4):
            continue
        k = {2: 2500, 3: 60}.get(d, int(rng.integers(0, 201)))
        pairs.append(rng.choice(n_terms, k, replace=False, p=p) * n_docs + d)
    pairs = np.sort(np.concatenate(pairs))
    terms, docs = pairs // n_docs, (pairs % n_docs).astype(np.int32)
    indptr = np.zeros(n_terms + 1, np.int64)
    np.cumsum(np.bincount(terms, minlength=n_terms), out=indptr[1:])
    impact = rng.gamma(2.0, 1.5, docs.size).astype(np.float32)
    impact[::89] *= -1
    impact[docs == 3] = 0.0
    csr = (indptr, docs, impact, n_docs)
    st, si, col_unperm = build_slot_postings(*csr)
    vt, vi, stream = pack_slot_classes(st, si, cuda)
    blk = pack_blocked(*build_blocked_postings(*csr), cuda)
    assert blk.doc_off[[1, 4], -1].tolist() == [0, 0]
    cu = torch.as_tensor(col_unperm, device=cuda)
    doc3 = terms[docs == 3].astype(np.int32)
    return (vt, vi, stream, cu), blk, n_terms, rng, doc3


def _edge_queries(edges, B, T):
    """B queries of T terms from the 300 most frequent (docs of 100-2,500
    postings match many), query 0 holding a term of doc 3."""
    _, _, _, rng, doc3 = edges
    tids, qtf = _queries(rng, B, T, 300)
    tids[0, 0], qtf[0, 0] = doc3[0], 1.0
    return tids, qtf


def _udedup_inputs(cuda, tids, qtf, perm_seed=None):
    uids, w = dedup_query_terms(tids, qtf)
    if perm_seed is not None:  # the kernels take the ids in any order
        perm = np.random.default_rng(perm_seed).permutation(uids.size)
        uids, w = uids[perm], np.ascontiguousarray(w[:, perm])
    return torch.as_tensor(uids, device=cuda), torch.as_tensor(w, device=cuda)


def _acc_case(layout, cuda, u, wt):
    """Kernel 5 against its plain version (WIDE_TOL: its split product sums
    in another order), keys equal, one launch."""
    (vt, vi, stream, _), *_ = layout
    before = UDEDUP_KERNELS["acc"].launches
    got = slots_udedup_keyed(stream, vt, vi, u, wt, "acc")
    torch.cuda.synchronize()
    assert UDEDUP_KERNELS["acc"].launches == before + 1
    want = slots_udedup_plain(vt, vi, u, wt, "acc")
    torch.testing.assert_close(got, want, **WIDE_TOL)
    assert torch.equal(got < 0, want < 0)
    assert (want >= 0).any() and (want == -1).any()
    return got, want


def _blocked_udedup_case(layout, cuda, u, wt, tol):
    """Kernel 8 against its plain version (keys equal, one launch) and, bit
    for bit, against slot kernel 2 on the same (uids, w): both sum each
    doc's matched products bf16(w) * impact in posting order, and presence
    from the rows w[B:2B] is weight > 0 for these batches."""
    (vt, vi, stream, cu), blk, *_ = layout
    B = wt.shape[0] // 2
    before = BLOCKED_UDEDUP_KERNEL.launches
    got = bm25_score_blocked_udedup(blk, u, wt)
    torch.cuda.synchronize()
    assert BLOCKED_UDEDUP_KERNEL.launches == before + 1
    want = blocked_udedup_plain(blk, u, wt)
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(got < 0, want < 0)
    slot = _slots_key(slots_udedup_keyed(stream, vt, vi, u, wt, "sublane"),
                      cu, B)
    assert torch.equal(got, slot)
    assert (want >= 0).any() and (want == -1).any()
    return got, want


@pytest.mark.parametrize("B", [1, 7, 16, 17, 33, 64, 65, 128])
def test_acc_kernel_any_depth_and_batch(deep, cuda, B):
    """Kernel 5 on groups of 8-136 rows, 16 queries a block (B <= 16) or 64
    (their A fragments in shared memory, or read from device memory at
    U = 512), several query chunks past 64; the ids shuffled.  Deep columns
    match up to ~100 ids, so the column lists are multiplied out several
    times an item."""
    _, _, n_terms, rng = deep
    tids, qtf = _blocked_queries(rng, B, 8, n_terms)
    _acc_case(deep, cuda, *_udedup_inputs(cuda, tids, qtf, B))


@pytest.mark.parametrize("B,T,n_u", [(14, 76, 1024), (20, 54, 1024),
                                     (16, 90, 1152), (17, 80, 1152),
                                     (40, 80, 2048)])
def test_acc_and_blocked_udedup_kernels_any_u(both_layouts, cuda, B, T, n_u):
    """U = 1024 (the last shared-memory uid table; kernel 5's A fragments in
    shared memory at B = 14, from device memory at B = 20; kernel 8's
    weights in shared memory at 32 queries a block) and above (the
    device-memory uid table; kernels 5 and 8 read their weights from device
    memory) on the 12k-doc corpus."""
    n_terms = both_layouts[2]
    tids, qtf = _wide_queries(np.random.default_rng(11), B, T, n_terms)
    u, wt = _udedup_inputs(cuda, tids, qtf, n_u)
    assert u.numel() == n_u
    _acc_case(both_layouts, cuda, u, wt)
    _blocked_udedup_case(both_layouts, cuda, u, wt, WIDE_TOL)


@pytest.mark.parametrize("B", [1, 7, 32, 33, 64, 65, 128])
def test_blocked_udedup_kernel_any_depth_and_batch(deep, cuda, B):
    """Kernel 8 on docs of 0-136 postings, one lane a query (B <= 32) or two,
    one query chunk of 64 or several, the ids shuffled."""
    _, _, n_terms, rng = deep
    tids, qtf = _blocked_queries(rng, B, 8, n_terms)
    _blocked_udedup_case(deep, cuda, *_udedup_inputs(cuda, tids, qtf, B),
                         WIDE_TOL)


@pytest.mark.parametrize("B", [8, 16, 40, 64, 70])
def test_blocked_udedup_equals_slot_kernel_2(both_layouts, cuda, B):
    """Kernel 8 equals slot kernel 2 bit for bit in artifact doc order, on
    df-like random batches of the 12k-doc corpus."""
    _, _, n_terms, rng = both_layouts
    tids, qtf = _queries(rng, B, 16, n_terms)
    _blocked_udedup_case(both_layouts, cuda, *_udedup_inputs(cuda, tids, qtf),
                         dict(atol=BM25_ATOL, rtol=0))


@pytest.mark.parametrize("B", [1, 16, 33, 64, 128])
def test_acc_and_blocked_udedup_kernels_edges(edges, cuda, B):
    """Kernels 5 and 8 on blocked rows with no real posting, docs of up to
    200 postings and one of 2,500 (a run across kernel 8's stages, a slot
    item of 157 stages), and a matched doc whose score is 0: keyed 0, not
    -1, in both."""
    tids, qtf = _edge_queries(edges, B, 8)
    u, wt = _udedup_inputs(cuda, tids, qtf)
    got5, _ = _acc_case(edges, cuda, u, wt)
    got8, want8 = _blocked_udedup_case(edges, cuda, u, wt, WIDE_TOL)
    assert want8[0, 3] == 0 and got8[0, 3] == 0
    assert (got8[:, 128:256] == -1).all() and (got8[:, 512:640] == -1).all()
    cu = edges[0][3]
    assert _slots_key(got5, cu, B)[0, 3] == 0


# ---- kernel 6 ("wide", "wide_i8"): one-hot products behind the stream ---


def _wide_case(layout, cuda, u, wt, tol):
    """Kernel 6 against its plain version (keys equal, one launch each) and,
    bit for bit, "wide" against kernel 2 and "wide_i8" against kernel 3 on
    the same (uids, w): the products are exact and each (query, column)
    folds its matched rows in row order, as kernels 2-3 do."""
    (vt, vi, stream, _), *_ = layout
    outs = {}
    for variant, same in SAME_AS.items():
        before = UDEDUP_KERNELS[variant].launches
        got = slots_udedup_keyed(stream, vt, vi, u, wt, variant)
        torch.cuda.synchronize()
        assert UDEDUP_KERNELS[variant].launches == before + 1
        want = slots_udedup_plain(vt, vi, u, wt, variant)
        torch.testing.assert_close(got, want, **tol)
        assert torch.equal(got < 0, want < 0)
        assert torch.equal(got, slots_udedup_keyed(stream, vt, vi, u, wt, same))
        assert (want >= 0).any() and (want == -1).any()
        outs[variant] = got
    return outs


@pytest.mark.parametrize("B", [1, 17, 64, 65, 128])
def test_wide_kernels_any_depth_and_batch(deep, cuda, B):
    """Kernel 6 on groups of 8-136 rows (not all whole stages), 16 queries
    a block (B = 1) or 64 (one m16 tile of them or four), one query chunk
    or several, a repeated term, shared terms, an all-pad query, the ids
    shuffled."""
    _, _, n_terms, rng = deep
    tids, qtf = _blocked_queries(rng, B, 8, n_terms)
    outs = _wide_case(deep, cuda, *_udedup_inputs(cuda, tids, qtf, B), WIDE_TOL)
    if B > 2:
        assert (outs["wide"][2] == -1).all()


@pytest.mark.parametrize("B,T,n_u", [(1, 8, 128), (17, 8, 128), (64, 6, 256),
                                     (65, 19, 1024), (128, 10, 1024),
                                     (17, 80, 1152), (40, 80, 2048),
                                     (64, 60, 2176)])
def test_wide_kernels_any_u(both_layouts, cuda, B, T, n_u):
    """Kernel 6 at U = 128-1024 (the shared-memory uid table; its A
    fragments in shared memory) and above (the device-memory uid table;
    the A fragments in shared memory where they fit, and at U = 2048 and
    2176 bf16 with 48-64 queries a block read from device memory), on the
    12k-doc corpus."""
    n_terms = both_layouts[2]
    tids, qtf = _wide_queries(np.random.default_rng(11), B, T, n_terms)
    u, wt = _udedup_inputs(cuda, tids, qtf, n_u)
    assert u.numel() == n_u
    _wide_case(both_layouts, cuda, u, wt, WIDE_TOL)


@pytest.mark.parametrize("B", [1, 16, 33, 64, 128])
def test_wide_kernels_edges(edges, cuda, B):
    """Kernel 6 on groups with no real posting (all-pad columns, keyed
    -1), columns of up to 200 postings and one of 2,500 from the most
    frequent terms (many matches a column in one stage, more than one
    step of the n8 tile takes), and a matched doc whose score is 0: keyed
    0, not -1."""
    tids, qtf = _edge_queries(edges, B, 8)
    u, wt = _udedup_inputs(cuda, tids, qtf)
    outs = _wide_case(edges, cuda, u, wt, WIDE_TOL)
    cu = edges[0][3]
    for got in outs.values():
        dense = _slots_key(got, cu, B)
        assert dense[0, 3] == 0
        assert (dense[:, 128:256] == -1).all() and (dense[:, 512:640] == -1).all()


def test_wrappers_refuse_wrong_inputs(slots, cuda):
    views_t, views_i, stream, n_terms, _ = slots
    tids = torch.zeros(2, 4, dtype=torch.int64, device=cuda)
    qtf = torch.ones(2, 4, device=cuda)
    with pytest.raises(TypeError):
        slots_keyed(stream, views_t, views_i, tids, qtf)
    emb = torch.zeros(2, 8, 64, device=cuda)  # f32 bank: the kernel takes bf16
    with pytest.raises(TypeError):
        bucket_stats(emb, torch.zeros(1, 64, device=cuda))


def _docs(seed, n=300):
    rng = np.random.default_rng(seed)
    abc = "abcdefghijklmnopqrstuvwxyz"
    words = [f"w{a}{b}q" for a in abc for b in abc]
    docs = []
    for i in range(n):
        k = int(rng.integers(20, 400))
        idx = np.minimum(rng.zipf(1.3, k) - 1, len(words) - 1)
        text = " ".join(words[j] for j in idx)
        if rng.random() < 0.7:
            text += " tübingen"
        docs.append(
            Document(i, f"https://www.s{i % 23}.de/p{i}", f"t{i}", text)
        )
    return docs, words


def _same_results(got, want):
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert abs(a.similarity_score - b.similarity_score) < 1e-3


def test_engine_on_card_matches_cpu(cuda):
    """Both layouts on the card against the CPU engine (same bf16 bank):
    the slot engine at B = 1, 16, 64; the blocked engine at B = 1 (kernel
    7) and at B = 64 queries sharing few terms (kernel 8)."""
    docs, words = _docs(1)
    cfg = Config(embedding_dim=64, window_size=64, step_size=50,
                 top_k_retrieval=200, top_k_reranking=10)
    enc = HashingEncoder(dim=64)
    art = IndexBuilder(enc, cfg).build(docs)
    rng = np.random.default_rng(2)
    counts = {k.name: k.launches for k in cuda_lib.KERNELS}
    batches = {
        "slots": [[" ".join(rng.choice(words, 4)) for _ in range(B)]
                  for B in (1, 16, 64)],
        "blocked": [[" ".join(rng.choice(words, 4))],
                    [" ".join(rng.choice(words[:40], 5, replace=False))
                     for _ in range(64)]],
    }
    for layout, qss in batches.items():
        c = cfg.replace(bm25_layout=layout)
        gpu = SearchEngine(art, enc, c)
        cpu = SearchEngine(art, enc, c, bank_dtype=torch.bfloat16, device="cpu")
        for qs in qss:
            _same_results(gpu.search_batch(qs, top_k=10),
                          cpu.search_batch(qs, top_k=10))
    tids, _, _ = gpu.prepare_queries(batches["blocked"][1])
    B, T = tids.shape
    assert blocked_udedup_gate(u_pad_for(len(np.unique(tids[tids >= 0]))), B, T)
    # every kernel the engine dispatches to ran; kernels 5 and 6 ("acc",
    # "wide", "wide_i8") are reached only through ``variant=``
    only_by_variant = {UDEDUP_KERNELS[v] for v in ("acc", "wide", "wide_i8")}
    for k in cuda_lib.KERNELS:
        if k not in only_by_variant:
            assert k.launches > counts[k.name], k.name
    assert UDEDUP_KERNELS["sublane"].launches > counts["bm25_slots_udedup_sublane"]


def test_empty_index_on_card(cuda):
    """An empty index serves on the blocked fallback: kernel 7 runs over
    one block of pads and every entry point returns []."""
    cfg = Config(embedding_dim=32, window_size=16, step_size=12,
                 top_k_retrieval=10, top_k_reranking=5, max_query_terms=8)
    enc = HashingEncoder(dim=32)
    eng = SearchEngine(IndexBuilder(enc, cfg).build([]), enc, cfg)
    before = BLOCKED_KERNEL.launches
    assert eng.search("castle", top_k=5) == []
    assert eng.bm25_search("castle") == []
    assert eng.dense_search("castle", top_k=5) == []
    assert BLOCKED_KERNEL.launches == before + 2


# ---- the bi-encoder on the card ---------------------------------------------

ENC_ATOL = 5e-3  # unit embeddings, card against the CPU port (bf16 rounding)


@pytest.fixture(scope="module")
def full_width(cuda):
    """The reference's default config (12 layers, 768 wide) with weights
    drawn from a numpy seed, on the card and on the CPU."""
    cfg = EncoderConfig()
    rng = np.random.default_rng(0)
    tree = init_reference_params(
        cfg, lambda s: rng.standard_normal(s, dtype=np.float32))
    return TorchEncoder(cfg, params=tree), TorchEncoder(cfg, params=tree,
                                                        device="cpu")


@pytest.mark.parametrize("n_words,B", [(3, 1), (3, 16), (40, 4), (600, 1)])
def test_encoder_on_card_matches_cpu(full_width, n_words, B):
    """Length buckets 16, 64 and 512 (600 words are cut to 510)."""
    card, cpu = full_width
    assert card.device.type == "cuda"
    assert card.params_digest() == cpu.params_digest()
    rng = np.random.default_rng(n_words * 100 + B)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 5000, n_words))
             for _ in range(B)]
    got = card.encode_batch_device(texts)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert got.shape == (B, 768)
    got = got.cpu().numpy()
    want = cpu.encode_batch(texts)
    assert np.abs(got - want).max() <= ENC_ATOL
    assert (got * want).sum(1).min() >= 0.9999
    np.testing.assert_allclose(card.encode_batch(texts), got)


def test_engine_with_encoder_on_card_matches_cpu(cuda):
    """search_batch with the bi-encoder on the card against the CPU engine
    (same bf16 bank) given the card's own query vectors."""
    docs, words = _docs(3, n=120)
    enc_cfg = EncoderConfig(vocab_size=8192, dim=64, n_layers=2, n_heads=4,
                            mlp_ratio=2, max_len=32)
    enc = TorchEncoder(enc_cfg, generator=torch.Generator().manual_seed(0))
    cfg = Config(embedding_dim=64, window_size=64, step_size=50,
                 top_k_retrieval=200, top_k_reranking=10)
    art = IndexBuilder(enc, cfg).build(docs)
    gpu = SearchEngine(art, enc, cfg)
    cpu = SearchEngine(art, HashingEncoder(dim=64), cfg,
                       bank_dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(4)
    for B in (1, 16, 64):
        qs = [" ".join(rng.choice(words, 4)) for _ in range(B)]
        tids, qtf, processed = gpu.prepare_queries(qs)
        qv = gpu.encode_queries(processed)
        assert isinstance(qv, torch.Tensor) and qv.device.type == "cuda"
        got = gpu.finish_batch(gpu._to_host(gpu._device_rank(tids, qtf, qv)),
                               qs, 10)
        want = cpu.finish_batch(
            cpu._to_host(cpu._device_rank(tids, qtf, qv.cpu())), qs, 10)
        _same_results(got, want)
        assert any(len(r) for r in got)
        _same_results(gpu.search_batch(qs, top_k=10), got)
