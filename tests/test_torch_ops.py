"""The torch hybrid tail against the reference ``retrieval/ops.py``: exact
top-k with lax.top_k's tie order, the tie-quota candidate mask, the stable
final re-sort with the int32 sentinel crossing the f32 lane, the fusion
math, and the whole bucketed tail on the XLA path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from modern_search_engines_project_tpu.retrieval import ops as ref
from modern_search_engines_project_tpu_torch.retrieval import ops as port

BIG = 2**31 - 1


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _topk_case(name):
    rng = np.random.default_rng(len(name))
    if name == "random":
        return rng.standard_normal((8, 40000), dtype=np.float32), 1000
    if name == "heavy_ties":
        return np.round(rng.standard_normal((4, 30000)) * 2).astype(np.float32), 500
    if name == "all_equal":
        return np.zeros((3, 20000), np.float32), 100
    if name == "small_n":
        return rng.standard_normal((5, 800), dtype=np.float32), 200
    if name == "recursive":
        return rng.standard_normal((2, 70000), dtype=np.float32), 1000
    if name == "neg_inf_pad":
        s = rng.standard_normal((3, 9999)).astype(np.float32)
        s[:, -7:] = -np.inf
        return s, 300
    # keyed BM25 scores: most docs -1, a few integer-valued ties
    s = np.full((4, 50000), -1.0, np.float32)
    hit = rng.random((4, 50000)) < 0.03
    s[hit] = rng.integers(0, 4, hit.sum()).astype(np.float32)
    return s, 1000


@pytest.mark.parametrize("block", [None, 4, 8, 16])
@pytest.mark.parametrize(
    "case",
    ["random", "heavy_ties", "all_equal", "small_n", "recursive",
     "neg_inf_pad", "keyed"],
)
def test_topk_blockmax_matches_lax_top_k(case, block):
    s, k = _topk_case(case)
    want = lax.top_k(jnp.asarray(s), k)
    got = port.topk_blockmax(torch.as_tensor(s), k, block)
    assert got[1].dtype == torch.int32
    _same([x.numpy() for x in got], want)


def _keyed_scores(seed, B=4, D=3000, k=200, boundary_ties=False, empty=False):
    rng = np.random.default_rng(seed)
    bm = np.full((B, D + 1), -1.0, np.float32)
    hit = rng.random((B, D)) < 0.2
    bm[:, :D][hit] = rng.integers(0, 50, hit.sum()).astype(np.float32)
    if boundary_ties:  # many docs at the k-th value -> ties straddle k
        bm[:, :D][rng.random((B, D)) < 0.15] = 7.0
    if empty:
        bm[0] = -1.0
    return bm, k


@pytest.mark.parametrize(
    "boundary_ties,empty", [(False, False), (True, False), (True, True)]
)
def test_dense_candidates_match_reference(boundary_ties, empty):
    bm, k = _keyed_scores(1, boundary_ties=boundary_ties, empty=empty)
    D = bm.shape[1] - 1
    top_v, _ = lax.top_k(jnp.asarray(bm[:, :D]), k)
    want = ref.dense_candidates_from_topk(jnp.asarray(bm), top_v, D)
    got = port.dense_candidates_from_topk(
        torch.as_tensor(bm), torch.as_tensor(np.array(top_v)), D
    )
    _same([x.numpy() for x in got], want)
    # the candidate set is exactly the top-k set
    assert (got[0].sum(1) == got[3].sum(1)).all()


@pytest.mark.parametrize("ties", [False, True])
def test_rank_candidates_matches_reference(ties):
    rng = np.random.default_rng(3)
    B, W, k = 3, 500, 120
    score = rng.standard_normal((B, W)).astype(np.float32)
    if ties:
        score = np.round(score * 2) / 2  # many equal fused scores
    score[:, ::17] = -np.inf  # non-candidates
    win = rng.integers(0, 5000, (B, W)).astype(np.int32)
    win[:, ::5] = BIG  # the sentinel must cross the f32 lane intact
    win[:, 1::7] = 2**24 + 1  # not representable as a float32 value
    top_idx = np.stack([rng.permutation(W)[:k] for _ in range(B)]).astype(np.int32)
    valid = rng.random((B, k)) < 0.9
    old = rng.random((B, k)).astype(np.float32)
    want = ref._rank_candidates(
        jnp.asarray(score), jnp.asarray(win), jnp.asarray(top_idx),
        jnp.asarray(valid), jnp.asarray(old), 100,
    )
    got = port._rank_candidates(
        torch.as_tensor(score), torch.as_tensor(win), torch.as_tensor(top_idx),
        torch.as_tensor(valid), torch.as_tensor(old), 100,
    )
    _same([x.numpy() for x in got], want)
    assert (got[3] == BIG).any() and (got[3] == 2**24 + 1).any()


def _random_stats(rng, buckets, B, degenerate=False):
    stats, starts = [], []
    off = 0
    for n, cnt in buckets:
        v = rng.standard_normal((3, B, cnt)).astype(np.float32)
        if degenerate:
            v[:] = 0.25
        v1, v2 = np.maximum(v[0], v[1]), np.minimum(v[0], v[1])
        vm = np.minimum(v2, v[2])
        w1 = rng.integers(0, n, (B, cnt)).astype(np.int32)
        w2 = rng.integers(0, n, (B, cnt)).astype(np.int32)
        stats.append((v1, v2, w1, w2, vm))
        starts.append((off + np.arange(cnt) * n).astype(np.int32))
        off += n * cnt
    return stats, starts


@pytest.mark.parametrize("degenerate", [False, True])
def test_fusion_from_stats_matches_reference(degenerate):
    rng = np.random.default_rng(11)
    buckets = ((1, 16), (3, 32), (6, 8))
    B, D = 4, 56
    stats, starts = _random_stats(rng, buckets, B, degenerate)
    cand = rng.random((B, D)) < 0.5
    old = np.where(cand, rng.random((B, D)), 0).astype(np.float32)
    j = lambda xs: tuple(jnp.asarray(x) for x in xs)  # noqa: E731
    t = lambda xs: tuple(torch.as_tensor(x) for x in xs)  # noqa: E731
    lo, hi = ref.stats_pool_extrema(
        [j(s) for s in stats], jnp.asarray(cand), buckets
    )
    plo, phi = port.stats_pool_extrema(
        [t(s) for s in stats], torch.as_tensor(cand), buckets
    )
    _same([plo.numpy(), phi.numpy()], [lo, hi])
    want = ref.fused_scores_from_stats(
        buckets, j(starts), [j(s) for s in stats], jnp.asarray(cand),
        jnp.asarray(old), lo[:, None], hi[:, None], 0.15,
    )
    got = port.fused_scores_from_stats(
        buckets, t(starts), [t(s) for s in stats], torch.as_tensor(cand),
        torch.as_tensor(old), plo[:, None], phi[:, None], 0.15,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("k_ret", [40, 300])
def test_bucketed_tail_matches_reference(k_ret):
    """The whole tail from keyed BM25 scores on: exact top-k, candidate
    mask, one dense pass, fusion, final ranking (reference XLA path)."""
    rng = np.random.default_rng(k_ret)
    buckets = ((1, 128), (2, 128), (4, 256))
    B, dim = 5, 32
    D = sum(c for _, c in buckets)
    emb = [rng.standard_normal((n, c, dim)).astype(np.float32) for n, c in buckets]
    emb = [e / np.linalg.norm(e, axis=2, keepdims=True) for e in emb]
    starts = []
    off = 0
    for n, c in buckets:
        starts.append((off + np.arange(c) * n).astype(np.int32))
        off += n * c
    bm = np.full((B, D + 1), -1.0, np.float32)
    hit = rng.random((B, D)) < 0.4
    bm[:, :D][hit] = np.round(rng.gamma(2.0, 1.5, hit.sum()), 1)  # with ties
    q = rng.standard_normal((B, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want = ref._hybrid_tail_buckets(
        jnp.asarray(bm), tuple(map(jnp.asarray, emb)),
        tuple(jnp.ones(c, bool) for _, c in buckets),
        tuple(map(jnp.asarray, starts)), jnp.asarray(q),
        n_docs_pad=D, k_ret=k_ret, smoothing=0.15, buckets=buckets,
    )
    got = port._hybrid_tail_buckets(
        torch.as_tensor(bm), tuple(map(torch.as_tensor, emb)),
        tuple(map(torch.as_tensor, starts)), torch.as_tensor(q),
        n_docs_pad=D, k_ret=k_ret, smoothing=0.15, buckets=buckets,
    )
    doc, vals, old, win, valid = (x.numpy() for x in got)
    wdoc, wvals, wold, wwin, wvalid = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(doc, wdoc)
    np.testing.assert_array_equal(valid, wvalid)
    np.testing.assert_array_equal(win[valid], wwin[wvalid])
    np.testing.assert_allclose(vals, wvals, atol=1e-5)
    np.testing.assert_allclose(old, wold, atol=1e-6)


def test_approx_selection_is_refused():
    bm = torch.zeros(1, 129)
    with pytest.raises(NotImplementedError):
        port._hybrid_tail_buckets(
            bm, (torch.zeros(1, 128, 32),), (torch.zeros(128, dtype=torch.int32),),
            torch.zeros(1, 32), n_docs_pad=128, k_ret=10, smoothing=0.15,
            buckets=((1, 128),), approx=True,
        )
