"""The hybrid ranking tail over the bucketed layout, in torch.

Counterpart of the slot-path subset of the reference package's
``retrieval/ops.py``: BM25 keyed scores (kernels 1-3) -> exact top-k
candidates -> candidate mask -> per-bucket dense statistics (kernel 4) ->
pool extrema -> fusion and positional adjustment -> final ranking.  Same
math and the same tie rules as the reference (``lax.top_k`` order: value
descending, then index ascending; a stable final re-sort).
"""

from __future__ import annotations

import torch

from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    bm25_score_slots,
    bm25_score_slots_udedup,
)
from modern_search_engines_project_tpu_torch.retrieval.dense_stats import (
    bucket_stats,
)

_BIG = 2**31 - 1  # int32 sentinel; must survive the f32 lane (bitcast)


def _sorted_topk(scores: torch.Tensor, k: int):
    """``lax.top_k``: the k largest values per row, ordered by value
    descending and, among equal values, by index ascending.  A stable
    descending sort keeps equal values in index order; ``torch.topk``
    promises no tie order."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def _two_key_sort(vals: torch.Tensor, idx: torch.Tensor):
    """Sort each row by (value desc, idx asc): a stable sort by idx, then a
    stable sort by value."""
    o = torch.argsort(idx, dim=1, stable=True)
    vals, idx = vals.gather(1, o), idx.gather(1, o)
    o = torch.argsort(vals, dim=1, descending=True, stable=True)
    return vals.gather(1, o), idx.gather(1, o)


def topk_blockmax(scores: torch.Tensor, k: int, block=None):
    """Exact top-k with ``lax.top_k``'s tie semantics, via a block-max
    prefilter (the reference algorithm):

      1. per-block max over G consecutive docs,
      2. exact top-k over the [B, N/G] block maxima (recursive),
      3. expand the selected blocks to their k*G member docs,
      4. one two-key sort (value desc, doc idx asc) of that pool.

    Exact because every doc above the k-th value tau lies in a block whose
    max exceeds tau, and ties at tau fill the remaining slots with the
    lowest-index blocks, which hold the lowest-index tied docs."""
    B, N = scores.shape
    if block is None:
        block = 8 if (N + 7) // 8 <= 16384 else 4
    if k >= N or N <= 4 * k * block:
        return _sorted_topk(scores, k)
    pad = (-N) % block
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    nb = (N + pad) // block
    s3 = scores.reshape(B, nb, block)
    bmax = s3.amax(dim=2)
    nblk = min(k, nb)
    _, bidx = topk_blockmax(bmax, nblk, block)
    bidx = bidx.long()
    dvals = s3.gather(1, bidx[:, :, None].expand(B, nblk, block)).reshape(
        B, nblk * block
    )
    lane = torch.arange(block, device=scores.device)
    didx = (bidx[:, :, None] * block + lane).reshape(B, nblk * block)
    vals, idx = _two_key_sort(dvals, didx)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def _rank_candidates(doc_score, win, top_idx, valid_c, old_norm, k_ret: int):
    """Gather each candidate's fused score and winning chunk, then ONE
    stable re-sort by fused score (ties keep candidate order, i.e.
    ascending stage-1 rank).  ``win`` rides the f32 lane as a bitcast
    (``view``), so the int32 ``_BIG`` sentinel survives exactly."""
    B, W = doc_score.shape
    rows = torch.arange(B, device=doc_score.device)[:, None] * W
    gflat = (top_idx.long() + rows).reshape(-1)
    packed = torch.stack([doc_score, win.view(torch.float32)], dim=-1)
    out = packed.reshape(-1, 2).index_select(0, gflat).reshape(B, -1, 2)
    cand_scores = out[..., 0]
    cand_win = out[..., 1].contiguous().view(torch.int32)
    sort_key = torch.where(valid_c, cand_scores, -1.0)
    order = torch.argsort(-sort_key, dim=1, stable=True)
    final = [
        x.gather(1, order)[:, :k_ret]
        for x in (top_idx, -sort_key, old_norm, cand_win, valid_c)
    ]
    final_doc, neg_vals, final_old, final_win, final_valid = final
    return final_doc, -neg_vals, final_old, final_win, final_valid


def dense_candidates_from_topk(bm, top_vals, n_docs_pad: int, n_valid=None):
    """Candidate mask + normalized-BM25 dense arrays without a scatter.

    A doc is a candidate iff its keyed score clears the k-th admissible
    value tau; docs tied AT tau are admitted lowest-index-first until the
    count matches the top-k's, so the set equals the scattered one.

    The reference computes the tie-rank cumsum only when some query has
    ties straddling the k boundary (a ``lax.cond``).  Without boundary ties
    every tied doc is within its quota (``tie_rank <= n_ties <= quota``),
    so the cumsum form gives the same mask in both cases; it is computed
    always, which keeps the host from waiting on the device here.

    Returns (cand_mask [B, Dp] bool, old_dense [B, Dp] f32,
    old_norm [B, k] f32, valid_c [B, k] bool)."""
    bmd = bm[:, :n_docs_pad]
    valid_c = top_vals >= 0.0
    inf = float("inf")
    lo = torch.where(valid_c, top_vals, inf).amin(dim=1, keepdim=True)
    hi = torch.where(valid_c, top_vals, -inf).amax(dim=1, keepdim=True)
    denom = hi - lo
    safe = torch.where(denom > 0, denom, 1.0)
    old_norm = torch.where(valid_c & (denom > 0), (top_vals - lo) / safe, 0.0)
    if n_valid is None:
        n_valid = valid_c.sum(dim=1, keepdim=True)
    # tau = +inf when nothing is admissible -> empty mask
    above = bmd > lo
    ties = bmd == lo
    quota = n_valid - above.sum(dim=1, keepdim=True)
    tie_rank = torch.cumsum(ties.to(torch.int32), dim=1)
    cand_mask = above | (ties & (tie_rank <= quota))
    old_dense = torch.where(cand_mask & (denom > 0), (bmd - lo) / safe, 0.0)
    return cand_mask, old_dense, old_norm, valid_c


def bucket_doc_stats(buckets, bucket_emb, qvec):
    """ONE dense pass over the chunk bank -> per bucket (v1, v2, w1, w2,
    vmin), each [B, cnt], through kernel 4.  Rows of bucket-pad docs are
    garbage; they are never candidates (keyed BM25 score -1)."""
    return [bucket_stats(emb, qvec) for emb in bucket_emb]


def stats_pool_extrema(stats, cand_mask, buckets):
    """Candidate-pool raw-sim extrema from per-doc stats -> (lo, hi) [B]."""
    lo_parts, hi_parts = [], []
    off = 0
    inf = float("inf")
    for (n, cnt), (v1, _v2, _w1, _w2, vmin) in zip(buckets, stats):
        m = cand_mask[:, off : off + cnt]
        lo_parts.append(torch.where(m, vmin, inf).amin(dim=1))
        hi_parts.append(torch.where(m, v1, -inf).amax(dim=1))
        off += cnt
    return (
        torch.stack(lo_parts).amin(dim=0),
        torch.stack(hi_parts).amax(dim=0),
    )


def fused_scores_from_stats(
    buckets, bucket_start, stats, cand_mask, old_dense, lo_c, hi_c,
    smoothing: float,
):
    """Per-doc fusion and positional math from the one-pass stats.

    Min-max normalize raw sims over the candidate pool, fuse
    (1-s)*cos + s*bm25, +10%/-5% linear positional adjustment of the best
    chunk, clamp [0, 1], post-adjustment winner re-selection against the
    runner-up.  A degenerate pool (hi == lo) makes every fused value
    constant per doc, whose top-2 is then slots (0, 1).  Returns
    (doc_score, win_gid), each [B, sum cnt]; non-candidates score -inf."""
    den = hi_c - lo_c
    ok = den > 0
    den_safe = torch.where(ok, den, 1.0)
    score_parts, win_parts = [], []
    off = 0
    for (n, cnt), bstart, (v1, v2, w1, w2, _vmin) in zip(
        buckets, bucket_start, stats
    ):
        cand = cand_mask[:, off : off + cnt]
        old = old_dense[:, off : off + cnt]
        n1 = torch.where(ok, (v1 - lo_c) / den_safe, 0.0)
        f1 = n1 * (1.0 - smoothing) + old * smoothing
        if n == 1:
            doc_score = f1
            win_slot = torch.zeros_like(w1)
        else:
            n2 = torch.where(ok, (v2 - lo_c) / den_safe, 0.0)
            f2 = n2 * (1.0 - smoothing) + old * smoothing
            w1e = torch.where(ok, w1, 0)
            w2e = torch.where(ok, w2, 1)
            ratio = w1e.to(torch.float32) / float(n - 1)
            adj = 0.10 - (0.10 + 0.05) * ratio
            m1_adj = torch.clamp(f1 + adj, 0.0, 1.0)
            doc_score = torch.maximum(m1_adj, f2)
            win_slot = torch.where(m1_adj >= f2, w1e, w2e)
        score_parts.append(torch.where(cand, doc_score, float("-inf")))
        win_parts.append(bstart[None, :] + win_slot)
        off += cnt
    return torch.cat(score_parts, dim=1), torch.cat(win_parts, dim=1)


def _hybrid_tail_buckets(
    bm, bucket_emb, bucket_start, qvec, *, n_docs_pad: int, k_ret: int,
    smoothing: float, buckets, approx: bool = False,
):
    """Stages 2+3 over the bucketed layout: candidates from the exact
    top-k of the keyed BM25 scores, one dense pass, fusion, ranking.
    Doc indices are in the PERMUTED order (DeviceIndex.doc_perm maps
    them back).  Returns (doc, fused, bm25_norm, win, valid), [B, k_ret]."""
    if approx:
        raise NotImplementedError(
            "approximate candidate selection (the reference's "
            "lax.approx_max_k) has no port yet; use approx_candidates=False"
        )
    top_vals, top_idx = topk_blockmax(bm[:, :n_docs_pad], k_ret)
    cand_mask, old_dense, old_norm, valid_c = dense_candidates_from_topk(
        bm, top_vals, n_docs_pad
    )
    stats = bucket_doc_stats(buckets, bucket_emb, qvec)
    lo, hi = stats_pool_extrema(stats, cand_mask, buckets)
    doc_score, win = fused_scores_from_stats(
        buckets, bucket_start, stats, cand_mask, old_dense,
        lo[:, None], hi[:, None], smoothing,
    )
    return _rank_candidates(doc_score, win, top_idx, valid_c, old_norm, k_ret)


def hybrid_rank_slots(
    didx, term_ids, qtf, qvec, *, k_ret: int, smoothing: float = 0.15,
    approx: bool = False,
):
    """Slot BM25 through kernel 1 + the bucketed dense tail."""
    bm = bm25_score_slots(didx, term_ids, qtf)
    return _hybrid_tail_buckets(
        bm, didx.bucket_emb, didx.bucket_start, qvec,
        n_docs_pad=didx.n_docs_pad, k_ret=k_ret, smoothing=smoothing,
        buckets=didx.buckets, approx=approx,
    )


def hybrid_rank_slots_udedup(
    didx, uids, w, qvec, *, k_ret: int, smoothing: float = 0.15,
    approx: bool = False, variant: str = "sublane",
):
    """hybrid_rank_slots with the U-dedup front end (kernel 2 or 3)."""
    bm = bm25_score_slots_udedup(didx, uids, w, variant)
    return _hybrid_tail_buckets(
        bm, didx.bucket_emb, didx.bucket_start, qvec,
        n_docs_pad=didx.n_docs_pad, k_ret=k_ret, smoothing=smoothing,
        buckets=didx.buckets, approx=approx,
    )
