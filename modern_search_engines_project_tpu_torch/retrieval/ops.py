"""The hybrid ranking tails, in torch.

Counterpart of the kernel-path subset of the reference package's
``retrieval/ops.py``.  Bucketed tail: BM25 keyed scores (slot kernels 1-3,
5-6 or blocked kernels 7-8) -> exact top-k candidates -> candidate mask ->
per-bucket dense statistics (kernel 4) -> pool extrema -> fusion and
positional adjustment -> final ranking.  No-bucket tail (an index without
chunk buckets): blocked BM25 -> top-k -> dense sims over the packed bank
with sorted-segment reductions.  Same math and the same tie rules as the
reference (``lax.top_k`` order: value descending, then index ascending; a
stable final re-sort).  An int8 bucket bank (``bank_dtype="int8"``, a
(q8, inv_scale) pair a bucket) stays off kernel 4, as in the reference:
its sims are an s8 x s8 -> s32 product (``int8_bucket_sims``) followed by
the streaming top-2.

The reference's scatter path is here too, in plain torch (it is XLA
gather/scatter there, no TPU kernel): ``bm25_score_batch`` over the CSR
postings, ``exact_topk``, ``hybrid_rank`` (CSR BM25 + the packed-bank
tail, the engine's ``use_pallas=False`` path) and ``bm25_topk``; the
sharded backend's ``bm25_topk`` and its scatter stage 1 run on it.
"""

from __future__ import annotations

import torch

from modern_search_engines_project_tpu_torch.retrieval.bm25_blocked import (
    bm25_score_blocked,
    bm25_score_blocked_udedup,
)
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    bm25_score_slots,
    bm25_score_slots_udedup,
)
from modern_search_engines_project_tpu_torch.retrieval.dense_stats import (
    bucket_sims,
    bucket_stats,
    slot_top2,
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


EXACT_TOPK_MIN_COLS = 131_072  # exact_topk splits only wider doc axes
EXACT_TOPK_BLOCK = 8_000  # columns a first-stage block of exact_topk


def exact_topk(scores: torch.Tensor, k: int):
    """Two-stage blocked exact top-k (the reference's): rows wider than
    ``EXACT_TOPK_MIN_COLS`` are cut into blocks of ``EXACT_TOPK_BLOCK``
    columns, each block's top-k taken, then the top-k of those.  Both
    stages have ``lax.top_k``'s tie order, so the result equals
    ``_sorted_topk`` of the whole row."""
    B, N = scores.shape
    L = EXACT_TOPK_BLOCK
    if N <= EXACT_TOPK_MIN_COLS or k > L:
        return _sorted_topk(scores, k)
    pad = (-N) % L
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    nb = (N + pad) // L
    bv, bi = torch.sort(scores.reshape(B, nb, L), dim=2, descending=True,
                        stable=True)
    bv, bi = bv[:, :, :k], bi[:, :, :k]
    gi = bi + (torch.arange(nb, device=scores.device) * L)[None, :, None]
    v, sel = _sorted_topk(bv.reshape(B, -1), k)
    return v, gi.reshape(B, -1).gather(1, sel.long()).to(torch.int32)


def bm25_score_batch(
    indptr, post_docs, post_impact, term_ids, qtf, *, n_docs_pad: int,
    posting_cap: int,
) -> torch.Tensor:
    """Keyed BM25 scores [B, n_docs_pad + 1] over term-major CSR postings
    (the reference's scatter front end; the last column is the scatter
    sentinel).

    Each query's terms are taken rarest first and their postings laid out
    in one budget of ``posting_cap`` lanes (a query over budget loses the
    postings of its commonest terms); a lane finds its term by comparing
    against all T cumulative lengths.  One scatter-add accumulates (score,
    match count) a doc, so a doc matched with score exactly 0 (idf 0)
    stays admissible: a matched doc with score >= 0 keeps it, every other
    doc gets -1.  The scatter adds in no fixed order on the card."""
    B, T = term_ids.shape
    dev = term_ids.device
    nnz = post_docs.shape[0]
    n_terms = indptr.shape[0] - 1
    valid_term = term_ids >= 0
    tid = term_ids.clamp(0, max(n_terms - 1, 0)).long()
    starts = indptr[tid]
    # (an empty vocabulary has indptr [0]: clamp as the reference's gather)
    ends = indptr[(tid + 1).clamp(max=n_terms)]
    lens = torch.where(valid_term, ends - starts, 0)

    order = torch.argsort(lens, dim=1, stable=True)  # rarest first
    lens_s = lens.gather(1, order)
    starts_s = starts.gather(1, order)
    qtf_s = qtf.gather(1, order)

    cum = torch.cumsum(lens_s, dim=1)
    total = cum[:, -1:]
    j = torch.arange(posting_cap, dtype=cum.dtype, device=dev)[None, :]
    slot = torch.zeros(B, posting_cap, dtype=torch.int64, device=dev)
    for t in range(T):
        slot += j >= cum[:, t : t + 1]
    slot = slot.clamp(0, T - 1)
    cum0 = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    within = j - cum0.gather(1, slot)
    src = (starts_s.gather(1, slot) + within).clamp(0, max(nnz - 1, 0)).long()

    valid = j < total
    d = torch.where(valid, post_docs[src], n_docs_pad)
    contrib = torch.where(valid, post_impact[src] * qtf_s.gather(1, slot), 0.0)
    updates = torch.stack([contrib, valid.to(torch.float32)], dim=-1)
    rows = torch.arange(B, device=dev)[:, None] * (n_docs_pad + 1)
    acc = torch.zeros(B * (n_docs_pad + 1), 2, dtype=torch.float32,
                      device=dev)
    acc.index_add_(0, (d.long() + rows).reshape(-1), updates.reshape(-1, 2))
    acc = acc.reshape(B, n_docs_pad + 1, 2)
    scores, matched = acc[..., 0], acc[..., 1] > 0
    return torch.where(matched & (scores >= 0.0), scores, -1.0)


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


def quantize_queries_int8(qvec: torch.Tensor):
    """Symmetric per-row int8 quantization of f32 queries [B, dim] (the
    reference's): (qi int8 [B, dim], qm f32 [B, 1]) with
    ``qvec ~= qi * qm / 127``; an all-zero row gets qm = 1."""
    qm = qvec.abs().amax(dim=1, keepdim=True)
    qm = torch.where(qm > 0, qm, 1.0)
    qi = torch.clamp(torch.round(qvec / qm * 127.0), -127, 127)
    return qi.to(torch.int8), qm


def _int8_product(q8: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 -> s32 product of the bank rows q8 [M, dim] and the
    queries qi [B, dim] -> [M, B] int32.  On the card one
    ``torch._int_mm`` with the bank on the M side (it wants more than 16
    rows and inner and output widths that are multiples of 8: the queries
    and the dim axis are zero-padded to 8); on the CPU an int32 matmul."""
    if q8.device.type != "cuda":
        return q8.to(torch.int32) @ qi.to(torch.int32).T
    M, dim = q8.shape
    B = qi.shape[0]
    pd, pb = (-dim) % 8, (-B) % 8
    if pd:
        q8 = torch.nn.functional.pad(q8, (0, pd))
        qi = torch.nn.functional.pad(qi, (0, pd))
    if M <= 16:
        q8 = torch.nn.functional.pad(q8, (0, 0, 0, 17 - M))
    if pb:
        qi = torch.nn.functional.pad(qi, (0, 0, 0, pb))
    return torch._int_mm(q8, qi.T)[:M, :B]


def int8_bucket_sims(pair, qvec: torch.Tensor) -> torch.Tensor:
    """[B, n, cnt] f32 sims of queries and an int8 bucket bank ``pair`` =
    (q8 [n, cnt, dim] int8, inv [n, cnt] f32): each query row quantized
    symmetrically, the product s8 x s8 -> s32 (exact), then the scales
    applied as ``raw.f32 * (qm / 127) * inv``, in that order (the
    reference's ``_bucket_sims`` pair branch)."""
    q8, inv = pair
    n, cnt, dim = q8.shape
    qi, qm = quantize_queries_int8(qvec.to(torch.float32))
    raw = _int8_product(q8.reshape(n * cnt, dim), qi)  # [n*cnt, B]
    raw = raw.T.reshape(-1, n, cnt)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ from qm / 127 by an ulp
    scale = qm / torch.full_like(qm, 127.0)
    return raw.to(torch.float32) * scale[:, :, None] * inv[None, :, :]


def bucket_doc_stats(buckets, bucket_emb, qvec):
    """ONE dense pass over the chunk bank -> per bucket (v1, v2, w1, w2,
    vmin), each [B, cnt], through kernel 4; an int8 pair bank takes its
    s32 product and the streaming top-2 over the slot axis instead (strict
    ``>`` keeps the lowest slot on ties, ``n == 1`` gives (v1, v1, 0, 0,
    v1)), as the reference keeps int8 banks off its stats kernel.  Rows of
    bucket-pad docs are garbage; they are never candidates (keyed BM25
    score -1)."""
    return [
        slot_top2(int8_bucket_sims(emb, qvec)) if isinstance(emb, tuple)
        else bucket_stats(emb, qvec)
        for emb in bucket_emb
    ]


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
    them back).  Returns (doc, fused, bm25_norm, win, valid), [B, k_ret].

    ``approx=True`` runs the exact selection too: the reference's
    ``lax.approx_max_k`` is approximate only on a TPU and computes the
    exact top-k on every other backend, so this is the reference's own
    answer off the TPU."""
    del approx
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


def _segment(reduce: str, data: torch.Tensor, seg: torch.Tensor,
             num_segments: int, identity) -> torch.Tensor:
    """Batched segment reduction: data [B, C] -> [B, num_segments] with
    ``reduce`` "amax" or "amin" along sorted ``seg`` [C]; an empty segment
    holds ``identity`` (-inf / the int sentinel, as the reference's
    segment_max and segment_min give)."""
    B = data.shape[0]
    out = torch.full((B, num_segments), identity, dtype=data.dtype,
                     device=data.device)
    idx = seg.long()[None, :].expand(B, -1)
    return out.scatter_reduce_(1, idx, data, reduce, include_self=True)


def _packed_sims(chunk_emb: torch.Tensor, qvec: torch.Tensor):
    """[B, C] f32 sims of the bank-dtype query and packed bank (inputs in
    the bank dtype, f32 sums, as the reference's dot)."""
    q = qvec.to(chunk_emb.dtype).to(torch.float32)
    return q @ chunk_emb.to(torch.float32).T


def _hybrid_tail(
    bm, chunk_emb, chunk_doc, doc_chunk_start, doc_n_chunks, qvec, *,
    n_docs_pad: int, k_ret: int, smoothing: float,
):
    """Stages 2+3 over the packed (artifact-order) chunk bank, for an index
    without buckets.  ``bm`` is keyed scores [B, Dp+1]; returns (doc,
    fused, bm25_norm, win, valid), each [B, k_ret]."""
    B = qvec.shape[0]
    Dp1 = n_docs_pad + 1
    C = chunk_emb.shape[0]
    dev = bm.device
    b_rows = torch.arange(B, device=dev)[:, None]

    top_vals, top_idx = topk_blockmax(bm[:, :n_docs_pad], k_ret)
    valid_c = top_vals >= 0.0

    # min-max normalize BM25 over the candidate pool
    inf = float("inf")
    lo = torch.where(valid_c, top_vals, inf).amin(dim=1, keepdim=True)
    hi = torch.where(valid_c, top_vals, -inf).amax(dim=1, keepdim=True)
    denom = hi - lo
    safe = torch.where(denom > 0, denom, 1.0)
    old_norm = torch.where(valid_c & (denom > 0), (top_vals - lo) / safe, 0.0)

    # candidate info on the dense doc axis (invalid -> sentinel column)
    scatter_idx = torch.where(valid_c, top_idx, n_docs_pad).long()
    cand_mask = torch.zeros(B, Dp1, dtype=torch.bool, device=dev)
    cand_mask[b_rows, scatter_idx] = True
    cand_mask[:, n_docs_pad] = False
    old_dense = torch.zeros(B, Dp1, dtype=torch.float32, device=dev)
    old_dense[b_rows, scatter_idx] = old_norm

    # ---- stage 2: dense similarity over the whole bank ---------------------
    sims = _packed_sims(chunk_emb, qvec)  # [B, C]
    seg = chunk_doc.long()  # sorted ascending (doc-major bank)
    chunk_mask = cand_mask.index_select(1, seg)
    lo_c = torch.where(chunk_mask, sims, inf).amin(dim=1, keepdim=True)
    hi_c = torch.where(chunk_mask, sims, -inf).amax(dim=1, keepdim=True)
    den_c = hi_c - lo_c
    new_norm = torch.where(
        chunk_mask & (den_c > 0),
        (sims - lo_c) / torch.where(den_c > 0, den_c, 1.0),
        0.0,
    )

    # ---- fusion + positional ------------------------------------------------
    old_chunk = old_dense.index_select(1, seg)
    fused = torch.where(
        chunk_mask, new_norm * (1.0 - smoothing) + old_chunk * smoothing, -inf
    )
    cidx = torch.arange(C, dtype=torch.int32, device=dev)[None, :]

    m1 = _segment("amax", fused, seg, Dp1, -inf)  # best chunk score
    is_w1 = (fused == m1.index_select(1, seg)) & chunk_mask
    # first argmax chunk
    w1 = _segment("amin", torch.where(is_w1, cidx, _BIG), seg, Dp1, _BIG)
    fused2 = torch.where(cidx == w1.index_select(1, seg), -inf, fused)
    m2 = _segment("amax", fused2, seg, Dp1, -inf)
    is_w2 = (fused2 == m2.index_select(1, seg)) & chunk_mask
    w2 = _segment("amin", torch.where(is_w2, cidx, _BIG), seg, Dp1, _BIG)

    nck = doc_n_chunks[None, :]  # [1, Dp1]
    pos = w1 - doc_chunk_start[None, :]
    ratio = pos.to(torch.float32) / torch.clamp(nck - 1, min=1).to(
        torch.float32
    )
    adj = 0.10 - (0.10 + 0.05) * ratio
    m1_adj = torch.where(nck > 1, torch.clamp(m1 + adj, 0.0, 1.0), m1)

    doc_score = torch.maximum(m1_adj, m2)
    win = torch.where(m1_adj >= m2, w1, w2)
    return _rank_candidates(doc_score, win, top_idx, valid_c, old_norm, k_ret)


def hybrid_rank(
    indptr, post_docs, post_impact, chunk_emb, chunk_doc, doc_chunk_start,
    doc_n_chunks, term_ids, qtf, qvec, *, n_docs_pad: int, posting_cap: int,
    k_ret: int, smoothing: float = 0.15,
):
    """The reference's scatter path: CSR BM25 (``bm25_score_batch``) + the
    packed-bank tail, both in artifact doc order.  Returns (doc, fused,
    bm25_norm, win, valid), each [B, k_ret]."""
    bm = bm25_score_batch(
        indptr, post_docs, post_impact, term_ids, qtf,
        n_docs_pad=n_docs_pad, posting_cap=posting_cap,
    )
    return _hybrid_tail(
        bm, chunk_emb, chunk_doc, doc_chunk_start, doc_n_chunks, qvec,
        n_docs_pad=n_docs_pad, k_ret=k_ret, smoothing=smoothing,
    )


def bm25_topk(didx, term_ids, qtf, k: int):
    """BM25-only retrieval over the CSR postings: (idx [B,k], vals [B,k])."""
    bm = bm25_score_batch(
        didx.indptr, didx.post_docs, didx.post_impact, term_ids, qtf,
        n_docs_pad=didx.n_docs_pad, posting_cap=didx.posting_cap,
    )
    vals, idx = topk_blockmax(bm[:, : didx.n_docs_pad], k)
    return idx, vals


def hybrid_rank_blocked(
    didx, term_ids, qtf, qvec, *, k_ret: int, smoothing: float = 0.15,
):
    """Blocked BM25 through kernel 7 + the packed-bank tail: the engine's
    path for an index without buckets (an empty corpus).  Doc indices are
    in artifact order."""
    bm = bm25_score_blocked(didx.blocked, term_ids, qtf)
    return _hybrid_tail(
        bm, didx.chunk_emb, didx.chunk_doc, didx.doc_chunk_start,
        didx.doc_n_chunks, qvec, n_docs_pad=didx.n_docs_pad, k_ret=k_ret,
        smoothing=smoothing,
    )


def dense_rank(chunk_emb, chunk_doc, qvec, *, n_docs_pad: int, k: int):
    """Exact brute-force dense retrieval over the packed bank: per-doc max
    cosine, top-k.  Returns (doc_idx [B,k], cosine [B,k], win [B,k])."""
    sims = _packed_sims(chunk_emb, qvec)
    C = chunk_emb.shape[0]
    Dp1 = n_docs_pad + 1
    seg = chunk_doc.long()
    inf = float("inf")
    # padded chunks (chunk_doc == sentinel) must not win
    masked = torch.where((seg < n_docs_pad)[None, :], sims, -inf)
    m1 = _segment("amax", masked, seg, Dp1, -inf)
    cidx = torch.arange(C, dtype=torch.int32, device=sims.device)[None, :]
    is_w = masked == m1.index_select(1, seg)
    w1 = _segment("amin", torch.where(is_w, cidx, _BIG), seg, Dp1, _BIG)
    vals, idx = topk_blockmax(m1[:, :n_docs_pad], k)
    return idx, vals, w1.gather(1, idx.long())


def bucket_dense_best(buckets, bucket_emb, bucket_valid, bucket_start, qvec):
    """Brute-force dense per-doc best over every bucket (dense or int8 pair
    banks) -> (doc_best [B, sum cnt], win_gid [B, sum cnt]).  Ties pick the
    lowest slot (``torch.argmax`` returns the first maximum, as
    ``jnp.argmax``)."""
    score_parts, win_parts = [], []
    for emb, dv, bs in zip(bucket_emb, bucket_valid, bucket_start):
        sims = (int8_bucket_sims(emb, qvec) if isinstance(emb, tuple)
                else bucket_sims(emb, qvec))
        sims = torch.where(dv[None, None, :], sims, float("-inf"))
        score_parts.append(sims.amax(dim=1))
        slot = torch.argmax(sims, dim=1).to(torch.int32)
        win_parts.append(bs[None, :] + slot)
    return torch.cat(score_parts, dim=1), torch.cat(win_parts, dim=1)


def dense_rank_buckets(didx, qvec, *, k: int):
    """dense_rank over the bucketed layout; doc indices in the PERMUTED
    order (DeviceIndex.doc_perm maps them back)."""
    doc_best, win = bucket_dense_best(
        didx.buckets, didx.bucket_emb, didx.bucket_valid, didx.bucket_start,
        qvec,
    )
    n = didx.n_docs_pad
    doc_best, win = doc_best[:, :n], win[:, :n]
    vals, idx = topk_blockmax(doc_best, k)
    return idx, vals, win.gather(1, idx.long())


def bm25_topk_slots(didx, term_ids, qtf, k: int):
    """BM25-only retrieval through slot kernel 1: (idx [B,k], vals [B,k])."""
    bm = bm25_score_slots(didx, term_ids, qtf)
    vals, idx = topk_blockmax(bm[:, : didx.n_docs_pad], k)
    return idx, vals


def bm25_topk_blocked(didx, term_ids, qtf, k: int):
    """BM25-only retrieval through blocked kernel 7."""
    bm = bm25_score_blocked(didx.blocked, term_ids, qtf)
    vals, idx = topk_blockmax(bm[:, : didx.n_docs_pad], k)
    return idx, vals


def _tail_of(didx, bm, qvec, k_ret, smoothing, approx):
    return _hybrid_tail_buckets(
        bm, didx.bucket_emb, didx.bucket_start, qvec,
        n_docs_pad=didx.n_docs_pad, k_ret=k_ret, smoothing=smoothing,
        buckets=didx.buckets, approx=approx,
    )


def hybrid_rank_buckets(
    didx, term_ids, qtf, qvec, *, k_ret: int, smoothing: float = 0.15,
    approx: bool = False,
):
    """Blocked BM25 through kernel 7 + the bucketed dense tail."""
    bm = bm25_score_blocked(didx.blocked, term_ids, qtf)
    return _tail_of(didx, bm, qvec, k_ret, smoothing, approx)


def hybrid_rank_buckets_udedup(
    didx, uids, w, qvec, *, k_ret: int, smoothing: float = 0.15,
    approx: bool = False,
):
    """hybrid_rank_buckets with the U-dedup front end (kernel 8)."""
    bm = bm25_score_blocked_udedup(didx.blocked, uids, w)
    return _tail_of(didx, bm, qvec, k_ret, smoothing, approx)


def hybrid_rank_slots(
    didx, term_ids, qtf, qvec, *, k_ret: int, smoothing: float = 0.15,
    approx: bool = False,
):
    """Slot BM25 through kernel 1 + the bucketed dense tail."""
    bm = bm25_score_slots(didx, term_ids, qtf)
    return _tail_of(didx, bm, qvec, k_ret, smoothing, approx)


def hybrid_rank_slots_udedup(
    didx, uids, w, qvec, *, k_ret: int, smoothing: float = 0.15,
    approx: bool = False, acc: bool = True, variant: str = None,
):
    """hybrid_rank_slots with the U-dedup front end (kernel 2, 3, 5 or 6).
    ``variant`` picks the kernel (the engine passes ``udedup_plan``'s
    pick); the legacy ``acc`` flag applies only when it is None: "acc"
    (kernel 5) if True, as in the reference, else "sublane"."""
    bm = bm25_score_slots_udedup(didx, uids, w, variant, acc=acc)
    return _tail_of(didx, bm, qvec, k_ret, smoothing, approx)
