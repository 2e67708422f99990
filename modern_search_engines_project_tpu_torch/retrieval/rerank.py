"""Host-side rerank finishing: domain diversification over ranked candidates.

The device engine (``retrieval/engine.py``) produces the fused+positionally
adjusted candidate ranking entirely on TPU; diversification is a greedy
sequential pass over at most ``top_k_retrieval`` rows, so it stays on host
(SURVEY.md §7 "hard parts" — greedy logic over top-k only).

Behavior parity with reference ``reranker/reranker_api.py``:
  * ``apply_domain_cap``         — reranker_api.py:178-194
  * ``hybrid_diversification``   — reranker_api.py:196-236 (0.8 relevance
    split, domain promotion into the high group, 1-per-domain cap in both
    groups, monotone-decreasing backfill of dropped docs)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class RankedDoc:
    """One reranked candidate (DocumentScore analog, reranker_api.py:150-158)."""

    doc_id: int  # external id
    url: str
    title: str
    similarity_score: float  # fused + positional score
    original_similarity: float  # normalized BM25 score (old_similarity)
    window_index: int  # global chunk index of the most relevant window
    window_text: str = ""
    domain: str = ""


def apply_domain_cap(
    results: List[RankedDoc], max_per_domain: int
) -> Tuple[List[RankedDoc], List[RankedDoc]]:
    """Keep at most N docs per domain; input must be sorted desc by score."""
    domain_counts: Dict[str, int] = {}
    kept: List[RankedDoc] = []
    dropped: List[RankedDoc] = []
    for doc in results:
        if domain_counts.get(doc.domain, 0) < max_per_domain:
            kept.append(doc)
            domain_counts[doc.domain] = domain_counts.get(doc.domain, 0) + 1
        else:
            dropped.append(doc)
    return kept, dropped


def hybrid_diversification(
    results: List[RankedDoc],
    relevance_threshold: float = 0.8,
    top_k: int = 100,
) -> List[RankedDoc]:
    """Two-tier domain diversification (reranker_api.py:196-236).

    High tier = docs scoring >= threshold OR sharing a domain with one that
    does; medium tier = the rest.  Each tier is capped at 1 doc/domain; the
    medium tier fills remaining slots.  If still short, dropped docs backfill
    with scores shifted down so the final list is monotone decreasing.
    """
    high_domains = {
        d.domain for d in results if d.similarity_score >= relevance_threshold
    }
    medium_domains = {
        d.domain for d in results if d.similarity_score < relevance_threshold
    } - high_domains

    high_rel = [
        d
        for d in results
        if d.similarity_score >= relevance_threshold or d.domain in high_domains
    ]
    medium_rel = [
        d
        for d in results
        if d.similarity_score < relevance_threshold and d.domain in medium_domains
    ]
    high_rel.sort(key=lambda x: x.similarity_score, reverse=True)
    medium_rel.sort(key=lambda x: x.similarity_score, reverse=True)

    diversified_high, dropped_high = apply_domain_cap(high_rel, max_per_domain=1)
    remaining = top_k - len(diversified_high)
    diversified_medium, dropped_medium = apply_domain_cap(
        medium_rel, max_per_domain=1
    )

    final = sorted(
        diversified_high + diversified_medium[:remaining],
        key=lambda x: x.similarity_score,
        reverse=True,
    )
    rest = sorted(
        dropped_high + dropped_medium,
        key=lambda x: x.similarity_score,
        reverse=True,
    )
    if len(final) < top_k and rest:
        need = top_k - len(final)
        additional = rest[:need]
        eps = 1e-4
        delta = additional[0].similarity_score - final[-1].similarity_score + eps
        additional = [
            dataclasses.replace(
                d, similarity_score=max(0.0, d.similarity_score - delta)
            )
            for d in additional
        ]
        final.extend(additional)

    return sorted(final, key=lambda x: x.similarity_score, reverse=True)[:top_k]


def dedup_by_base_url(results: List[RankedDoc]) -> List[RankedDoc]:
    """Collapse candidates sharing a query-param-stripped URL, keeping the
    best-ranked one (the reference dedups inside the reranker SQL by
    GROUP BY on url-minus-query, reranker_api.py:33-47; input must be
    sorted desc so "best-ranked" is the kept row)."""
    seen = set()
    out: List[RankedDoc] = []
    for doc in results:
        base = doc.url.split("?", 1)[0]
        if base in seen:
            continue
        seen.add(base)
        out.append(doc)
    return out


def factorize(strings) -> "np.ndarray":
    """Map a list of strings to dense int64 codes (equal strings = equal
    codes).  Precomputed once per index so per-query dedup/diversification
    runs on integer arrays instead of string-keyed dataclasses."""
    import numpy as np

    table: Dict[str, int] = {}
    out = np.empty(len(strings), np.int64)
    for i, s in enumerate(strings):
        code = table.get(s)
        if code is None:
            code = len(table)
            table[s] = code
        out[i] = code
    return out


def diversify_positions(scores, domains, top_k, relevance_threshold):
    """Array-native ``hybrid_diversification`` (reranker_api.py:196-236).

    ``scores`` must be sorted descending; ``domains`` are integer codes
    aligned with it.  Returns ``(positions, out_scores)`` — the selected
    row positions in selection order plus their (possibly backfill-shifted)
    scores.  Bit-equivalent to the dataclass pipeline (fuzz-tested in
    tests/test_rerank_fast.py) but ~10x cheaper: the serving host path was
    dominated by constructing ~1000 RankedDoc objects per query only to
    throw 90% away.
    """
    import numpy as np

    n = len(scores)
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.float64)
    is_high = scores >= relevance_threshold
    high_domains = np.unique(domains[is_high])
    high_mask = is_high | np.isin(domains, high_domains)
    hi_pos = np.nonzero(high_mask)[0]
    me_pos = np.nonzero(~high_mask)[0]

    def cap_one_per_domain(pos):
        if pos.size == 0:
            return pos, pos
        keep = np.zeros(pos.size, bool)
        keep[np.unique(domains[pos], return_index=True)[1]] = True
        return pos[keep], pos[~keep]

    hi_keep, hi_drop = cap_one_per_domain(hi_pos)
    me_keep, me_drop = cap_one_per_domain(me_pos)
    remaining = top_k - hi_keep.size
    # list-slice semantics incl. negative `remaining` (reranker_api.py:224)
    final_pos = np.concatenate([hi_keep, me_keep[:remaining]])
    order = np.argsort(-scores[final_pos], kind="stable")
    final_pos = final_pos[order]
    final_scores = scores[final_pos].astype(np.float64)
    if final_pos.size < top_k:
        rest_pos = np.concatenate([hi_drop, me_drop])
        rest_pos = rest_pos[np.argsort(-scores[rest_pos], kind="stable")]
        if rest_pos.size:
            add = rest_pos[: top_k - final_pos.size]
            eps = 1e-4
            delta = float(scores[add[0]]) - float(final_scores[-1]) + eps
            final_pos = np.concatenate([final_pos, add])
            final_scores = np.concatenate(
                [final_scores, np.maximum(0.0, scores[add] - delta)]
            )
    order = np.argsort(-final_scores, kind="stable")[:top_k]
    return final_pos[order], final_scores[order]


def finish_positions(
    scores,
    domains,
    bases,
    top_k,
    relevance_threshold=0.8,
    diversification=True,
):
    """Dedup-by-base-url + diversification over candidate ARRAYS.

    Array twin of ``dedup_by_base_url`` + ``hybrid_diversification`` for the
    engine hot path: ``scores`` sorted desc, ``domains``/``bases`` integer
    codes.  Returns ``(positions, out_scores)`` into the input rows.
    """
    import numpy as np

    keep = np.sort(np.unique(bases, return_index=True)[1])
    if not diversification:
        sel = keep[:top_k]
        return sel, np.asarray(scores, np.float64)[sel]
    pos, out = diversify_positions(
        np.asarray(scores, np.float64)[keep],
        domains[keep],
        top_k,
        relevance_threshold,
    )
    return keep[pos], out


def positional_adjustment(position: int, total_chunks: int) -> float:
    """Additive adjustment for the best chunk (reranker_api.py:299-334).

    +max_boost when the best chunk is the document's first window, linearly
    down to -max_decay when it is the last; 0 for single-chunk documents.
    """
    if total_chunks <= 1:
        return 0.0
    ratio = position / (total_chunks - 1)
    return 0.10 - (0.10 + 0.05) * ratio


def rerank_candidates(
    art,
    encoder,
    query: str,
    doc_ids: List[int],
    similarities: List[float],
    top_k: int = 100,
    smoothing: float = 0.15,
    diversification: bool = True,
    relevance_threshold: float = 0.8,
) -> List[RankedDoc]:
    """Standalone rerank of externally supplied candidates — the reference's
    POST /rerank contract (reranker_api.py:336-412): callers pass stage-1
    doc ids + scores; this runs cosine over their chunks, per-pool min-max,
    0.85/0.15 fusion, positional weighting, per-doc max, diversification.

    Host-side numpy (candidate pools are <= ~1000 docs); the in-engine
    device path fuses the same math — consistency is tested in
    tests/test_rerank_endpoint.py.
    """
    import numpy as np

    ext_to_int = {d: i for i, d in enumerate(art.doc_ids)}
    rows = []  # (internal_doc, ord_in_doc, global_chunk, old_sim)
    for d_ext, old in zip(doc_ids, similarities):
        i = ext_to_int.get(int(d_ext))
        if i is None:
            continue
        start = int(art.doc_chunk_start[i])
        n = int(art.doc_n_chunks[i])
        for o in range(n):
            rows.append((i, o, start + o, float(old)))
    if not rows:
        return []
    q = np.asarray(encoder.encode_batch([query]), np.float32)[0]
    q = q / max(float(np.linalg.norm(q)), 1e-12)
    gids = np.array([r[2] for r in rows])
    emb = np.asarray(art.chunk_emb)[gids]
    norms = np.linalg.norm(emb, axis=1)
    new = emb @ q / np.maximum(norms, 1e-12)
    old = np.array([r[3] for r in rows], np.float32)

    def minmax(v):
        lo, hi = float(v.min()), float(v.max())
        return np.zeros_like(v) if hi == lo else (v - lo) / (hi - lo)

    fused = minmax(new) * (1.0 - smoothing) + minmax(old) * smoothing
    old_n = minmax(old)

    by_doc: dict = {}
    for idx, (i, o, g, _) in enumerate(rows):
        by_doc.setdefault(i, []).append(idx)
    ranked: List[RankedDoc] = []
    for i, idxs in by_doc.items():
        total = len(idxs)
        vals = {j: float(fused[j]) for j in idxs}
        best = max(idxs, key=lambda j: (vals[j], -j))
        if total > 1:
            adj = positional_adjustment(rows[best][1], total)
            vals[best] = min(1.0, max(0.0, vals[best] + adj))
            best = max(idxs, key=lambda j: (vals[j], -j))
        g = rows[best][2]
        ranked.append(
            RankedDoc(
                doc_id=art.doc_ids[i],
                url=art.urls[i],
                title=art.titles[i],
                similarity_score=vals[best],
                original_similarity=float(old_n[best]),
                window_index=g,
                window_text=art.window_texts[g],
                domain=art.domains[i],
            )
        )
    ranked.sort(key=lambda r: -r.similarity_score)
    ranked = dedup_by_base_url(ranked)
    if diversification:
        return hybrid_diversification(
            ranked, relevance_threshold=relevance_threshold, top_k=top_k
        )
    return ranked[:top_k]
