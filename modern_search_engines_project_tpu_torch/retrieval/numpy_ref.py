"""Pure-numpy golden reference of the full hybrid query path.

A faithful, slow reimplementation of the reference's online scoring
(SURVEY.md §3.1): BM25 python-loop scoring (bm25_indexer.py:459-485), chunk
cosine + per-pool min-max normalization + 0.85/0.15 fusion
(reranker_api.py:355-362), per-group positional weighting applied to each
document's best chunk with the per-doc argmax recomputed afterwards
(reranker_api.py:299-334,370-372), and domain diversification.

The device engine's jitted path is validated against this module
(tests/test_engine_parity.py) — this is the "pure-numpy reimplementation of
the reference scoring" the SURVEY test plan calls for (§4d).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional

import numpy as np

from modern_search_engines_project_tpu_torch.index.builder import IndexArtifacts
from modern_search_engines_project_tpu_torch.retrieval.rerank import (
    RankedDoc,
    dedup_by_base_url,
    hybrid_diversification,
    positional_adjustment,
)
from modern_search_engines_project_tpu_torch.text.analyzer import Analyzer, normalize_text


def preprocess_query(query: str) -> str:
    """Parity with search_api.py:155-166: normalize + append the city term."""
    q = normalize_text(query)
    if "tuebingen" not in q:
        q = q + " tuebingen"
    return q


def _minmax(x: np.ndarray) -> np.ndarray:
    """Parity with normalise_similarities (reranker_api.py:289-296)."""
    if x.size == 0:
        return x
    lo, hi = float(x.min()), float(x.max())
    if hi == lo:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def bm25_search_numpy(
    art: IndexArtifacts,
    query: str,
    top_k: int = 1000,
    analyzer: Optional[Analyzer] = None,
    min_score: float = 0.0,
):
    """Reference BM25.search scoring loop (bm25_indexer.py:383-485).

    Returns (internal_doc_idx, scores) sorted desc.  Scores are recomputed
    from the CSR impact postings (impact already folds idf and length
    saturation; multiplied by query term frequency here).
    """
    analyzer = analyzer or Analyzer()
    terms = analyzer.tokens(query)
    qtf = Counter(terms)
    scores: dict = {}
    matched: set = set()
    for term, tf_q in qtf.items():
        tid = art.vocab.get(term)
        if tid < 0:
            continue
        s, e = int(art.indptr[tid]), int(art.indptr[tid + 1])
        for p in range(s, e):
            d = int(art.post_docs[p])
            scores[d] = scores.get(d, 0.0) + float(art.post_impact[p]) * tf_q
            matched.add(d)
    items = [(d, sc) for d, sc in scores.items() if sc >= min_score]
    items.sort(key=lambda x: -x[1])
    items = items[:top_k]
    if not items:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    idx = np.array([d for d, _ in items], dtype=np.int64)
    vals = np.array([s for _, s in items], dtype=np.float32)
    return idx, vals


def hybrid_search_numpy(
    art: IndexArtifacts,
    query: str,
    query_embedding: np.ndarray,
    top_k_retrieval: int = 1000,
    top_k: int = 100,
    smoothing: float = 0.15,
    diversification: bool = True,
    analyzer: Optional[Analyzer] = None,
) -> List[RankedDoc]:
    """Full two-stage pipeline; query must already be preprocessed."""
    cand, bm25_scores = bm25_search_numpy(
        art, query, top_k=top_k_retrieval, analyzer=analyzer
    )
    if cand.size == 0:
        return []

    # chunk rows of candidate docs, in chunk order (reranker SQL join analog)
    chunk_rows = []  # (doc_pos_in_cand, chunk_idx)
    for ci, d in enumerate(cand):
        start = int(art.doc_chunk_start[d])
        n = int(art.doc_n_chunks[d])
        for k in range(n):
            chunk_rows.append((ci, start + k))
    ci_arr = np.array([r[0] for r in chunk_rows])
    ch_arr = np.array([r[1] for r in chunk_rows])

    q = np.asarray(query_embedding, dtype=np.float32)
    q = q / max(np.linalg.norm(q), 1e-12)
    new_sim = art.chunk_emb[ch_arr] @ q  # chunk embeddings are normalized

    new_norm = _minmax(new_sim)  # over all candidate chunks
    old_norm_doc = _minmax(bm25_scores)  # over candidate docs
    fused = new_norm * (1.0 - smoothing) + old_norm_doc[ci_arr] * smoothing

    # positional weighting per doc group + post-adjustment argmax
    results: List[RankedDoc] = []
    for ci, d in enumerate(cand):
        mask = ci_arr == ci
        group = fused[mask].copy()
        chunks = ch_arr[mask]
        n = group.shape[0]
        best = int(np.argmax(group))  # first max, pandas idxmax parity
        adj = positional_adjustment(best, n)
        if n > 1:
            group[best] = min(1.0, max(0.0, group[best] + adj))
        final_best = int(np.argmax(group))
        results.append(
            RankedDoc(
                doc_id=art.doc_ids[int(d)],
                url=art.urls[int(d)],
                title=art.titles[int(d)],
                similarity_score=float(group[final_best]),
                original_similarity=float(old_norm_doc[ci]),
                window_index=int(chunks[final_best]),
                window_text=art.window_texts[int(chunks[final_best])],
                domain=art.domains[int(d)],
            )
        )

    results.sort(key=lambda r: -r.similarity_score)
    results = dedup_by_base_url(results)
    if diversification:
        return hybrid_diversification(results, top_k=top_k)
    return results[:top_k]
