"""IR quality metrics: recall@k, precision@k, NDCG@k, MRR.

The reference publishes no metric code (course-side grading); these are the
standard definitions used to demonstrate quality parity between the TPU
engine and the numpy reference scoring on `queries.txt`-style runs
(BASELINE.md "match reference recall@10 / NDCG@10").

A copy of the reference package's ``eval/metrics.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence


def recall_at_k(ranked: Sequence, relevant: set, k: int) -> float:
    if not relevant:
        return 0.0
    return len(set(ranked[:k]) & relevant) / len(relevant)


def precision_at_k(ranked: Sequence, relevant: set, k: int) -> float:
    if k == 0:
        return 0.0
    return len(set(ranked[:k]) & relevant) / k


def mrr(ranked: Sequence, relevant: set) -> float:
    for i, doc in enumerate(ranked, start=1):
        if doc in relevant:
            return 1.0 / i
    return 0.0


def dcg_at_k(gains: Sequence[float], k: int) -> float:
    return sum(g / math.log2(i + 2) for i, g in enumerate(gains[:k]))


def ndcg_at_k(
    ranked: Sequence, rels: Mapping, k: int
) -> float:
    """rels: doc -> graded relevance (binary or graded)."""
    gains = [float(rels.get(d, 0.0)) for d in ranked]
    ideal = sorted((float(v) for v in rels.values()), reverse=True)
    idcg = dcg_at_k(ideal, k)
    if idcg == 0:
        return 0.0
    return dcg_at_k(gains, k) / idcg


def ranking_overlap_at_k(a: Sequence, b: Sequence, k: int) -> float:
    """Jaccard overlap of two top-k lists (engine-vs-reference parity)."""
    sa, sb = set(a[:k]), set(b[:k])
    if not sa and not sb:
        return 1.0
    return len(sa & sb) / len(sa | sb)


def evaluate_run(
    run: Mapping[int, Sequence],
    qrels: Mapping[int, Mapping],
    k: int = 10,
) -> Dict[str, float]:
    """run: query_num -> ranked doc keys; qrels: query_num -> {doc: rel}."""
    recalls, ndcgs, mrrs = [], [], []
    for qn, ranked in run.items():
        rels = qrels.get(qn, {})
        relevant = {d for d, r in rels.items() if r > 0}
        recalls.append(recall_at_k(ranked, relevant, k))
        ndcgs.append(ndcg_at_k(ranked, rels, k))
        mrrs.append(mrr(ranked, relevant))
    n = max(len(run), 1)
    return {
        f"recall@{k}": sum(recalls) / n,
        f"ndcg@{k}": sum(ndcgs) / n,
        "mrr": sum(mrrs) / n,
    }
